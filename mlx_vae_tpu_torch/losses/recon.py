"""Token cross-entropy reconstruction loss (counterpart of
``mlx_vae_tpu/losses/recon.py``): stable log-softmax, gather of the target
log-probs, ``-log p`` reduced by mean or sum. No pad masking: pad positions
count, as in the reference."""

from __future__ import annotations

import torch


def reconstruction_loss(logits: torch.Tensor, targets: torch.Tensor,
                        reduction: str = "mean") -> torch.Tensor:
    """``logits [B, L, V]``, ``targets [B, L] int`` -> scalar (or ``[B*L]``)."""
    V = logits.shape[-1]
    log_softmax = torch.log_softmax(logits.reshape(-1, V).float(), dim=-1)
    ce = -log_softmax.gather(1, targets.reshape(-1, 1).long())[:, 0]
    if reduction == "mean":
        return ce.mean()
    if reduction == "sum":
        return ce.sum()
    return ce
