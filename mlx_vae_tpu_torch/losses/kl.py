"""KL divergence with a free-bits floor (counterpart of
``mlx_vae_tpu/losses/kl.py``): mu clipped to [-3, 3] and logvar to [-6, 3],
per-dim ``-0.5 (1 + logvar - mu^2 - var)`` floored at 0 and at
``free_bits / latent_dim``, summed over dims."""

from __future__ import annotations

import torch


def kl_divergence(mu: torch.Tensor, logvar: torch.Tensor, reduction: str = "mean",
                  free_bits: float = 0.0) -> torch.Tensor:
    latent_dim = mu.shape[-1]
    mu = mu.float().clamp(-3.0, 3.0)
    logvar = logvar.float().clamp(-6.0, 3.0)
    kl_per_dim = (-0.5 * (1.0 + logvar - mu.square() - logvar.exp())).clamp_min(0.0)
    if free_bits > 0.0:
        kl_per_dim = kl_per_dim.clamp_min(free_bits / latent_dim)
    kl_per_sample = kl_per_dim.sum(dim=-1)
    if reduction == "mean":
        return kl_per_sample.mean()
    if reduction == "sum":
        return kl_per_sample.sum()
    return kl_per_sample
