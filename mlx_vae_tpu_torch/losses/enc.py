"""Stage-wise encoder-only loss (counterpart of ``mlx_vae_tpu/losses/enc.py``)."""

from __future__ import annotations

from mlx_vae_tpu_torch.losses.kl import kl_divergence
from mlx_vae_tpu_torch.models.encoder import encoder_apply, reparameterize


def encoder_loss(params, cfg, x, conditions, eps, beta: float = 1.0,
                 free_bits: float = 0.0):
    """Returns ``(weighted_kl, mu, logvar, z)``; ``eps`` is the
    reparameterization noise."""
    mu, logvar = encoder_apply(params, cfg, x, conditions)
    z = reparameterize(eps, mu, logvar)
    kl = kl_divergence(mu, logvar, reduction="mean", free_bits=free_bits)
    return beta * kl, mu, logvar, z
