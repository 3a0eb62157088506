"""Numerical-sanity utilities (counterpart of ``mlx_vae_tpu/losses/stable.py``):
a host-side sanity check over loss scalars and latent bounds, and a KL with
parameterized clips."""

from __future__ import annotations

import math


def check_loss_sanity(total_loss, recon_loss, kl_loss, mu, logvar,
                      max_loss: float = 1000.0,
                      max_kl_per_dim: float = 10.0) -> bool:
    """Host-side check (reads the values back from the device)."""
    total_val, recon_val, kl_val = (float(v) for v in (total_loss, recon_loss, kl_loss))
    if not (math.isfinite(total_val) and math.isfinite(recon_val) and math.isfinite(kl_val)):
        return False
    if total_val > max_loss or total_val < -100:
        return False
    if recon_val < 0 or recon_val > max_loss * 0.9:
        return False
    if kl_val < 0 or kl_val > max_kl_per_dim * mu.shape[1]:
        return False
    if float(mu.abs().max()) > 5.0:
        return False
    if float(logvar.max()) > 3.0 or float(logvar.min()) < -6.0:
        return False
    return True


def kl_divergence_stable(mu, logvar, reduction: str = "mean",
                         free_bits: float = 0.0, mu_clip: float = 3.0,
                         logvar_clip_min: float = -6.0,
                         logvar_clip_max: float = 3.0):
    """KL with parameterized clips."""
    latent_dim = mu.shape[-1]
    mu = mu.float().clamp(-mu_clip, mu_clip)
    logvar = logvar.float().clamp(logvar_clip_min, logvar_clip_max)
    kl_per_dim = (-0.5 * (1.0 + logvar - mu.square() - logvar.exp())).clamp_min(0.0)
    if free_bits > 0.0:
        kl_per_dim = kl_per_dim.clamp_min(free_bits / latent_dim)
    kl_per_sample = kl_per_dim.sum(dim=-1)
    if reduction == "mean":
        return kl_per_sample.mean()
    if reduction == "sum":
        return kl_per_sample.sum()
    return kl_per_sample
