"""Mutual information estimate and posterior-collapse penalty (counterpart
of ``mlx_vae_tpu/losses/info.py``).

``MI = E_x[KL(q(z|x) || p(z))] - KL(moment-matched aggregate q(z) || p(z))``,
floored at 0. The loss takes ``log(mean_var)`` with no epsilon; the monitor
adds ``eps = 1e-8``: both variants are kept through ``eps``.
"""

from __future__ import annotations

import torch


def mutual_information(mu: torch.Tensor, logvar: torch.Tensor,
                       eps: float = 0.0) -> torch.Tensor:
    mu = mu.float().clamp(-3.0, 3.0)
    logvar = logvar.float().clamp(-6.0, 3.0)
    var = logvar.exp()
    kl_per_sample = -0.5 * torch.sum(1.0 + logvar - mu.square() - var, dim=1)
    mean_kl = kl_per_sample.mean()
    mean_mu = mu.mean(dim=0)
    mean_var = var.mean(dim=0)
    mean_logvar = torch.log(mean_var + eps) if eps else torch.log(mean_var)
    agg_kl = -0.5 * torch.sum(1.0 + mean_logvar - mean_mu.square() - mean_var)
    return (mean_kl - agg_kl).clamp_min(0.0)


def posterior_collapse(mu: torch.Tensor, logvar: torch.Tensor,
                       target_mi: float = 4.85, weight: float = 0.1) -> torch.Tensor:
    """``weight * max(0, target_mi - MI)``."""
    return weight * (target_mi - mutual_information(mu, logvar)).clamp_min(0.0)
