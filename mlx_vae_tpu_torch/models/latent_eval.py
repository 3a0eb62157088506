"""Latent-space and reconstruction evaluation helpers (counterpart of
``mlx_vae_tpu/models/latent_eval.py``; the ``encode`` and ``interpolate``
CLIs use them).

* per-dimension KL to the prior, **active units** (Burda et al. 2016: dims
  whose ``Var_x(mu_d)`` exceeds a threshold, default 0.01) and the
  reference's monitor-variant MI estimator over a whole encoded split
  (:func:`latent_statistics`);
* reconstruction token accuracy and exact-molecule match of a decode
  against the source sequences (:func:`reconstruction_metrics`);
* the slerp / lerp path between two latents (:func:`latent_path`).

All host-side numpy on device-computed (mu, logvar, tokens).
``reconstruction_metrics`` and ``latent_path`` are the original's
statements; ``latent_statistics`` differs only in handing the port's
tensor ``mutual_information`` float32 tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from mlx_vae_tpu_torch.data.metrics import canonical_tokens
from mlx_vae_tpu_torch.losses.info import mutual_information


def latent_statistics(mu, logvar, au_threshold: float = 0.01) -> dict:
    """Health metrics of an encoded split. ``mu``/``logvar``: ``[N, D]``."""
    mu = np.asarray(mu, np.float64)
    logvar = np.asarray(logvar, np.float64)
    var = np.exp(logvar)
    # Unclipped per-dim KL (diagnostic view; the loss path clips defensively,
    # losses/kl.py — an eval wants to SEE out-of-bound dims, not hide them).
    kl_per_dim = (-0.5 * (1.0 + logvar - np.square(mu) - var)).mean(axis=0)
    mu_variance = mu.var(axis=0)
    active = mu_variance > au_threshold
    return {
        "kl_per_dim": kl_per_dim,
        "kl_total": float(kl_per_dim.sum()),
        "mu_variance_per_dim": mu_variance,
        "active_units": int(active.sum()),
        "active_fraction": float(active.mean()),
        "au_threshold": au_threshold,
        # The reference trainer's monitoring MI (eps variant,
        # reference/trainer.py:568) over the WHOLE split at once.
        "mutual_information": float(
            mutual_information(torch.from_numpy(np.asarray(mu, np.float32)),
                               torch.from_numpy(np.asarray(logvar, np.float32)),
                               eps=1e-8)),
    }


def reconstruction_metrics(decoded_tokens, target_tokens,
                           pad_token: int = 0) -> dict:
    """Greedy-reconstruction fidelity against the source sequences.

    * ``token_accuracy``: positionwise match over target positions that are
      not pad (pad tail excluded — unlike the training CE, which deliberately
      keeps the reference's unmasked semantics, an eval should not reward
      padding).
    * ``exact_match``: fraction of rows whose canonical molecule (tokens
      before first EOS, specials stripped — ``data/metrics.py``) is identical.
    """
    gen = np.asarray(decoded_tokens)
    tgt = np.asarray(target_tokens)
    if gen.shape != tgt.shape:
        raise ValueError(f"shape mismatch: decoded {gen.shape} vs "
                         f"target {tgt.shape}")
    mask = tgt != pad_token
    token_acc = float((gen == tgt)[mask].sum() / max(1, mask.sum()))
    exact = float(
        (canonical_tokens(gen) == canonical_tokens(tgt)).all(axis=1).mean())
    return {"token_accuracy": token_acc, "exact_match": exact}


def latent_path(za, zb, steps: int, mode: str = "slerp") -> np.ndarray:
    """``[steps, D]`` interpolation path from ``za`` to ``zb`` (inclusive).

    ``slerp`` (White 2016, "Sampling Generative Networks"): interpolate the
    angle and the norm separately, so intermediate points keep a
    prior-typical radius — a straight line between two N(0, I) samples cuts
    through the low-density center, where the decoder was never trained.
    Falls back to lerp when the endpoints are (anti)parallel or one is ~0,
    where the angular parameterization is degenerate.
    """
    za = np.asarray(za, np.float64).reshape(-1)
    zb = np.asarray(zb, np.float64).reshape(-1)
    if za.shape != zb.shape:
        raise ValueError(f"endpoint shape mismatch: {za.shape} vs {zb.shape}")
    if steps < 2:
        raise ValueError(f"steps must be >= 2 (endpoints inclusive), got {steps}")
    t = np.linspace(0.0, 1.0, steps)[:, None]
    na, nb = np.linalg.norm(za), np.linalg.norm(zb)
    if mode == "lerp":
        return ((1 - t) * za + t * zb).astype(np.float32)
    if mode != "slerp":
        raise ValueError(f"unknown interpolation mode {mode!r}")
    if na < 1e-8 or nb < 1e-8:
        return ((1 - t) * za + t * zb).astype(np.float32)
    cos = np.clip(np.dot(za, zb) / (na * nb), -1.0, 1.0)
    omega = np.arccos(cos)
    if np.sin(omega) < 1e-6:  # (anti)parallel -> angular param degenerate
        return ((1 - t) * za + t * zb).astype(np.float32)
    dirs = (np.sin((1 - t) * omega) * (za / na)
            + np.sin(t * omega) * (zb / nb)) / np.sin(omega)
    radius = (1 - t) * na + t * nb
    return (radius * dirs).astype(np.float32)
