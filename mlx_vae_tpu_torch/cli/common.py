"""Shared CLI plumbing (counterpart of ``mlx_vae_tpu/cli/common.py``).

Property-stat resolution: ``--no_normalize`` wins unconditionally (targets
pass through as already-normalized model units), else the stats embedded
in the checkpoint, else a hard error. The ``--data`` branch needs the
dataset loader (``data/split.py``, ``data/dataset.py``), which is not
ported yet; it exits with a message saying so.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(name: str) -> torch.device:
    """``--device`` -> torch.device. A CUDA device without CUDA is an
    error, never a silent move to the CPU: the CPU runs only when asked."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"ERROR: --device {name} but CUDA is not available; "
                         "pass --device cpu to run the plain PyTorch sampler "
                         "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise SystemExit(f"ERROR: --device {name}: expected cuda[:N] or cpu")
    return dev


def resolve_property_stats(data_path, no_normalize: bool, ckpt: dict,
                           num_conditions: int):
    """Return ``(mean [1,C], std [1,C], alphabet or None, train_ds)``;
    ``train_ds`` is always None until the dataset loader is ported."""
    if data_path:
        raise SystemExit(
            "ERROR: --data is not yet ported to mlx_vae_tpu_torch (it needs "
            "data/split.py and data/dataset.py); use the stats embedded in "
            "the checkpoint, or --no_normalize")
    mean = std = None
    stats = ckpt.get("data_stats") or {}
    alphabet = stats.get("alphabet")
    if stats.get("properties_mean") is not None and not no_normalize:
        mean = np.asarray(stats["properties_mean"], np.float32).reshape(1, -1)
        std = np.asarray(stats["properties_std"], np.float32).reshape(1, -1)
        print(f"Using property stats from checkpoint: mean={mean.flatten()} "
              f"std={std.flatten()}")

    if no_normalize:
        print("WARNING: --no_normalize set; feeding --target values to the "
              "model without z-scoring.")
        mean = np.zeros((1, num_conditions), np.float32)
        std = np.ones((1, num_conditions), np.float32)
    elif mean is None:
        raise SystemExit(
            "ERROR: no property normalization stats available — the "
            "checkpoint predates stats embedding. Raw --target values would "
            "silently mis-condition generation. Pass --no_normalize to send "
            "targets to the model unscaled.")
    return mean, std, alphabet, None


def normalized_targets(raw_targets, mean, std, num_conditions: int):
    """Validate count and z-score the raw CLI targets to ``[1, C]``."""
    if len(raw_targets) != num_conditions:
        raise SystemExit(
            f"ERROR: --target has {len(raw_targets)} value(s) but the "
            f"checkpoint was trained with num_conditions="
            f"{num_conditions} — pass exactly one target per "
            f"condition (training order, e.g. tpsa,logp,mw) so each "
            f"property is conditioned on its own value.")
    return (np.asarray(raw_targets, np.float32)[None, :] - mean) / std
