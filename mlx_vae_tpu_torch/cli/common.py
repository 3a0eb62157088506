"""Shared CLI plumbing (counterpart of ``mlx_vae_tpu/cli/common.py``).

Property-stat resolution order (as in training: the model only ever saw
z-scored conditions, so raw user targets are normalized by the TRAIN-set
stats): ``--no_normalize`` wins unconditionally (targets pass through as
already-normalized model units), else an explicit ``--data`` JSON (loaded
and split by ``data/split.py``), else the stats embedded in the
checkpoint, else a hard error.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def resolve_device(name: str) -> torch.device:
    """``--device`` -> torch.device. A CUDA device without CUDA is an
    error, never a silent move to the CPU: the CPU runs only when asked."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"ERROR: --device {name} but CUDA is not available; "
                         "pass --device cpu to run the plain PyTorch versions "
                         "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise SystemExit(f"ERROR: --device {name}: expected cuda[:N] or cpu")
    return dev


def add_cache_flags(parser) -> None:
    """The JAX CLIs' compilation-cache flags, accepted and ignored: the
    port compiles no programs at run time, so there is nothing to cache
    (its kernels are built once per checkout, ``ops/build.py``)."""
    parser.add_argument("--compilation_cache", type=str, default=None, metavar="DIR",
                        help="Accepted for compatibility with the JAX CLIs; no effect")
    parser.add_argument("--no_compilation_cache", action="store_true",
                        help="Accepted for compatibility with the JAX CLIs; no effect")


def resolve_property_stats(data_path, no_normalize: bool, ckpt: dict,
                           num_conditions: int):
    """Return ``(mean [1,C], std [1,C], alphabet or None, train_ds or None)``.

    ``train_ds`` is the training split when ``--data`` was given (callers
    reuse its token matrix for novelty), else None.
    """
    mean = std = None
    train_ds = None
    stats = ckpt.get("data_stats") or {}
    alphabet = stats.get("alphabet")
    if data_path:
        # Load even under --no_normalize: callers still want the alphabet
        # and the train split for novelty.
        if not Path(data_path).exists():
            raise FileNotFoundError(f"--data {data_path} does not exist")
        from mlx_vae_tpu_torch.data.split import load_and_split
        train_ds, _, _, data = load_and_split(
            data_path,
            property_keys=tuple(["tpsa", "logp", "mw"][:num_conditions]))
        mean, std = train_ds.properties_mean, train_ds.properties_std
        alphabet = data.get("alphabet") or alphabet
    elif stats.get("properties_mean") is not None and not no_normalize:
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
            "checkpoint predates stats embedding and --data was not "
            "given. Raw --target values would silently mis-condition "
            "generation. Pass --data <train json>, or --no_normalize "
            "to send targets to the model unscaled.")
    return mean, std, alphabet, train_ds


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
