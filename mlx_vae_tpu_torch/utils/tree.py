"""Parameter-tree helpers: nested dicts of numpy arrays <-> torch tensors.

Counterpart of ``mlx_vae_tpu/utils/tree.py:tree_to_numpy/tree_from_numpy``
(JAX-only there). Trees keep the ``.npz`` contract's nested MLX key names,
so a numpy tree moves between the two packages unchanged — this is the
weight carry-over the parity tests use.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device="cpu", dtype=None):
    """Nested dict of numpy arrays -> the same dict of tensors on ``device``.

    ``dtype`` (optional) casts floating leaves; integer leaves keep theirs.
    """
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    t = torch.tensor(np.asarray(tree), device=device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def params_to_numpy(tree):
    """Nested dict of tensors (or numpy arrays) -> nested dict of numpy
    arrays on the host. bf16 leaves come back as float32 (numpy has no
    bfloat16)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(tree)
