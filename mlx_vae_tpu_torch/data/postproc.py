"""Token-matrix coercion for the host metrics.

``as_token_matrix`` is copied from ``mlx_vae_tpu/data/postproc.py``. The
native post-processor (``native/postproc.cpp`` through ctypes) is not ported
yet: the three entry points the copied metrics call return None, which is
the documented "library unavailable" answer, so every caller takes its numpy
path (``tests/test_postproc.py`` holds both paths equal in the JAX package).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def as_token_matrix(tokens) -> Optional[np.ndarray]:
    """Coerce to a contiguous ``[n, L] int32`` matrix, or None if the input
    is ragged / not 2-D (callers then use their per-row Python path)."""
    try:
        a = np.asarray(tokens)
    except Exception:
        return None
    if a.ndim != 2 or a.dtype == object or a.size == 0:
        return None
    return np.ascontiguousarray(a, dtype=np.int32)


def validity_count(tokens: np.ndarray, eos: int) -> Optional[int]:
    """Native structural-validity count: not ported, so always None."""
    return None


def canonicalize(tokens: np.ndarray, eos: int,
                 num_specials: int) -> Optional[np.ndarray]:
    """Native canonicalization: not ported, so always None."""
    return None


def unique_count(canon: np.ndarray) -> Optional[int]:
    """Native distinct-row count: not ported, so always None."""
    return None
