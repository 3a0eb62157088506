"""ctypes bridge to the native generation post-processor
(``native/postproc.cpp``), copied from ``mlx_vae_tpu/data/postproc.py``.

Every statement but this docstring is the original's, with module paths
pointing at the port. The repo-root C++ source is only read: the port's
loader (``utils/native.py``) builds it with ``g++`` into the port's own
cache directory on first use. Every function returns ``None`` when the
native library is unavailable (no toolchain, or
``MLX_VAE_TPU_TORCH_NO_NATIVE=1``); callers (``data/metrics.py``'s
``uniqueness`` and ``novelty``, ``data/prepare.py``'s ``selfies_validity``)
then take their numpy/Python paths, which give the same numbers
(``tests/test_torch_postproc.py``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from mlx_vae_tpu_torch.utils.native import NATIVE_DIR, load_native, ptr

_SRC = NATIVE_DIR / "postproc.cpp"
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)


def _configure(lib: ctypes.CDLL) -> None:
    lib.validity_proxy.argtypes = [_i32p, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int32]
    lib.validity_proxy.restype = ctypes.c_int64
    lib.canonicalize_rows.argtypes = [_i32p, ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int32, ctypes.c_int32, _i32p]
    lib.count_unique.argtypes = [_i32p, ctypes.c_int64, ctypes.c_int64]
    lib.count_unique.restype = ctypes.c_int64
    lib.count_novel.argtypes = [_i32p, ctypes.c_int64, _i32p, ctypes.c_int64,
                                ctypes.c_int64, _i64p, _i64p]


def _lib() -> Optional[ctypes.CDLL]:
    return load_native(_SRC, _configure)


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
    """Rows passing the structural validity proxy (see ``prepare.py``)."""
    lib = _lib()
    if lib is None:
        return None
    n, L = tokens.shape
    return int(lib.validity_proxy(ptr(tokens, ctypes.c_int32), n, L, eos))


def canonicalize(tokens: np.ndarray, eos: int,
                 num_specials: int) -> Optional[np.ndarray]:
    """Native ``metrics.canonical_tokens`` (same -1-filled contract)."""
    lib = _lib()
    if lib is None:
        return None
    n, L = tokens.shape
    out = np.empty((n, L), np.int32)
    lib.canonicalize_rows(ptr(tokens, ctypes.c_int32), n, L, eos,
                          num_specials, ptr(out, ctypes.c_int32))
    return out


def unique_count(canon: np.ndarray) -> Optional[int]:
    """Distinct rows of a canonical matrix (exact, memcmp-confirmed)."""
    lib = _lib()
    if lib is None:
        return None
    n, L = canon.shape
    return int(lib.count_unique(ptr(canon, ctypes.c_int32), n, L))


def novel_counts(gen_canon: np.ndarray,
                 ref_canon: np.ndarray) -> Optional[Tuple[int, int]]:
    """``(distinct_gen, distinct_gen_absent_from_ref)`` for two canonical
    matrices of equal width."""
    lib = _lib()
    if lib is None:
        return None
    assert gen_canon.shape[1] == ref_canon.shape[1]
    distinct = ctypes.c_int64()
    novel = ctypes.c_int64()
    lib.count_novel(ptr(gen_canon, ctypes.c_int32), gen_canon.shape[0],
                    ptr(ref_canon, ctypes.c_int32), ref_canon.shape[0],
                    gen_canon.shape[1], ctypes.byref(distinct),
                    ctypes.byref(novel))
    return int(distinct.value), int(novel.value)
