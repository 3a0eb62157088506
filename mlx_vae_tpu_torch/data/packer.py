"""ctypes bridge to the native C++ sequence packer (``native/packer.cpp``).

Compiled from source on first use via the shared loader
(``utils/native.py`` — per-user cache, never a shipped binary, ADVICE r1).
Falls back to a vectorized numpy implementation when no toolchain is
available. Both paths are exercised by ``tests/test_data.py``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from mlx_vae_tpu_torch.utils.native import NATIVE_DIR, load_native
from mlx_vae_tpu_torch.utils.native import ptr as _ptr

_SRC = NATIVE_DIR / "packer.cpp"


def _configure(lib: ctypes.CDLL) -> None:
    lib.pack_sequences.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.gather_rows.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]


def _get_lib() -> Optional[ctypes.CDLL]:
    return load_native(_SRC, _configure)


def pack_sequences_numpy(sequences: list, max_length: int, pad_token: int) -> np.ndarray:
    out = np.full((len(sequences), max_length), pad_token, dtype=np.int32)
    for i, seq in enumerate(sequences):
        n = min(len(seq), max_length)
        out[i, :n] = seq[:n]
    return out


def pack_sequences(sequences: list, max_length: int, pad_token: int) -> np.ndarray:
    """Ragged list of token lists -> ``[N, max_length] int32`` padded matrix."""
    lib = _get_lib()
    if lib is None or len(sequences) == 0:
        return pack_sequences_numpy(sequences, max_length, pad_token)
    lengths = np.fromiter((len(s) for s in sequences), dtype=np.int64, count=len(sequences))
    offsets = np.zeros(len(sequences) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    flat = np.empty(int(offsets[-1]), dtype=np.int32)
    pos = 0
    for s in sequences:  # concatenation itself is memcpy-bound
        flat[pos : pos + len(s)] = s
        pos += len(s)
    out = np.empty((len(sequences), max_length), dtype=np.int32)
    lib.pack_sequences(
        _ptr(flat, ctypes.c_int32), _ptr(offsets, ctypes.c_int64),
        len(sequences), max_length, pad_token,
        _ptr(out, ctypes.c_int32),
    )
    return out


def gather_rows(data: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Contiguous row-gather ``data[indices]`` via the native library."""
    lib = _get_lib()
    if lib is None or data.dtype != np.int32 or not data.flags.c_contiguous:
        return np.ascontiguousarray(data[indices])
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    out = np.empty((len(idx), data.shape[1]), dtype=np.int32)
    lib.gather_rows(
        _ptr(data, ctypes.c_int32), _ptr(idx, ctypes.c_int64),
        len(idx), data.shape[1], _ptr(out, ctypes.c_int32),
    )
    return out
