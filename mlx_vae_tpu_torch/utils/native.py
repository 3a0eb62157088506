"""Shared loader for the native C++ runtime components (``native/*.cpp``).

Copied from ``mlx_vae_tpu/utils/native.py``. The sources at the repo root
are only read: each one is compiled with ``g++ -O3`` on first use into a
per-user cache directory of the port's own
(``$XDG_CACHE_HOME/mlx_vae_tpu_torch``), so no prebuilt binary is ever
loaded. Callers fall back to their numpy/Python implementations when no
toolchain is available; ``MLX_VAE_TPU_TORCH_NO_NATIVE=1`` forces the
fallbacks. Only ``_so_path`` (the cache directory) and ``load_native`` (the
environment variable, the message prefix, and a build into a temporary
file renamed into place) differ from the original.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, Optional

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"

# source path -> (loaded lib or None); miss means not yet attempted.
_cache: Dict[str, Optional[ctypes.CDLL]] = {}


def _so_path(src: Path) -> Path:
    cache = Path(os.environ.get("XDG_CACHE_HOME",
                                Path.home() / ".cache")) / "mlx_vae_tpu_torch"
    return cache / f"lib{src.stem}.so"


def load_native(src: Path,
                configure: Callable[[ctypes.CDLL], None]) -> Optional[ctypes.CDLL]:
    """Compile (if stale) and load ``src``; ``configure`` sets argtypes.

    Returns None — permanently for this process — on any failure (no g++,
    read-only cache dir, compile error) or when
    ``MLX_VAE_TPU_TORCH_NO_NATIVE`` is set, so hot paths can branch to their
    Python fallbacks without re-probing per call.
    """
    key = str(src)
    if key in _cache:
        return _cache[key]
    lib: Optional[ctypes.CDLL] = None
    if not os.environ.get("MLX_VAE_TPU_TORCH_NO_NATIVE"):
        try:
            so = _so_path(src)
            if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
                so.parent.mkdir(parents=True, exist_ok=True)
                # build beside, then rename: a concurrent process never
                # loads a half-written library
                tmp = so.with_name(f"{so.name}.tmp.{os.getpid()}")
                try:
                    subprocess.run(
                        ["g++", "-O3", "-shared", "-fPIC", str(src),
                         "-o", str(tmp)],
                        check=True, capture_output=True)
                    os.replace(tmp, so)
                finally:
                    tmp.unlink(missing_ok=True)
            lib = ctypes.CDLL(str(so))
            configure(lib)
        except Exception as e:
            detail = ""
            if isinstance(e, subprocess.CalledProcessError) and e.stderr:
                stderr = e.stderr.decode(errors="replace").strip()
                detail = f"\n  g++ stderr: {stderr[:500]}"
            print(f"mlx_vae_tpu_torch: native component {src.name} unavailable "
                  f"({type(e).__name__}: {e}); using the slower Python "
                  f"fallback for this process.{detail}", file=sys.stderr)
            lib = None
    _cache[key] = lib
    return lib


def ptr(a, ctype):
    """ctypes pointer to a (contiguous) numpy array's buffer."""
    return a.ctypes.data_as(ctypes.POINTER(ctype))
