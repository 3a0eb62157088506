"""Build the port's CUDA sources into shared libraries and load them.

Every ``csrc/<name>.cu`` becomes its own ``build/lib<name>_<digest>.so``,
compiled by ``nvcc`` for ``sm_90a`` with a plain C interface and loaded
through ctypes. ``<digest>`` hashes the source and every header in
``csrc/``, so an edit rebuilds and an unchanged tree reuses what it built.
A failed ``nvcc`` raises ``RuntimeError`` with the compiler's output.

:func:`compile_sources` starts one ``nvcc`` per source at once and waits for
all of them (``chip_smoke.py`` builds every kernel that way);
:func:`load_library` compiles what is missing and loads it once per process.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): cannot "
                           "build the CUDA kernels in csrc/")
    return path


def _so_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD / f"lib{name}_{h.hexdigest()[:12]}.so"


def compile_sources(names: Iterable[str], verbose: bool = False) -> Dict[str, Path]:
    """Compile ``csrc/<name>.cu`` for each name not built yet, all ``nvcc``
    processes at once. Returns ``{name: path of the .so}``; raises
    ``RuntimeError`` naming every source that failed."""
    names = list(names)
    out = {name: _so_path(name) for name in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = []
    for name in todo:
        tmp = out[name].with_name(f"{out[name].name}.tmp.{os.getpid()}")
        cmd = [exe, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, tmp, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}.cu: nvcc exit {proc.returncode}\n{err}")
            continue
        if verbose:
            print(f"--- nvcc {name}.cu\n{err}", flush=True)
        os.replace(tmp, out[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load_library(name: str, verbose: bool = False) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu`` library, compiled first if needed."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(compile_sources([name], verbose)[name]))
        return _libs[name]


def is_loaded(name: str) -> bool:
    """Whether ``csrc/<name>.cu``'s library is loaded in this process (a
    first call then builds and loads nothing)."""
    return name in _libs
