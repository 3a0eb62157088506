"""The PyTorch port stands alone: it never imports JAX or the JAX package,
and its copies of the JAX package's framework-free host code stay equal to
the originals."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "mlx_vae_tpu"
PORT_PKG = ROOT / "mlx_vae_tpu_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import mlx_vae_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mlx_vae_tpu_torch.__path__,
                                                "mlx_vae_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.")
             or k == "mlx_vae_tpu" or k.startswith("mlx_vae_tpu."))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    """Importing every port module leaves jax and mlx_vae_tpu out of
    sys.modules (the GPU machine has no JAX)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    count = int(res.stdout.split()[0])
    assert count >= 20, res.stdout  # every subpackage was walked


def _sub(text: str) -> str:
    """The copy transform: module paths point at the port, and citations of
    the MLX reference checkout drop its absolute location."""
    text = re.sub(r"(?<![\w.])/[a-z]+/reference/", "reference/", text)
    return text.replace("mlx_vae_tpu.", "mlx_vae_tpu_torch.")


WHOLE = ["chem/__init__.py", "chem/mol.py", "chem/smiles.py",
         "chem/selfies_codec.py", "chem/descriptors.py", "chem/corpus.py",
         "chem/shim.py", "data/prepare.py", "data/metrics.py", "data/packer.py",
         "data/dataset.py", "data/split.py", "train/history.py"]
# Partial copies: every top-level statement of the port file (bar its own
# docstring, its import lines and the listed statements of its own: stand-ins
# for not-yet-ported native code, or the loader's cache directory and
# environment variable) is a statement of the original, module paths
# rewritten. A whole copy passes this test too.
PARTIAL = {"data/prepare.py": set(), "data/metrics.py": set(),
           "data/postproc.py": {"validity_count", "canonicalize", "unique_count",
                                "novel_counts"},
           "utils/native.py": {"_so_path", "load_native"}}


@pytest.mark.parametrize("rel", WHOLE)
def test_whole_copy_equals_original(rel):
    assert (PORT_PKG / rel).read_text() == _sub((JAX_PKG / rel).read_text())


def _statements(text: str):
    tree = ast.parse(text)
    body = tree.body
    if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
        body = body[1:]  # the module docstring
    return [(getattr(n, "name", None), ast.get_source_segment(text, n)) for n in body
            if not isinstance(n, (ast.Import, ast.ImportFrom))]  # import lines may differ


@pytest.mark.parametrize("rel", sorted(PARTIAL))
def test_partial_copy_statements_equal_original(rel):
    original = {seg for _, seg in _statements(_sub((JAX_PKG / rel).read_text()))}
    port = _statements((PORT_PKG / rel).read_text())
    copied = [(name, seg) for name, seg in port if name not in PARTIAL[rel]]
    assert copied
    for name, seg in copied:
        assert seg in original, f"{rel}: {name or seg[:60]!r} differs from the original"
    stubs = {name for name, _ in port} & PARTIAL[rel]
    assert stubs == PARTIAL[rel]
