"""The port's three console diagnostics (``mlx_vae_tpu_torch/diagnostics/``)
against the JAX package's scripts (``diagnostics/``): each exits 0 on the
CPU when asked for it, refuses a CUDA device that is not there, and
``data_diagnostic`` prints the JAX script's split, shape and normalization
lines on the same synthetic corpus (the JAX script run in a subprocess)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mlx_vae_tpu.data.prepare import make_synthetic_dataset
from mlx_vae_tpu_torch.diagnostics import check_decoder_grads, data_diagnostic, loss_signs

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = {"check_decoder_grads": check_decoder_grads, "data_diagnostic": data_diagnostic,
           "loss_signs": loss_signs}
# the lines of data_diagnostic that depend on the corpus and split alone
DATA_LINES = ("split sizes:", "max_length=", "train norm stats:", "val normalized props:")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_exits_zero_on_cpu(name, capsys):
    assert SCRIPTS[name].main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "❌" not in out and "⚠️" not in out
    last = {"check_decoder_grads": "Decoder gradients flow ✅",
            "data_diagnostic": "✅ train/val consistent at init",
            "loss_signs": "All checks passed ✅"}[name]
    assert out.strip().splitlines()[-1] == last


def test_check_decoder_grads_moves_every_step(capsys):
    """As the JAX script: one line a step (the 240-row train split gives 8
    batches of 32), each with a weight delta over 1e-6."""
    check_decoder_grads.main(["--device", "cpu"])
    steps = [l for l in capsys.readouterr().out.splitlines() if l.startswith("step ")]
    assert len(steps) == 8 and all(l.endswith("✅") for l in steps)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_cuda_without_cuda_exits_with_the_device_error(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available; pass --device cpu"):
        SCRIPTS[name].main(["--device", "cuda"])


@pytest.mark.parametrize("n", [500, 731])
def test_data_diagnostic_lines_equal_jax(n, tmp_path, capsys):
    path = tmp_path / "syn.json"
    make_synthetic_dataset(n=n, vocab_size=40, max_length=24, path=str(path))
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, str(ROOT / "diagnostics" / "data_diagnostic.py"),
                          "--data", str(path)], capture_output=True, text=True, env=env,
                         timeout=600)
    assert res.returncode == 0, res.stderr
    assert data_diagnostic.main(["--data", str(path), "--device", "cpu"]) == 0

    def lines(text):
        return [l for l in text.splitlines() if l.startswith(DATA_LINES)]

    want = lines(res.stdout)
    assert len(want) == len(DATA_LINES)
    assert lines(capsys.readouterr().out) == want
