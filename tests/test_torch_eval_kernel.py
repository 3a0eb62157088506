"""The eval CLIs' device path (``cli/encode.py:encode_split``: the
encoder, the TF=1 decode's argmax and the greedy decode from ``z = mu``) on
the fused route against the plain route (``use_pallas=False``) on the same
device. On the CPU the fused route runs its kernels' plain versions; the
cases marked ``cuda`` run the whole-stack encoder, the training decoder's
logits forward and the sampler kernels on the card and skip without one.
This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_eval_kernel.py -q

Held: ``mu`` and ``logvar`` within max |fused - plain| / max |plain| of
1e-4 in f32 and 2e-2 in bf16 (the train kernels' tolerances), the argmax
tokens on >= 99.0%, the greedy rows under the decoder's contract (>= 99.0%
of first tokens, >= 97.0% of rows). The decoder weights are the init scaled
by 3, so the greedy rows differ from row to row.
"""

import numpy as np
import pytest
import torch

from mlx_vae_tpu_torch.cli import encode as tencode
from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.data.prepare import make_synthetic_dataset
from mlx_vae_tpu_torch.data.split import load_and_split
from mlx_vae_tpu_torch.models.vae import ARCVAE
from mlx_vae_tpu_torch.utils.tree import params_from_numpy, params_to_numpy

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the tiny model takes the CUDA-core sampler, the default model the
# tensor-core one
SHAPES = {"tiny": dict(vocab_size=24, embedding_dim=16, hidden_dim=32, latent_dim=8),
          "default": {}}


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    path = tmp_path_factory.mktemp("evalk") / "d.json"
    make_synthetic_dataset(n=300, vocab_size=24, max_length=16, seed=3, path=str(path))
    ds = load_and_split(str(path), property_keys=("tpsa",))[0]
    return ds.molecules, ds.properties_normalized


def _params(shape: str, dev):
    vae = ARCVAE(ModelConfig(**SHAPES[shape]), torch.Generator().manual_seed(0), device="cpu")
    tree = params_to_numpy({k: vae.params[k] for k in ("encoder", "decoder")})
    tree["decoder"] = {k: {n: 3.0 * a for n, a in v.items()} for k, v in tree["decoder"].items()}
    return {k: params_from_numpy(v, dev) for k, v in tree.items()}


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_fused_route_matches_plain_route(split, shape, dtype, device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    tokens, cond = split
    params = _params(shape, dev)
    cfg = ModelConfig(compute_dtype=dtype, use_pallas=True, **SHAPES[shape])
    fused = tencode.encode_split(params, cfg, dev, tokens, cond, 96)
    plain = tencode.encode_split(params, cfg.replace(use_pallas=False), dev, tokens, cond, 96)
    assert fused["mu"].shape == (tokens.shape[0], cfg.latent_dim)
    for k in ("mu", "logvar"):
        err = np.abs(fused[k] - plain[k]).max() / np.abs(plain[k]).max()
        assert err <= TOL[dtype], (k, err)
    assert (fused["next_tokens"] == plain["next_tokens"]).mean() >= 0.99
    a, b = fused["decoded"], plain["decoded"]
    assert (a[:, 0] == b[:, 0]).mean() >= 0.99 and (a == b).all(axis=1).mean() >= 0.97
    assert len({r.tobytes() for r in b}) > 10
