"""Port decoder pieces vs the JAX package on the same numpy params and inputs.

Tolerances: float32 atol = rtol = 1e-5 (the two frameworks sum matmuls in
different orders); bfloat16 compute dtype 2e-2 (operands rounded to 8-bit
mantissas, where one ulp of a rounding difference is ~4e-3 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_vae_tpu.config import ModelConfig as JaxConfig
from mlx_vae_tpu.models import decoder as jdec
from mlx_vae_tpu.models import layers as jlayers
from mlx_vae_tpu.ops import lstm as jlstm
from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.models import decoder as tdec
from mlx_vae_tpu_torch.models import layers as tlayers
from mlx_vae_tpu_torch.ops import lstm as tlstm
from mlx_vae_tpu_torch.utils.tree import params_from_numpy, params_to_numpy

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = sorted(TOL)


def _cfgs(n, dtype, H=64):
    kw = dict(vocab_size=24, embedding_dim=16, hidden_dim=H, latent_dim=8,
              num_conditions=2, num_layers=n, compute_dtype=dtype)
    return JaxConfig(**kw), ModelConfig(**kw)


def _params(jcfg, seed=0):
    jp = jdec.init_decoder_params(jax.random.PRNGKey(seed), jcfg)
    npp = jax.tree_util.tree_map(np.asarray, jp)
    return jp, npp, params_from_numpy(npp)


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_config_fields_and_defaults_match():
    import dataclasses
    jf = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    assert jf == tf
    assert ModelConfig().dtype == torch.float32
    assert ModelConfig(compute_dtype="bfloat16").dtype == torch.bfloat16
    assert (ModelConfig.start_token, ModelConfig.pad_token, ModelConfig.end_token) == (0, 0, 2)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_init_tree_matches_jax_layout(n):
    jcfg, tcfg = _cfgs(n, "float32")
    _, npp, _ = _params(jcfg)
    mine = params_to_numpy(tdec.init_decoder_params(torch.Generator().manual_seed(0), tcfg))
    shapes = jax.tree_util.tree_map(np.shape, npp)
    assert jax.tree_util.tree_map(np.shape, mine) == shapes
    # MLX inits: uniform(+-1/sqrt(fan)) and N(0,1)/sqrt(E)
    bound = 1 / np.sqrt(tcfg.hidden_dim)
    assert np.abs(mine["lstm_layer_0"]["Wx"]).max() <= bound
    assert abs(mine["embedding"]["weight"].std() - tcfg.embedding_dim ** -0.5) < 0.05


def test_params_roundtrip_numpy():
    jcfg, _ = _cfgs(2, "float32")
    _, npp, tp = _params(jcfg)
    back = params_to_numpy(tp)
    for a, b in zip(jax.tree_util.tree_leaves(npp), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    bf = params_from_numpy(npp, dtype=torch.bfloat16)
    assert bf["fc_out"]["weight"].dtype == torch.bfloat16
    assert params_to_numpy(bf)["fc_out"]["weight"].dtype == np.float32


@pytest.mark.parametrize("dtype", DTYPES)
def test_linear_and_embedding(dtype):
    rng = np.random.default_rng(0)
    jcfg, tcfg = _cfgs(1, dtype)
    jp, _, tp = _params(jcfg)
    x = rng.standard_normal((16, jcfg.hidden_dim)).astype(np.float32)
    _close(tlayers.linear(tp["fc_out"], torch.from_numpy(x), tcfg.dtype),
           jlayers.linear(jp["fc_out"], jnp.asarray(x), jcfg.dtype), dtype)
    ids = rng.integers(0, jcfg.vocab_size, 16).astype(np.int32)
    want = jlayers.embedding(jp["embedding"], jnp.asarray(ids), jcfg.dtype,
                             onehot=True).astype(jnp.float32)
    _close(tlayers.embedding(tp["embedding"], torch.from_numpy(ids), tcfg.dtype).float(),
           want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_lstm_cell(dtype):
    rng = np.random.default_rng(1)
    jcfg, tcfg = _cfgs(1, dtype)
    jp, _, tp = _params(jcfg)
    H, K = jcfg.hidden_dim, jcfg.embedding_dim + jcfg.num_conditions
    x = rng.standard_normal((16, K)).astype(np.float32)
    h = rng.standard_normal((16, H)).astype(np.float32) * 0.5
    c = rng.standard_normal((16, H)).astype(np.float32) * 0.5
    jh, jc = jlstm.lstm_cell(jp["lstm_layer_0"], jnp.asarray(x), jnp.asarray(h),
                             jnp.asarray(c), dtype=jcfg.dtype)
    th, tc = tlstm.lstm_cell(tp["lstm_layer_0"], torch.from_numpy(x),
                             torch.from_numpy(h), torch.from_numpy(c), dtype=tcfg.dtype)
    _close(th, jh, dtype)
    _close(tc, jc, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 2, 3])
def test_hidden_init_and_stacked_cell(n, dtype):
    rng = np.random.default_rng(2)
    jcfg, tcfg = _cfgs(n, dtype)
    jp, _, tp = _params(jcfg)
    B, K = 16, jcfg.embedding_dim + jcfg.num_conditions
    z = rng.standard_normal((B, jcfg.latent_dim)).astype(np.float32)
    cond = rng.standard_normal((B, jcfg.num_conditions)).astype(np.float32)
    _close(tdec.hidden_init_row(tp, tcfg, torch.from_numpy(z), torch.from_numpy(cond)),
           jdec.hidden_init_row(jp, jcfg, jnp.asarray(z), jnp.asarray(cond)), dtype)
    jh, jc = jdec.initialize_hidden_state(jp, jcfg, jnp.asarray(z), jnp.asarray(cond))
    th, tc = tdec.initialize_hidden_state(tp, tcfg, torch.from_numpy(z),
                                          torch.from_numpy(cond))
    _close(th, jh, dtype)
    _close(tc, jc, dtype)
    x = rng.standard_normal((B, K)).astype(np.float32)
    jout, jh2, jc2 = jdec._stacked_cell(jp, jcfg, jnp.asarray(x), jh, jc)
    tout, th2, tc2 = tdec._stacked_cell(tp, tcfg, torch.from_numpy(x), th, tc)
    for got, want in ((tout, jout), (th2, jh2), (tc2, jc2)):
        _close(got, want, dtype)
