"""The tensor-core sampler's host side and its layout twin, on the CPU.

``csrc/fused_generate.cu:gen_tc_kernel`` runs only on the card
(``tests/test_torch_kernel.py`` holds it against the plain version there).
Here: its operand preparation (the gate-interleaved K-major weight copies and
their split-TF32 planes), its route and cluster-size rule, and
``fused_generate_split_reference``, the plain twin of its layout (per-CTA
column slices, the 3-term split-TF32 product), held against itself across
cluster sizes, against ``fused_generate_reference`` and against JAX
``pallas_generate(interpret=True)``.

Tolerances, each with its reason:
* hi + lo reconstructs each f32 weight within 2**-21 of its magnitude: hi
  keeps 11 significant bits (rounded to nearest), lo the next 11, so the
  split drops at most 2**-22 relative, and the f32 sum hi + lo rounds once.
* the twin's first-step logits lie within 1e-4 of the plain version's in
  f32 (the card's gate for the kernel; the dropped lo*lo terms are ~2**-22 of
  each product and the sums run in another order) and 1e-2 in bf16 (one
  bf16 rounding step of an operand, as the card's gate);
* greedy tokens agree with JAX on >= 99.0% of first tokens and >= 97.0% of
  rows (two argmaxes over sums in different orders can flip where the top
  two logits tie to ~1 ulp, and the flip changes the rest of the row).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_vae_tpu.config import ModelConfig as JaxConfig
from mlx_vae_tpu.models import decoder as jdec
from mlx_vae_tpu.ops.pallas_decoder import pallas_generate
from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.models.decoder import hidden_init_row, init_decoder_params
from mlx_vae_tpu_torch.ops import fused_decoder as fd
from mlx_vae_tpu_torch.ops.lstm import combined_weight
from mlx_vae_tpu_torch.ops.train_common import MAX_SMEM
from mlx_vae_tpu_torch.utils.tree import params_from_numpy

AGREE_FIRST, AGREE_ROWS = 0.99, 0.97
LOGIT_ATOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _weights(cfg, seed=0):
    params = init_decoder_params(torch.Generator().manual_seed(seed), cfg)
    return params, fd.prepare_weights(params, cfg, "cpu")


def _inputs(params, cfg, B, temp=0.8, seed=1):
    rng = np.random.default_rng(seed)
    z = torch.from_numpy(rng.standard_normal((B, cfg.latent_dim)).astype(np.float32))
    cond = torch.from_numpy(rng.standard_normal((B, cfg.num_conditions)).astype(np.float32))
    nb = -(-B // fd.block_rows(B))
    seeds = torch.as_tensor(rng.integers(0, 2**31 - 1, nb), dtype=torch.int32)
    return hidden_init_row(params, cfg, z, cond), cond, seeds, torch.full((nb,), temp)


# ---- the operands ----

@pytest.mark.parametrize("scale", [1e-3, 1.0, 3e4])
def test_tf32_split_reconstructs_and_is_tf32_exact(scale):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32)) * scale
    hi, lo = fd.tf32_split(x)
    low13 = (1 << 13) - 1
    assert int((hi.view(torch.int32) & low13).abs().max()) == 0
    assert int((lo.view(torch.int32) & low13).abs().max()) == 0
    err = ((hi + lo) - x).abs()
    assert bool((err <= x.abs() * 2.0**-21).all()), float((err / x.abs()).max())
    assert bool(((hi - x).abs() <= x.abs() * 2.0**-11).all())  # hi alone: TF32 of x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [dict(), dict(num_layers=3, hidden_dim=64, embedding_dim=20,
                                                 vocab_size=120, num_conditions=3)])
def test_tc_weight_copies_unpermute_to_the_combined_weights(dtype, shape):
    """Un-permuting each interleaved K-major copy (rows by ``tc_gate_rows``,
    columns by ``tc_reduction_cols``) gives the layer's combined weight; every
    other entry is zero; the head copy is ``fc_out`` transposed."""
    cfg = ModelConfig(compute_dtype=dtype, latent_dim=8, **shape)
    params, w = _weights(cfg)
    tc = w.tc
    H, V = cfg.hidden_dim, cfg.vocab_size
    rows = fd.tc_gate_rows(H)
    assert sorted(rows.tolist()) == list(range(4 * H))
    for i, layer in enumerate(tc.layers):
        want = combined_weight(params[f"lstm_layer_{i}"]).to(cfg.dtype).float()
        kb = tc.xp if i == 0 else tc.hp
        cols = fd.tc_reduction_cols(want.shape[0] - H, H, kb)
        assert layer.shape == (4 * H, kb + tc.hp)
        got = layer.float()
        if dtype == "float32":
            got = got + tc.layers_lo[i]
            sel = got[rows[:, None], cols[None]].T
            assert bool(((sel - want).abs() <= want.abs() * 2.0**-21).all())
        else:
            sel = got[rows[:, None], cols[None]].T
            assert torch.equal(sel, want)
        mask = torch.ones_like(got, dtype=torch.bool)
        mask[rows[:, None], cols[None]] = False
        assert not bool(got[mask].any())
    head = tc.wout.float() + (tc.wout_lo if dtype == "float32" else 0)
    wout = params["fc_out"]["weight"].to(cfg.dtype).float()
    assert head.shape[0] % 256 == 0 and head.shape[0] >= V
    assert bool(((head[:V, :H] - wout).abs() <= wout.abs() * 2.0**-21).all())
    assert not bool(head[V:].any()) and not bool(head[:, H:].any())


def test_default_model_cluster_budget():
    """The default model takes S = 8 and 16 in f32, 4, 8 and 16 in bf16
    (csrc note), each CTA within the card's shared memory."""
    for dtype, want in (("float32", (8, 16)), ("bfloat16", (4, 8, 16))):
        cfg = ModelConfig(compute_dtype=dtype)
        assert fd.tc_clusters(cfg) == want
        assert all(fd._tc_smem_bytes(cfg, S) <= MAX_SMEM for S in want)
        assert fd.tc_cluster_size(cfg) == want[0]


# ---- the route ----

ROUTES = [
    (dict(), "tc"),
    (dict(compute_dtype="bfloat16"), "tc"),
    (dict(hidden_dim=100), "cuda_core"),           # not 16 units a warpgroup
    (dict(vocab_size=600), None),                  # the scan sampler's (no kernel)
    (dict(hidden_dim=48), "cuda_core"),            # no cluster size fits (3 warpgroups)
    (dict(hidden_dim=32, embedding_dim=4807), "tc"),  # x is staged a line at a time
    (dict(reference_zero_state=True), None),
]


@pytest.mark.parametrize("case", range(len(ROUTES)))
def test_route_depends_on_the_config_alone(case):
    """The kernel, and the cluster size, come from the config: the same for
    every batch size from 1 to 8192."""
    kw, want = ROUTES[case]
    cfg = ModelConfig(**kw)
    if want is None:
        assert not fd.fused_generate_supported(cfg)
        assert not fd.fused_generate_tc_supported(cfg)
        return
    assert fd.fused_generate_route(cfg) == want
    assert fd.fused_generate_tc_supported(cfg) == (want == "tc")
    if want == "tc":
        assert {fd.tc_cluster_size(cfg) for _ in (1, 63, 64, 65, 256, 2048, 8192)} == {
            fd.tc_clusters(cfg)[0]}


def test_forced_routes_are_checked_on_the_cpu():
    cfg = ModelConfig(hidden_dim=100, embedding_dim=16, vocab_size=24, latent_dim=8)
    params, w = _weights(cfg)
    args = _inputs(params, cfg, 4)
    with pytest.raises(NotImplementedError, match="tensor-core"):
        fd.fused_generate(w, *args, 3, kernel="tc")
    with pytest.raises(ValueError, match="kernel="):
        fd.fused_generate(w, *args, 3, kernel="wgmma")
    cfg = ModelConfig(embedding_dim=16, vocab_size=24, latent_dim=8)
    params, w = _weights(cfg)
    args = _inputs(params, cfg, 4)
    with pytest.raises(ValueError, match="cluster=2"):
        fd.fused_generate(w, *args, 3, cluster=2)
    with pytest.raises(ValueError, match="rows_per_thread"):
        fd.fused_generate(w, *args, 3, kernel="tc", rows_per_thread=8)
    with pytest.raises(ValueError, match="cluster applies"):
        fd.fused_generate(w, *args, 3, kernel="cuda_core", cluster=8)
    before = (fd.fused_generate.launches, fd.fused_generate.tc_launches,
              fd.fused_generate.core_launches)
    out = fd.fused_generate(w, *args, 3, cluster=16)  # the CPU runs the plain version
    assert out.shape == (4, 3)
    assert (fd.fused_generate.launches, fd.fused_generate.tc_launches,
            fd.fused_generate.core_launches) == before


# ---- the layout twin ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_twin_is_bitwise_equal_across_cluster_sizes(dtype):
    """Only N is split over the cluster, so each gate column sums the same
    products in the same order whatever S: tokens and logits bit for bit."""
    cfg = ModelConfig(compute_dtype=dtype, embedding_dim=16, vocab_size=24, latent_dim=8)
    params, w = _weights(cfg)
    args = _inputs(params, cfg, 16)
    outs, logits = [], []
    for S in (1, 2, 4, 16):
        lo = torch.full((16, cfg.vocab_size), float("nan"))
        outs.append(fd.fused_generate_split_reference(w, *args, 2, logits_out=lo, cluster=S))
        logits.append(lo)
    for o, lo in zip(outs[1:], logits[1:]):
        assert torch.equal(o, outs[0])
        assert torch.equal(lo, logits[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_twin_first_logits_match_the_plain_version_at_full_width(dtype):
    cfg = ModelConfig(compute_dtype=dtype)
    params, w = _weights(cfg, seed=3)
    args = _inputs(params, cfg, 32, seed=4)
    want = torch.empty((32, cfg.vocab_size))
    got = torch.empty_like(want)
    fd.fused_generate_reference(w, *args, 1, logits_out=want)
    fd.fused_generate_split_reference(w, *args, 1, logits_out=got,
                                      cluster=fd.tc_cluster_size(cfg))
    err = float((got - want).abs().max())
    print(f"{dtype}: twin vs plain first-step logits max |diff| {err:.3e}")
    assert err <= LOGIT_ATOL[dtype]


@pytest.mark.parametrize("n", [1, 2])
def test_split_twin_greedy_matches_pallas_interpret(n):
    kw = dict(vocab_size=24, embedding_dim=16, hidden_dim=32, latent_dim=8,
              num_conditions=1, num_layers=n)
    jcfg, cfg = JaxConfig(**kw), ModelConfig(**kw)
    jp = jdec.init_decoder_params(jax.random.PRNGKey(n), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(n)
    z = rng.standard_normal((64, 8)).astype(np.float32)
    cond = rng.standard_normal((64, 1)).astype(np.float32)
    want = np.asarray(pallas_generate(jp, jcfg, jnp.asarray(z), jnp.asarray(cond),
                                      jax.random.PRNGKey(3), max_length=16, greedy=True,
                                      interpret=True))
    w = fd.prepare_weights(tp, cfg, "cpu")
    zt, ct = torch.from_numpy(z), torch.from_numpy(cond)
    got = fd.fused_generate_split_reference(
        w, hidden_init_row(tp, cfg, zt, ct), ct, torch.zeros(1, dtype=torch.int32),
        torch.ones(1), 16, greedy=True, cluster=fd.tc_clusters(cfg)[-1]).numpy()
    first = float((got[:, 0] == want[:, 0]).mean())
    rows = float((got == want).all(1).mean())
    print(f"n={n}: split twin vs pallas interpret: first {first:.4f} rows {rows:.4f}")
    assert first >= AGREE_FIRST and rows >= AGREE_ROWS


def test_split_twin_refuses_what_the_kernel_does_not_take():
    cfg = ModelConfig(hidden_dim=100, embedding_dim=16, vocab_size=24, latent_dim=8)
    params, w = _weights(cfg)
    assert w.tc is None
    with pytest.raises(NotImplementedError):
        fd.fused_generate_split_reference(w, *_inputs(params, cfg, 4), 2)
    cfg = ModelConfig(hidden_dim=32, embedding_dim=16, vocab_size=24, latent_dim=8)
    params, w = _weights(cfg)
    with pytest.raises(ValueError, match="cluster=4"):
        fd.fused_generate_split_reference(w, *_inputs(params, cfg, 4), 2, cluster=4)
