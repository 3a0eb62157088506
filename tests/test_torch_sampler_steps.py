"""The step-major sampler's host side and its plain twin, on the CPU.

``csrc/fused_generate_steps.cu`` runs only on the card
(``tests/test_torch_kernel.py`` holds it against the plain version there).
Here: its launch plan, the route by config (``"tc"``, then ``"steps"``, then
``"cuda_core"``, then the scan sampler), its operands, and
``fused_generate_steps_reference``, the plain twin of the route launch by
launch, held against ``fused_generate_reference``, against itself as
split-TF32, and against JAX ``pallas_generate(interpret=True)`` and the JAX
decoder.

Tolerances, each with its reason:
* the unsplit twin's tokens equal the plain version's, and its first-step
  logits lie within 1e-5 (f32 sums over the same terms, in another order);
* the split-TF32 twin's first-step logits lie within 1e-6 of the largest
  magnitude of the unsplit twin's (the dropped lo*lo terms are ~2**-22 of
  each product);
* greedy tokens agree with JAX on >= 99.0% of first tokens and >= 97.0% of
  rows (two argmaxes over sums in different orders can flip where the top
  two logits tie to ~1 ulp, and the flip changes the rest of the row); the
  first logits within 1e-5 of JAX's in f32 and 2e-2 in bf16, as
  ``test_torch_sampling.py`` holds the plain version.
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
from mlx_vae_tpu_torch.ops.train_common import MAX_SMEM, fwd_step_plan
from mlx_vae_tpu_torch.utils.tree import params_from_numpy

from test_torch_sampling import _jax_first_logits

AGREE_FIRST, AGREE_ROWS = 0.99, 0.97
SCALED = dict(hidden_dim=1024, num_layers=4, latent_dim=512)


def _weights(cfg, seed=0, kernel=None):
    params = init_decoder_params(torch.Generator().manual_seed(seed), cfg)
    return params, fd.prepare_weights(params, cfg, "cpu", kernel=kernel)


def _inputs(params, cfg, B, temp=0.8, seed=1):
    rng = np.random.default_rng(seed)
    z = torch.from_numpy(rng.standard_normal((B, cfg.latent_dim)).astype(np.float32))
    cond = torch.from_numpy(rng.standard_normal((B, cfg.num_conditions)).astype(np.float32))
    nb = -(-B // fd.block_rows(B))
    seeds = torch.as_tensor(rng.integers(0, 2**31 - 1, nb), dtype=torch.int32)
    return hidden_init_row(params, cfg, z, cond), cond, seeds, torch.full((nb,), temp)


# ---- the launch plan ----

PLANS = [
    (dict(compute_dtype="bfloat16", **SCALED), 8192),
    (dict(compute_dtype="float32", **SCALED), 8192),
    (dict(compute_dtype="bfloat16", hidden_dim=768), 2048),
    (dict(compute_dtype="float32", vocab_size=300), 300),
    (dict(compute_dtype="bfloat16", vocab_size=512, **SCALED), 256),
]


@pytest.mark.parametrize("case", range(len(PLANS)))
def test_launch_plan(case):
    """1 + n*L + L launches: the set-up, n step launches a step, one head a
    step (128 rows a block); every block's shared memory within the card's
    232,448 B. f32 steps: 128 gate columns of 32 units by 128 rows. bf16
    steps: ``gen_step_tma_kernel`` at the call's rows a tile, a persistent
    grid of at most one CTA an SM."""
    kw, B = PLANS[case]
    cfg, L = ModelConfig(**kw), 64
    plan = fd.steps_launch_plan(cfg, B, L)
    n, H = cfg.num_layers, cfg.hidden_dim
    assert sum(p["count"] for p in plan) == 1 + n * L + L
    assert plan[0] == dict(kernel="gen_init_kernel", grid=(-(-B // 256), 1, 1), smem=0, count=1)
    rows = -(-B // 128)
    bf16 = cfg.compute_dtype == "bfloat16"
    bm = fd.steps_tile(cfg, B)
    for l, p in enumerate(plan[1:1 + n]):
        _, kp, np_ = fwd_step_plan(cfg.embedding_dim if l == 0 else H, H,
                                   cfg.num_conditions if l == 0 else 0)
        assert np_ == 4 * H and p["Kp"] == kp and p["count"] == L
        if bf16:
            assert p["kernel"] == f"gen_step_tma_kernel<{bm // 64}>"
            gx, gy = np_ // 128, -(-B // bm)
            assert p["tiles"] == (gx, gy)
            assert p["grid"] == (min(gx * gy, 132), 1, 1)
        else:
            assert p["kernel"] == "seq_fwd_tf32_kernel" and p["grid"] == (np_ // 128, rows, 1)
    head = plan[-1]
    assert head["kernel"] == ("gen_head_kernel" if bf16 else "gen_head_tf32_kernel")
    assert head["grid"] == (rows, 1, 1) and head["count"] == L
    assert max(p["smem"] for p in plan) <= MAX_SMEM
    print(f"{kw} B={B}: {len(plan)} kernels, {sum(p['count'] for p in plan)} launches, "
          f"largest smem {max(p['smem'] for p in plan)} B")


TILE_CONFIGS = [dict(**SCALED), dict(hidden_dim=768), dict(vocab_size=300),
                dict(vocab_size=512, **SCALED)]


@pytest.mark.parametrize("B", [200, 256, 2048, 8192])
@pytest.mark.parametrize("config", range(len(TILE_CONFIGS)))
def test_bf16_step_launch_plan(config, B):
    """The bf16 step launches at the scaled model, H=768, V=300 and V=512:
    the rows a tile the tile rule picks, tiles that cover every row and
    gate column, a persistent grid of at most one CTA an SM, a ring of 6
    stages (4 of 192 rows; an A tile of bm 128-byte lines and the 16 KB
    weight tile), its barriers and two buffers of the cell's c_{t-1} and
    bias within the block's 232,448 B, and the modelled L2 bytes each
    launch's CTAs read: each tile a stage's weight tile and A rows."""
    cfg = ModelConfig(compute_dtype="bfloat16", **TILE_CONFIGS[config])
    E, C, H = cfg.embedding_dim, cfg.num_conditions, cfg.hidden_dim
    bm = fd.steps_tile(cfg, B)
    assert bm in fd.STEP_TILES
    plan = fd.steps_launch_plan(cfg, B, 64)
    for l, p in enumerate(plan[1:1 + cfg.num_layers]):
        _, kp, np_ = fwd_step_plan(E if l == 0 else H, H, C if l == 0 else 0)
        gx, gy = p["tiles"]
        assert p["grid"][0] == min(132, gx * gy)
        assert gx * 128 == np_ and gy * bm >= B and (gy - 1) * bm < B
        assert p["threads"] == 2 * bm + 128
        depth = 4 if bm == 192 else 6
        assert p["ring"] == depth * (bm * 128 + 16384)
        assert p["smem"] == 1024 + p["ring"] + 16 * depth + 32 + 2 * (bm * 128 + 512) <= MAX_SMEM
        assert p["l2_bytes"] == gx * gy * (kp // 64) * (16384 + bm * 128)
    assert plan[1]["inputs_bf16"] == dict(h0=(B, H), cond=(B, 64))


@pytest.mark.parametrize("config", range(len(TILE_CONFIGS)))
def test_step_tile_rule(config):
    """The tile rule reads the config and B alone: 64-row tiles below one
    wave of 128-row tiles (132 CTAs), from there 192-row tiles. The same B
    gives the same rows from a fresh config."""
    kw = TILE_CONFIGS[config]
    cfg = ModelConfig(compute_dtype="bfloat16", **kw)
    ncol = 4 * cfg.hidden_dim // 128
    got = {B: fd.steps_tile(cfg, B) for B in (1, 64, 65, 200, 256, 1000, 2048, 8192)}
    for B, bm in got.items():
        assert bm == (64 if -(-B // 128) * ncol < fd.H100_SMS else 192)
        assert fd.steps_tile(ModelConfig(compute_dtype="bfloat16", **kw), B) == bm
    assert got[1] == 64 and got[8192] == 192
    assert got[256] == (64 if ncol * 2 < 132 else 192)
    assert fd.steps_tile(ModelConfig(hidden_dim=32, compute_dtype="bfloat16"), 20000) == 192


def test_bf16_operands_are_the_twins_rounding():
    """The bf16 copies of h0 and the conditions that the kernel's TMA reads
    equal, bit for bit, the twin's rounding of those segments
    (``.to(bfloat16)``) and round to nearest even (an independent bit-level
    rounding of the f32 words, as the kernel's f32 staging, cvt.rn, did):
    h0 ``[B, H]``, the conditions zero-padded to their 64-wide stage;
    misaligned views come out as fresh contiguous tensors; the twin fed the
    copies' values gives the same tokens and logits as fed the f32 rows."""
    rng = np.random.default_rng(5)
    B, H, C = 37, 48, 3
    h0 = torch.from_numpy(rng.standard_normal((B, H)).astype(np.float32))
    cond = torch.from_numpy((rng.standard_normal((B, C)) * 40).astype(np.float32))
    # ties to even, a signed zero, a subnormal
    h0[0, :4] = torch.tensor([1.0 + 2.0**-8, 1.0 + 3 * 2.0**-8, -0.0, 1e-40])
    hb, cb = fd.steps_bf16_operands(h0, cond)
    assert hb.dtype == cb.dtype == torch.bfloat16 and hb.shape == (B, H) and cb.shape == (B, 64)
    assert torch.equal(hb.view(torch.int16), h0.to(torch.bfloat16).view(torch.int16))
    assert torch.equal(cb[:, :C].view(torch.int16), cond.to(torch.bfloat16).view(torch.int16))
    assert torch.equal(cb[:, C:].view(torch.int16), torch.zeros((B, 64 - C), dtype=torch.int16))

    def rne(x):  # f32 -> bf16 bits, round to nearest even
        u = x.numpy().view(np.uint32).astype(np.uint64)
        return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)

    assert np.array_equal(hb.view(torch.int16).numpy().view(np.uint16), rne(h0))
    assert np.array_equal(cb[:, :C].contiguous().view(torch.int16).numpy().view(np.uint16),
                          rne(cond))
    view_h, view_c = torch.empty(B * H + 1)[1:].view(B, H), torch.empty(B * C + 1)[1:].view(B, C)
    view_h.copy_(h0)
    view_c.copy_(cond)
    hv, cv = fd.steps_bf16_operands(view_h, view_c)
    assert hv.is_contiguous() and cv.is_contiguous()
    assert torch.equal(hv.view(torch.int16), hb.view(torch.int16)) and torch.equal(
        cv.view(torch.int16), cb.view(torch.int16))
    cfg = ModelConfig(hidden_dim=H, embedding_dim=16, latent_dim=8, vocab_size=24,
                      num_conditions=C, compute_dtype="bfloat16")
    params, w = _weights(cfg, kernel="steps")
    nb = -(-B // fd.block_rows(B))
    seeds, temps = torch.arange(nb, dtype=torch.int32) + 3, torch.full((nb,), 0.8)
    l32, lb = torch.empty((B, 24)), torch.empty((B, 24))
    want = fd.fused_generate_steps_reference(w, h0, cond, seeds, temps, 8, top_k=6, top_p=0.8,
                                             logits_out=l32)
    got = fd.fused_generate_steps_reference(w, hb.float(), cb[:, :C].float(), seeds, temps, 8,
                                            top_k=6, top_p=0.8, logits_out=lb)
    assert torch.equal(got, want) and torch.equal(lb, l32)


@pytest.mark.parametrize("sms", [66, 114, 132])
def test_step_tile_follows_the_cards_sm_count(sms):
    """The tile rule and the plan read the card's SM count: 64-row tiles
    while 128-row tiles would not fill one wave of ``sms`` CTAs, and the
    plan's grid (an upper bound: the launcher asks the card how many CTAs
    it holds) never above ``sms`` CTAs. The scaled model has 32
    column tiles, so one wave of 128-row tiles is ``sms / 32`` row tiles."""
    cfg = ModelConfig(compute_dtype="bfloat16", **SCALED)
    for B in (128, 256, 512, 1024, 2048):
        want = 64 if -(-B // 128) * 32 < sms else 192
        assert fd.steps_tile(cfg, B, sms) == want, B
        for p in fd.steps_launch_plan(cfg, B, 4, sms)[1:1 + cfg.num_layers]:
            assert p["grid"][0] == min(sms, p["tiles"][0] * p["tiles"][1])
    for B in (256, 8192):  # without a card: an H100's 132 SMs
        assert fd.steps_tile(cfg, B) == fd.steps_tile(cfg, B, fd.H100_SMS)


# ---- the route, by config alone ----

ROUTES = [  # E=128, C=1 (the default widths), both dtypes
    (dict(), "tc", "tc"),
    (dict(hidden_dim=512), "tc", "tc"),
    (dict(hidden_dim=512, num_layers=4), "tc", "steps"),
    (dict(hidden_dim=768), "steps", "steps"),
    (dict(hidden_dim=1024, num_layers=1), "tc", "steps"),
    (dict(hidden_dim=1024, num_layers=2), "tc", "steps"),
    (SCALED, "steps", "steps"),
    (dict(vocab_size=300), "steps", "steps"),
    (dict(vocab_size=512, **SCALED), "steps", "steps"),
    (dict(hidden_dim=48), "steps", "cuda_core"),
    (dict(hidden_dim=100), "steps", "cuda_core"),
    (dict(hidden_dim=160), "steps", "cuda_core"),
    (dict(hidden_dim=192), "steps", "steps"),
    (dict(hidden_dim=40), "cuda_core", "cuda_core"),
    (dict(hidden_dim=2048), None, None),
    (dict(vocab_size=600), None, None),
    (dict(reference_zero_state=True, hidden_dim=768), None, None),
]


@pytest.mark.parametrize("case", range(len(ROUTES)))
def test_route_table(case):
    """The route of each config: the tensor-core kernel where a cluster
    size fits, then the step route, then the CUDA-core kernel, then (None)
    the scan sampler; the step route's operands are prepared only where it
    is the route."""
    kw, bf16, f32 = ROUTES[case]
    for dtype, want in (("bfloat16", bf16), ("float32", f32)):
        cfg = ModelConfig(compute_dtype=dtype, **kw)
        if want is None:
            assert not fd.fused_generate_supported(cfg)
            assert not fd.fused_generate_steps_supported(cfg)
            continue
        assert fd.fused_generate_route(cfg) == want, (dtype, kw)
        if want == "steps":
            assert fd.fused_generate_steps_supported(cfg) and fd.steps_preferred(cfg)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_step_route_cut_off(dtype):
    """Below ``STEPS_MIN_H`` a config the tensor-core kernel refuses takes
    the CUDA-core kernel; from it on, the step route."""
    h = fd.STEPS_MIN_H[dtype]
    lo = ModelConfig(hidden_dim=h - 1, compute_dtype=dtype)
    at = ModelConfig(hidden_dim=h, vocab_size=300, compute_dtype=dtype)  # V > 256: no cluster
    assert fd.fused_generate_route(lo) == "cuda_core"
    assert fd.fused_generate_route(at) == "steps"
    assert fd.fused_generate_route(lo, kernel="steps") == "steps"


def test_step_operands_only_where_the_route_is_steps():
    small = dict(embedding_dim=16, latent_dim=8, vocab_size=24)
    _, w = _weights(ModelConfig(hidden_dim=32, **small))
    assert w.steps is None and w.tc is not None  # the tensor-core route's
    cfg = ModelConfig(hidden_dim=192, **small)
    _, w = _weights(cfg)
    assert fd.fused_generate_route(cfg) == "steps" and w.tc is None
    assert w.steps.woutT.shape == (24, 192) and w.steps.wt.dtype == torch.float32
    assert w.steps.wt.numel() == sum(
        fwd_step_plan(16 if l == 0 else 192, 192, 1 if l == 0 else 0)[1] * 4 * 192
        for l in range(2))
    _, w = _weights(ModelConfig(hidden_dim=32, **small), kernel="steps")
    assert w.steps is not None


def test_forced_steps_route_is_checked():
    """Forcing the step route on a config it does not take raises, as do
    the other routes' arguments with it; nothing falls back."""
    with pytest.raises(NotImplementedError, match="step-major"):
        fd.fused_generate_route(ModelConfig(hidden_dim=2048), kernel="steps")
    with pytest.raises(NotImplementedError, match="step-major"):
        fd.fused_generate_route(ModelConfig(reference_zero_state=True), kernel="steps")
    cfg = ModelConfig(hidden_dim=768)
    with pytest.raises(ValueError, match="rows_per_thread"):
        fd.fused_generate_route(cfg, kernel="steps", rows_per_thread=1)
    with pytest.raises(ValueError, match="cluster"):
        fd.fused_generate_route(cfg, kernel="steps", cluster=1)
    small = ModelConfig(hidden_dim=96, embedding_dim=16, latent_dim=8, vocab_size=24)
    params, w = _weights(small)
    args = _inputs(params, small, 4)
    with pytest.raises(NotImplementedError, match="tensor-core"):
        fd.fused_generate(w, *args, 3, kernel="tc")


def test_cpu_wrapper_runs_the_plain_version_without_counting():
    cfg = ModelConfig(hidden_dim=192, embedding_dim=16, latent_dim=8, vocab_size=24)
    params, w = _weights(cfg)
    args = _inputs(params, cfg, 6)
    before = (fd.fused_generate.launches, fd.fused_generate.step_launches)
    got = fd.fused_generate(w, *args, 5, kernel="steps")
    assert (fd.fused_generate.launches, fd.fused_generate.step_launches) == before
    assert torch.equal(got, fd.fused_generate_reference(w, *args, 5))


# ---- the twin against the plain version ----

MODES = [("greedy", dict(greedy=True)), ("T=0.8 top_k=6 top_p=0.8", dict(top_k=6, top_p=0.8))]
TWIN_SHAPES = [(n, H, V) for n in (1, 2, 3) for H in (48, 96) for V in (80, 300)]


@pytest.mark.parametrize("mode", range(len(MODES)))
@pytest.mark.parametrize("shape", TWIN_SHAPES)
def test_unsplit_twin_matches_plain(shape, mode):
    n, H, V = shape
    name, kw = MODES[mode]
    cfg = ModelConfig(num_layers=n, hidden_dim=H, vocab_size=V, embedding_dim=16, latent_dim=8)
    params, w = _weights(cfg, seed=n)
    args = _inputs(params, cfg, 40, seed=H + V)
    lp, lt = torch.empty((40, V)), torch.empty((40, V))
    want = fd.fused_generate_reference(w, *args, 12, logits_out=lp, **kw)
    got = fd.fused_generate_steps_reference(w, *args, 12, logits_out=lt, **kw)
    err = float((lt - lp).abs().max())
    print(f"n={n} H={H} V={V} {name}: tokens equal {torch.equal(got, want)}, first logits "
          f"max |diff| {err:.3e}")
    assert torch.equal(got, want) and err <= 1e-5


def test_block_of_a_larger_call_equals_it_alone():
    """The second 256-row block of a B=512 call (its own seed and
    temperature) equals that block run alone at B=256."""
    cfg = ModelConfig(hidden_dim=48, vocab_size=80, embedding_dim=16, latent_dim=8)
    params, w = _weights(cfg, seed=3)
    h0, cond, _, _ = _inputs(params, cfg, 512, seed=4)
    seeds = torch.tensor([11, 12345], dtype=torch.int32)
    temps = torch.tensor([0.8, 1.3])
    big = fd.fused_generate_steps_reference(w, h0, cond, seeds, temps, 10, top_k=6, top_p=0.9)
    alone = fd.fused_generate_steps_reference(w, h0[256:], cond[256:], seeds[1:], temps[1:], 10,
                                              top_k=6, top_p=0.9)
    assert torch.equal(big[256:], alone)
    assert not torch.equal(big[:256], alone)


@pytest.mark.parametrize("n,V", [(1, 80), (2, 300), (3, 80)])
def test_split_twin_within_the_split_of_the_unsplit(n, V):
    cfg = ModelConfig(num_layers=n, hidden_dim=96, vocab_size=V, embedding_dim=16, latent_dim=8)
    params, w = _weights(cfg, seed=n)
    args = _inputs(params, cfg, 40, seed=V)
    lu, ls = torch.empty((40, V)), torch.empty((40, V))
    want = fd.fused_generate_steps_reference(w, *args, 12, greedy=True, logits_out=lu)
    got = fd.fused_generate_steps_reference(w, *args, 12, greedy=True, logits_out=ls,
                                            split_tf32=True)
    rel = float((ls - lu).abs().max() / lu.abs().max())
    first = float((got[:, 0] == want[:, 0]).float().mean())
    rows = float((got == want).all(1).float().mean())
    print(f"n={n} V={V}: split vs unsplit first logits {rel:.3e} of the largest; tokens "
          f"first {first:.4f} rows {rows:.4f}")
    assert rel <= 1e-6 and first >= AGREE_FIRST and rows >= AGREE_ROWS


# ---- the twin against JAX ----

def _jax_model(dtype="float32", n=2, H=128, seed=0):
    kw = dict(vocab_size=24, embedding_dim=16, hidden_dim=H, latent_dim=8, num_conditions=1,
              num_layers=n, compute_dtype=dtype)
    jcfg, cfg = JaxConfig(**kw), ModelConfig(**kw)
    jp = jdec.init_decoder_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


def test_twin_greedy_matches_pallas_interpret():
    jcfg, cfg, jp, tp = _jax_model()
    rng = np.random.default_rng(2)
    z = rng.standard_normal((64, 8)).astype(np.float32)
    cond = rng.standard_normal((64, 1)).astype(np.float32)
    want = np.asarray(pallas_generate(jp, jcfg, jnp.asarray(z), jnp.asarray(cond),
                                      jax.random.PRNGKey(3), max_length=16, greedy=True,
                                      interpret=True))
    w = fd.prepare_weights(tp, cfg, "cpu", kernel="steps")
    zt, ct = torch.from_numpy(z), torch.from_numpy(cond)
    got = fd.fused_generate_steps_reference(
        w, hidden_init_row(tp, cfg, zt, ct), ct, torch.zeros(1, dtype=torch.int32),
        torch.ones(1), 16, greedy=True).numpy()
    first = float((got[:, 0] == want[:, 0]).mean())
    rows = float((got == want).all(1).mean())
    print(f"step twin vs pallas interpret: first {first:.4f} rows {rows:.4f}")
    assert first >= AGREE_FIRST and rows >= AGREE_ROWS


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_twin_first_logits_match_jax(dtype, atol):
    T = 0.8
    jcfg, cfg, jp, tp = _jax_model(dtype, H=32)
    rng = np.random.default_rng(9)
    z = rng.standard_normal((16, 8)).astype(np.float32)
    cond = rng.standard_normal((16, 1)).astype(np.float32)
    want = np.stack([_jax_first_logits(jcfg, jp, z[i:i + 1], cond[i:i + 1])
                     for i in range(16)]) / np.float32(T)
    w = fd.prepare_weights(tp, cfg, "cpu", kernel="steps")
    zt, ct = torch.from_numpy(z), torch.from_numpy(cond)
    got = torch.full((16, 24), float("nan"))
    fd.fused_generate_steps_reference(w, hidden_init_row(tp, cfg, zt, ct), ct,
                                      torch.zeros(1, dtype=torch.int32), torch.full((1,), T),
                                      3, logits_out=got)
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=atol)
