"""The fused sampler's CUDA kernels against their plain PyTorch version, on
the card: the CUDA-core ``fused_generate_kernel`` (forced), the
tensor-core ``gen_tc_kernel`` (the route of every config it takes) and the
step route (``csrc/fused_generate_steps.cu``: the forward step kernels and
the sampling head ``gen_head_kernel`` / ``gen_head_tf32_kernel``). Tests
marked ``cuda`` skip without a CUDA device. This file imports no JAX, so it
also runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel.py -q

Tolerances: token agreement with the plain version on >= 99.0% of first
tokens and >= 97.0% of rows (the two sum matmuls in different orders, so
an argmax can flip where the top two logits tie to ~1 ulp, and the flipped
token then changes the rest of the row); the first step's scaled logits
within 1e-4 absolute in float32 and 1e-2 in bfloat16 (where an f32
difference of one ulp can move an operand's bf16 rounding by one step).

The CUDA-core configurations cover every instance of that kernel the gate
can pick: 8, 4, 2 and 1 rows per thread (the larger embedding widths shrink
the tile that fits in shared memory), each with the narrow (V <= 128) and
the wide vocab layout, in f32 and bf16. The tensor-core configurations cover
its instances: 1, 2 and 3-4 warpgroups a CTA, the narrow and (bf16) the wide
vocab layout, one and two head tiles a warpgroup. Its tokens are bitwise the
same for every cluster size and wherever a seed block sits in whatever
batch: only the gate columns are split over a cluster, never the reduction.
"""

import pytest
import torch

from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.models.decoder import hidden_init_row, init_decoder_params
from mlx_vae_tpu_torch.ops import fused_decoder as fd
from mlx_vae_tpu_torch.ops.train_common import RPTS

LOGIT_ATOL = {"float32": 1e-4, "bfloat16": 1e-2}


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU or interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _run(cfg, dev, B=300, L=24, temp=0.9, logits=False, **kw):
    params = init_decoder_params(torch.Generator().manual_seed(0), cfg)
    params = {k: {n: t.to(dev) for n, t in v.items()} for k, v in params.items()}
    w = fd.prepare_weights(params, cfg, dev, kernel=kw.get("kernel"))
    g = torch.Generator(device=dev).manual_seed(1)
    z = torch.randn((B, cfg.latent_dim), generator=g, device=dev)
    cond = torch.randn((B, cfg.num_conditions), generator=g, device=dev)
    nb = -(-B // fd.block_rows(B))
    seeds = torch.randint(0, 2**31 - 1, (nb,), generator=g, device=dev, dtype=torch.int32)
    temps = torch.full((nb,), temp, device=dev)
    h0 = hidden_init_row(params, cfg, z, cond).contiguous()
    lk = lp = None
    if logits:
        lk = torch.full((B, cfg.vocab_size), float("nan"), device=dev)
        lp = torch.full((B, cfg.vocab_size), float("nan"), device=dev)
    before = fd.fused_generate.launches
    k = fd.fused_generate(w, h0, cond, seeds, temps, L, logits_out=lk, **kw)
    torch.cuda.synchronize()
    assert fd.fused_generate.launches == before + 1
    for arg in ("rows_per_thread", "kernel", "cluster"):
        kw.pop(arg, None)
    p = fd.fused_generate_reference(w, h0, cond, seeds, temps, L, logits_out=lp, **kw)
    return (k, p, lk, lp) if logits else (k, p)


# (rows per thread the tile rule picks, shape)
CONFIGS = [
    (8, dict(num_layers=1, hidden_dim=32, embedding_dim=16, vocab_size=24)),
    (8, dict(num_layers=2, hidden_dim=128, embedding_dim=16, vocab_size=24, num_conditions=3)),
    (8, dict(num_layers=3, hidden_dim=100, embedding_dim=20, vocab_size=200)),
    (8, dict(num_layers=2, hidden_dim=384, embedding_dim=64, vocab_size=80)),
    (4, dict(num_layers=2, hidden_dim=32, embedding_dim=1007, vocab_size=24)),
    (4, dict(num_layers=2, hidden_dim=32, embedding_dim=1007, vocab_size=200)),
    (2, dict(num_layers=2, hidden_dim=32, embedding_dim=2307, vocab_size=24)),
    (2, dict(num_layers=2, hidden_dim=32, embedding_dim=2307, vocab_size=200)),
    (1, dict(num_layers=2, hidden_dim=32, embedding_dim=4807, vocab_size=24)),
    (1, dict(num_layers=2, hidden_dim=32, embedding_dim=4807, vocab_size=200)),
]


@pytest.mark.parametrize("shape", range(len(CONFIGS)))
def test_config_picks_its_kernel_instance(shape):
    """The tile rule picks the rows per thread each configuration is here
    to exercise (a CPU check of the host-side plan)."""
    rpt, kw = CONFIGS[shape]
    cfg = ModelConfig(latent_dim=8, **kw)
    assert fd.fused_generate_supported(cfg)
    _, tr = fd._cell_layout(cfg.hidden_dim)
    assert fd._tile_rows(cfg) == rpt * tr


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["greedy", "stochastic", "truncated"])
@pytest.mark.parametrize("shape", range(len(CONFIGS)))
def test_kernel_matches_plain(dev, shape, mode, dtype):
    cfg = ModelConfig(latent_dim=8, compute_dtype=dtype, **CONFIGS[shape][1])
    kw = {"greedy": {"greedy": True}, "stochastic": {},
          "truncated": {"top_k": 6, "top_p": 0.8}}[mode]
    k, p, lk, lp = _run(cfg, dev, logits=True, kernel="cuda_core", **kw)
    first = (k[:, 0] == p[:, 0]).float().mean().item()
    rows = (k == p).all(1).float().mean().item()
    assert first >= 0.99 and rows >= 0.97, (first, rows)
    assert ((k >= 0) & (k < cfg.vocab_size)).all()
    err = (lk - lp).abs().max().item()
    assert err <= LOGIT_ATOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_tokens_do_not_depend_on_the_tile(dev, dtype):
    """Every instance forced on one shape: each (row, unit) pair sums in the
    same order whatever the tile, so the tokens are bitwise equal."""
    cfg = ModelConfig(latent_dim=8, compute_dtype=dtype, num_layers=2, hidden_dim=64,
                      embedding_dim=16, vocab_size=200)
    outs = [_run(cfg, dev, rows_per_thread=r)[0] for r in RPTS]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(dev):
    cfg = ModelConfig(num_layers=9, hidden_dim=32, embedding_dim=16, vocab_size=24)
    with pytest.raises(NotImplementedError, match="num_layers=9"):
        _run(cfg, dev)
    cfg = ModelConfig(hidden_dim=32, embedding_dim=16, vocab_size=24, latent_dim=8)
    params = init_decoder_params(torch.Generator().manual_seed(0), cfg)
    params = {k: {n: t.to(dev) for n, t in v.items()} for k, v in params.items()}
    w = fd.prepare_weights(params, cfg, dev)
    with pytest.raises(ValueError, match="h0"):
        fd.fused_generate(w, torch.zeros(4, 32, device=dev, dtype=torch.float64),
                          torch.zeros(4, 1, device=dev), torch.zeros(1, device=dev,
                          dtype=torch.int32), torch.ones(1, device=dev), 4)


# ---- the tensor-core kernel ----

# (shape, dtypes): its instances (1, 2 or 4 warpgroups a CTA, the vocab
# layout, one or two head tiles a warpgroup), and H=1024 (bf16: S=16 only)
TC_SHAPES = [
    (dict(), ("float32", "bfloat16")),  # the default model: 2 / 4 warpgroups
    (dict(num_layers=3, hidden_dim=64, embedding_dim=20, vocab_size=120, num_conditions=3),
     ("float32", "bfloat16")),          # 2 / 4 warpgroups, 2 head tiles
    (dict(num_layers=1, hidden_dim=32, embedding_dim=16, vocab_size=24),
     ("float32", "bfloat16")),          # 2 warpgroups
    (dict(num_layers=2, hidden_dim=16, embedding_dim=16, vocab_size=80),
     ("float32", "bfloat16")),          # 1 warpgroup, 2 head tiles
    (dict(num_layers=2, hidden_dim=64, embedding_dim=16, vocab_size=200), ("bfloat16",)),
    (dict(num_layers=2, hidden_dim=1024, embedding_dim=16, vocab_size=24), ("bfloat16",)),
]
TC_CASES = [(i, dtype) for i, (_, dtypes) in enumerate(TC_SHAPES) for dtype in dtypes]


def _tc_cfg(case):
    i, dtype = TC_CASES[case]
    return ModelConfig(latent_dim=8, compute_dtype=dtype, **TC_SHAPES[i][0])


@pytest.mark.parametrize("case", range(len(TC_CASES)))
def test_tc_configs_take_the_tensor_core_route(case):
    """Each tensor-core case is a config the route sends there (a CPU check)."""
    cfg = _tc_cfg(case)
    assert fd.fused_generate_route(cfg) == "tc", fd._tc_unsupported_reason(cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["greedy", "stochastic", "truncated"])
@pytest.mark.parametrize("case", range(len(TC_CASES)))
def test_tc_kernel_matches_plain(dev, case, mode):
    cfg = _tc_cfg(case)
    kw = {"greedy": {"greedy": True}, "stochastic": {},
          "truncated": {"top_k": 6, "top_p": 0.8}}[mode]
    before = fd.fused_generate.tc_launches
    k, p, lk, lp = _run(cfg, dev, logits=True, **kw)
    assert fd.fused_generate.tc_launches == before + 1
    first = (k[:, 0] == p[:, 0]).float().mean().item()
    rows = (k == p).all(1).float().mean().item()
    assert first >= 0.99 and rows >= 0.97, (first, rows)
    assert ((k >= 0) & (k < cfg.vocab_size)).all()
    err = (lk - lp).abs().max().item()
    assert err <= LOGIT_ATOL[cfg.compute_dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(TC_CASES)))
def test_tc_kernel_tokens_do_not_depend_on_the_cluster(dev, case):
    """Every cluster size forced on one config: bitwise equal tokens."""
    cfg = _tc_cfg(case)
    outs = [_run(cfg, dev, cluster=S)[0] for S in fd.tc_clusters(cfg)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tc_seed_block_tokens_do_not_depend_on_the_batch(dev, dtype):
    """A seed block's tokens alone at B=256 equal its rows inside B=2048 and
    B=8192, bit for bit (the serving layer's contract)."""
    cfg = ModelConfig(compute_dtype=dtype)
    params = init_decoder_params(torch.Generator().manual_seed(0), cfg)
    params = {k: {n: t.to(dev) for n, t in v.items()} for k, v in params.items()}
    w = fd.prepare_weights(params, cfg, dev)
    g = torch.Generator(device=dev).manual_seed(2)
    B = 8192
    z = torch.randn((B, cfg.latent_dim), generator=g, device=dev)
    cond = torch.randn((B, cfg.num_conditions), generator=g, device=dev)
    seeds = torch.randint(0, 2**31 - 1, (B // 256,), generator=g, device=dev, dtype=torch.int32)
    temps = torch.full((B // 256,), 0.8, device=dev)
    h0 = hidden_init_row(params, cfg, z, cond).contiguous()
    blk = 5
    rows = slice(256 * blk, 256 * (blk + 1))
    alone = fd.fused_generate(w, h0[rows].contiguous(), cond[rows].contiguous(),
                              seeds[blk:blk + 1].contiguous(), temps[blk:blk + 1].contiguous(),
                              32)
    for nb in (8, 32):
        big = fd.fused_generate(w, h0[:256 * nb].contiguous(), cond[:256 * nb].contiguous(),
                                seeds[:nb].contiguous(), temps[:nb].contiguous(), 32)
        assert torch.equal(big[rows], alone), nb


@pytest.mark.cuda
def test_tc_kernel_refuses_what_it_does_not_take(dev):
    cfg = ModelConfig(hidden_dim=100, embedding_dim=16, vocab_size=24, latent_dim=8)
    with pytest.raises(NotImplementedError, match="tensor-core"):
        _run(cfg, dev, kernel="tc")


@pytest.mark.cuda
def test_tc_shared_memory_plan_matches_csrc(dev):
    """ops/fused_decoder.py:_tc_smem_bytes is csrc tc::plan's total."""
    lib = fd.build_library()
    for i, dtype in TC_CASES:
        cfg = _tc_cfg(TC_CASES.index((i, dtype)))
        for S in fd.tc_clusters(cfg):
            assert fd._tc_smem_bytes(cfg, S) == lib.fused_generate_tc_smem(
                cfg.hidden_dim, cfg.num_layers, cfg.vocab_size, S, fd._tc_head_tiles(cfg, S),
                int(dtype == "bfloat16")), (i, dtype, S)


# ---- the step route ----

# configs the tensor-core kernel refuses; the step route is the route of the
# first three in both dtypes, of the last in bf16 alone (f32 forces it there:
# H=48 is below STEPS_MIN_H["float32"])
STEP_SHAPES = [
    dict(num_layers=2, hidden_dim=384, embedding_dim=64, vocab_size=80),
    dict(num_layers=1, hidden_dim=192, embedding_dim=16, vocab_size=300, num_conditions=3),
    dict(num_layers=3, hidden_dim=320, embedding_dim=20, vocab_size=512),
    dict(num_layers=2, hidden_dim=48, embedding_dim=16, vocab_size=24),
]


def _steps_cfg(shape, dtype):
    return ModelConfig(latent_dim=8, compute_dtype=dtype, **STEP_SHAPES[shape])


def test_step_shapes_take_their_route():
    """The step shapes are configs the route sends to the step route, but
    the last in f32 (a CPU check)."""
    for i in range(len(STEP_SHAPES)):
        for dtype in ("float32", "bfloat16"):
            want = "cuda_core" if (i, dtype) == (len(STEP_SHAPES) - 1, "float32") else "steps"
            assert fd.fused_generate_route(_steps_cfg(i, dtype)) == want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["greedy", "stochastic", "truncated"])
@pytest.mark.parametrize("shape", range(len(STEP_SHAPES)))
def test_steps_kernel_matches_plain(dev, shape, mode, dtype):
    cfg = _steps_cfg(shape, dtype)
    kw = {"greedy": {"greedy": True}, "stochastic": {},
          "truncated": {"top_k": 6, "top_p": 0.8}}[mode]
    before = fd.fused_generate.step_launches
    k, p, lk, lp = _run(cfg, dev, logits=True, kernel="steps", **kw)
    assert fd.fused_generate.step_launches == before + 1
    first = (k[:, 0] == p[:, 0]).float().mean().item()
    rows = (k == p).all(1).float().mean().item()
    assert first >= 0.99 and rows >= 0.97, (first, rows)
    assert ((k >= 0) & (k < cfg.vocab_size)).all()
    err = (lk - lp).abs().max().item()
    assert err <= LOGIT_ATOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_steps_route_kernels_under_the_profiler(dev, dtype):
    """One call is 1 set-up launch, n*L step launches and L heads, and no
    other sampler kernel (the call alone is traced; a trace in which CUPTI
    recorded no device event is taken again, up to 3 traces)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = _steps_cfg(0, dtype)
    L, n, B = 8, cfg.num_layers, 300
    params = init_decoder_params(torch.Generator().manual_seed(0), cfg)
    params = {k: {m: t.to(dev) for m, t in v.items()} for k, v in params.items()}
    w = fd.prepare_weights(params, cfg, dev)
    g = torch.Generator(device=dev).manual_seed(1)
    cond = torch.randn((B, cfg.num_conditions), generator=g, device=dev)
    h0 = hidden_init_row(params, cfg, torch.randn((B, cfg.latent_dim), generator=g, device=dev),
                         cond).contiguous()
    args = (h0, cond, torch.ones(2, dtype=torch.int32, device=dev),
            torch.full((2,), 0.9, device=dev), L)
    fd.fused_generate(w, *args)  # built and warm
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # CUPTI can drop a kernel launched as the profiler starts: a first
            # kernel and a synchronize open the window (test_torch_train_kernel.py)
            torch.ones(1, device=dev)
            torch.cuda.synchronize()
            fd.fused_generate(w, *args)
            torch.cuda.synchronize()
        ran = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if ran:
            break
    step = "gen_step_tma_kernel" if dtype == "bfloat16" else "seq_fwd_tf32_kernel"
    head = "gen_head_kernel" if dtype == "bfloat16" else "gen_head_tf32_kernel"
    names = ("gen_init_kernel", step, head, "fused_generate_kernel", "gen_tc_kernel",
             "seq_fwd_step_kernel", "gen_step_kernel")  # the last: the replaced bf16 step
    got = {name: sum(name in k for k in ran) for name in names}
    assert got == {"gen_init_kernel": 1, step: n * L, head: L, "fused_generate_kernel": 0,
                   "gen_tc_kernel": 0, "seq_fwd_step_kernel": 0, "gen_step_kernel": 0}, got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("V", [80, 300, 512])
def test_steps_head_matches_its_plain_step(dev, V, dtype):
    """One sampling head alone (step t = 3, a third of the rows already
    ended, the end token's bias raised so that rows end mid-row) against
    sample_head_step_reference on the same inputs: tokens, ended flags and,
    at t = 0, the scaled logits."""
    cfg = ModelConfig(hidden_dim=192, embedding_dim=16, vocab_size=V, latent_dim=8,
                      compute_dtype=dtype)
    params = init_decoder_params(torch.Generator().manual_seed(V), cfg)
    params["fc_out"]["bias"][cfg.end_token] += 3.0
    params = {k: {n: t.to(dev) for n, t in v.items()} for k, v in params.items()}
    w = fd.prepare_weights(params, cfg, dev, kernel="steps")
    lib = fd.build_steps_library()
    B, L = 300, 6
    g = torch.Generator(device=dev).manual_seed(4)
    htop = torch.randn((B, cfg.hidden_dim), generator=g, device=dev).tanh().to(cfg.dtype)
    nb = -(-B // fd.block_rows(B))
    seeds = torch.randint(0, 2**31 - 1, (nb,), generator=g, device=dev, dtype=torch.int32)
    temps = torch.tensor([0.8, 1.3], device=dev)[:nb]
    for t, kw in ((3, dict(top_k=6, top_p=0.8)), (3, dict(greedy=True)), (0, {})):
        ended = torch.arange(B, device=dev) % 3 == 0
        out_k = torch.full((B, L), -1, dtype=torch.int32, device=dev)
        out_p = out_k.clone()
        ended_k = ended.int().contiguous()
        ended_p = ended.clone()
        lk = torch.full((B, V), float("nan"), device=dev)
        lp = torch.full((B, V), float("nan"), device=dev)
        scaled = torch.empty((B, V), device=dev)
        rc = lib.gen_head_launch(
            htop.data_ptr(), w.steps.woutT.data_ptr(), w.bout.data_ptr(), seeds.data_ptr(),
            temps.data_ptr(), out_k.data_ptr(), lk.data_ptr(), scaled.data_ptr(),
            ended_k.data_ptr(), B, L, V, cfg.hidden_dim, t, fd.block_rows(B),
            int(kw.get("greedy", False)), kw.get("top_k", 0), kw.get("top_p", 1.0),
            cfg.end_token, cfg.pad_token, int(dtype == "bfloat16"),
            torch.cuda.current_stream(dev).cuda_stream)
        assert rc == 0, lib.gen_steps_error_string(rc)
        fd.sample_head_step_reference(w, t, htop, seeds, temps, out_p, ended_p,
                                      logits_out=lp, split_tf32=dtype == "float32", **kw)
        torch.cuda.synchronize()
        agree = (out_k[:, t] == out_p[:, t]).float().mean().item()
        assert agree >= 0.99, (t, kw, agree)
        same = out_k[:, t] == out_p[:, t]
        assert torch.equal(ended_k.bool()[same], ended_p[same])
        assert (out_k[ended, t] == cfg.pad_token).all()
        assert ((out_k[:, t] == cfg.end_token) & ~ended).any()  # rows end at this step
        assert torch.equal(out_k[:, :t], out_p[:, :t]) and (out_k[:, t + 1:] == -1).all()
        if t == 0:
            assert (lk - lp).abs().max().item() <= LOGIT_ATOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_steps_misaligned_views_and_bitwise_repeat(dev, dtype):
    """cond and h0 as views that start 4 bytes past a 16-byte boundary (the
    element loads) give the tokens of aligned copies (the vector loads),
    and a second call repeats the first bit for bit."""
    cfg = _steps_cfg(1, dtype)
    params = init_decoder_params(torch.Generator().manual_seed(0), cfg)
    params = {k: {n: t.to(dev) for n, t in v.items()} for k, v in params.items()}
    w = fd.prepare_weights(params, cfg, dev)
    B, H, C = 300, cfg.hidden_dim, cfg.num_conditions
    g = torch.Generator(device=dev).manual_seed(3)
    z = torch.randn((B, cfg.latent_dim), generator=g, device=dev)
    cond = torch.randn((B, C), generator=g, device=dev)
    h0 = hidden_init_row(params, cfg, z, cond).contiguous()
    seeds = torch.randint(0, 2**31 - 1, (2,), generator=g, device=dev, dtype=torch.int32)
    temps = torch.full((2,), 0.9, device=dev)
    hb = torch.empty(B * H + 1, device=dev)
    cb = torch.empty(B * C + 1, device=dev)
    h0_m, cond_m = hb[1:].view(B, H), cb[1:].view(B, C)
    h0_m.copy_(h0)
    cond_m.copy_(cond)
    assert h0_m.data_ptr() % 16 and cond_m.data_ptr() % 16
    a = fd.fused_generate(w, h0, cond, seeds, temps, 16, top_k=6, top_p=0.8)
    b = fd.fused_generate(w, h0, cond, seeds, temps, 16, top_k=6, top_p=0.8)
    m = fd.fused_generate(w, h0_m, cond_m, seeds, temps, 16, top_k=6, top_p=0.8)
    assert torch.equal(a, b) and torch.equal(a, m)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_steps_seed_block_tokens_do_not_depend_on_the_batch(dev, dtype):
    """A seed block alone at B=256 equals its rows inside B=2048, bit for
    bit (the serving layer's contract)."""
    cfg = _steps_cfg(0, dtype)
    params = init_decoder_params(torch.Generator().manual_seed(0), cfg)
    params = {k: {n: t.to(dev) for n, t in v.items()} for k, v in params.items()}
    w = fd.prepare_weights(params, cfg, dev)
    g = torch.Generator(device=dev).manual_seed(2)
    B = 2048
    z = torch.randn((B, cfg.latent_dim), generator=g, device=dev)
    cond = torch.randn((B, cfg.num_conditions), generator=g, device=dev)
    seeds = torch.randint(0, 2**31 - 1, (B // 256,), generator=g, device=dev, dtype=torch.int32)
    temps = torch.linspace(0.5, 1.2, B // 256, device=dev)
    h0 = hidden_init_row(params, cfg, z, cond).contiguous()
    big = fd.fused_generate(w, h0, cond, seeds, temps, 24, top_k=6, top_p=0.8)
    for blk in (0, 5):
        rows = slice(256 * blk, 256 * (blk + 1))
        alone = fd.fused_generate(w, h0[rows].contiguous(), cond[rows].contiguous(),
                                  seeds[blk:blk + 1].contiguous(),
                                  temps[blk:blk + 1].contiguous(), 24, top_k=6, top_p=0.8)
        assert torch.equal(big[rows], alone), blk


# ---- the bf16 step kernel alone

def _step_case(dev, B, H, layer, seed=0):
    """One step launch's inputs at (B, H), E=128, C=1, V=80: layer 0 at
    t = 0 (the fed tokens' embedding rows, a few tokens outside [0, V), the
    conditions, f32 h0, c = 0) or a layer above at t > 0 (bf16 input rows
    and h_{t-1}, f32 c_{t-1}); the layer's interleaved weight and bias."""
    from mlx_vae_tpu_torch.ops.lstm import combined_weight

    cfg = ModelConfig(hidden_dim=H, latent_dim=8, compute_dtype="bfloat16")
    E, C, V = cfg.embedding_dim, cfg.num_conditions, cfg.vocab_size
    I = E if layer == 0 else H
    params = init_decoder_params(torch.Generator().manual_seed(seed), cfg)
    lp = params[f"lstm_layer_{min(layer, 1)}"]
    wt = fd.interleave_weight(combined_weight(lp).to(dev, torch.bfloat16), I, H,
                              C if layer == 0 else 0).contiguous()
    bias = lp["bias"].to(dev, torch.float32).contiguous()
    g = torch.Generator(device=dev).manual_seed(seed + B + H)
    case = dict(cfg=cfg, I=I, C=C if layer == 0 else 0, wt=wt, bias=bias)
    if layer == 0:
        tok = torch.randint(0, V, (B,), generator=g, device=dev, dtype=torch.int32)
        tok[::37] = -1
        tok[5::41] = V
        case.update(x=params["embedding"]["weight"].to(dev, torch.bfloat16).contiguous(), tok=tok,
                    cond=torch.randn((B, C), generator=g, device=dev),
                    h0=0.5 * torch.randn((B, H), generator=g, device=dev), c_in=None)
    else:
        case.update(x=(0.5 * torch.randn((B, H), generator=g, device=dev)).bfloat16(), tok=None,
                    hprev=(0.5 * torch.randn((B, H), generator=g, device=dev)).bfloat16(),
                    c_in=torch.randn((B, H), generator=g, device=dev))
    return case


def _rows(case):
    return case["x"].shape[0] if case["tok"] is None else case["tok"].shape[0]


def _launch_step(case, dev, bm, x=None, hprev=None):
    """gen_step_launch on the case (layer 0: its bf16 copies of h0 and the
    conditions), ``bm`` rows a tile; ``x`` / ``hprev`` replace the
    case's rows (a misaligned view). Returns (h bf16, c f32)."""
    lib = fd.build_steps_library()
    B, H = _rows(case), case["cfg"].hidden_dim
    condb = None
    if case["tok"] is not None:
        h0b, condb = fd.steps_bf16_operands(case["h0"], case["cond"])
        hp = h0b
    else:
        hp = case["hprev"]
    x = case["x"] if x is None else x
    hp = hp if hprev is None else hprev
    c = torch.full((B, H), float("nan"), device=dev)
    h = torch.full((B, H), float("nan"), device=dev).bfloat16()
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    rc = lib.gen_step_launch(
        x.data_ptr(), ptr(case["tok"]), 1, case["cfg"].vocab_size, ptr(condb), hp.data_ptr(),
        ptr(case["c_in"]), c.data_ptr(), case["wt"].data_ptr(), case["bias"].data_ptr(),
        h.data_ptr(), B, case["I"], H, case["C"], bm // 64,
        torch.cuda.current_stream(dev).cuda_stream)
    assert rc == 0, lib.gen_steps_error_string(rc)
    torch.cuda.synchronize()
    return h, c


def _plain_step(case, dev):
    """seq_fwd_step_reference on the same inputs: f32 products of the
    bf16-rounded operands (layer 0 at t = 0, a layer above at t = 1)."""
    B, H = _rows(case), case["cfg"].hidden_dim
    hs = torch.zeros((2, B, H), dtype=torch.bfloat16, device=dev)
    cs, gs = torch.zeros_like(hs), torch.zeros((2, B, 4 * H), dtype=torch.bfloat16, device=dev)
    if case["tok"] is not None:
        c = torch.zeros((B, H), device=dev)
        fd.seq_fwd_step_reference(case["wt"], case["bias"], 0, case["x"], c, hs, cs, gs,
                                  case["I"], H, tokens=case["tok"].long()[:, None],
                                  h0=case["h0"], cond=case["cond"])
        return hs[0], c
    c = case["c_in"].clone()
    hs[0] = case["hprev"]
    fd.seq_fwd_step_reference(case["wt"], case["bias"], 1, case["x"][None], c, hs, cs, gs,
                              case["I"], H, x_stride=0)
    return hs[1], c


@pytest.mark.cuda
@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("H", [96, 100, 768, 1024])
@pytest.mark.parametrize("B", [200, 256, 1000])
def test_step_launch_matches_its_plain_step(dev, B, H, layer):
    """One gen_step_tma_kernel launch alone against its plain step: h
    within 1e-2 (the stages' sums differ in order from the plain f32
    product, which can move a bf16 h by one step of 2^-8 near 1) and c
    within 1e-3; every tile instance gives the tile rule's output bit for
    bit (the same wgmma instructions over the same stages for every row),
    so does a repeat, and so do misaligned views of the input rows and
    h_{t-1} (the producer warpgroup stages those itself, as it does every h at
    H=100)."""
    case = _step_case(dev, B, H, layer)
    h, c = _launch_step(case, dev, fd.steps_tile(case["cfg"], B))
    hp, cp = _plain_step(case, dev)
    assert torch.isfinite(h.float()).all() and torch.isfinite(c).all()
    assert (h.float() - hp.float()).abs().max().item() <= 1e-2
    assert (c - cp).abs().max().item() <= 1e-3
    for bm in fd.STEP_TILES:
        ht, ct = _launch_step(case, dev, bm)
        assert torch.equal(ht, h) and torch.equal(ct, c), bm
    if layer == 0:
        return
    xm = torch.empty(B * H + 1, dtype=torch.bfloat16, device=dev)[1:].view(B, H)
    hm = torch.empty(B * H + 1, dtype=torch.bfloat16, device=dev)[1:].view(B, H)
    xm.copy_(case["x"])
    hm.copy_(case["hprev"])
    assert xm.data_ptr() % 16 and hm.data_ptr() % 16
    for bm in fd.STEP_TILES:
        hv, cv = _launch_step(case, dev, bm, x=xm, hprev=hm)
        assert torch.equal(hv, h) and torch.equal(cv, c), bm
