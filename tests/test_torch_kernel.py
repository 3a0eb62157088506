"""The fused sampler's CUDA kernels against their plain PyTorch version, on
the card: the CUDA-core ``fused_generate_kernel`` (forced) and the
tensor-core ``gen_tc_kernel`` (the route of every config it takes). Tests
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
    w = fd.prepare_weights(params, cfg, dev)
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
