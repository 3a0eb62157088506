"""The fused sampler's CUDA kernel against its plain PyTorch version, on the
card. Tests marked ``cuda`` skip without a CUDA device. This file imports
no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel.py -q

Tolerances: token agreement with the plain version on >= 99.0% of first
tokens and >= 97.0% of rows (the two sum matmuls in different orders, so
an argmax can flip where the top two logits tie to ~1 ulp, and the flipped
token then changes the rest of the row); the first step's scaled logits
within 1e-4 absolute in float32 and 1e-2 in bfloat16 (where an f32
difference of one ulp can move an operand's bf16 rounding by one step).

The configurations cover every kernel instance the gate can pick: 8, 4, 2
and 1 rows per thread (the larger embedding widths shrink the tile that
fits in shared memory), each with the narrow (V <= 128) and the wide vocab
layout, in f32 and bf16.
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
    kw.pop("rows_per_thread", None)
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
    k, p, lk, lp = _run(cfg, dev, logits=True, **kw)
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
