"""The train step's CUDA kernels (fused encoder, fused training decoder:
forward and backward each) against their plain PyTorch versions, on the
card. Tests marked ``cuda`` skip without a CUDA device. This file imports
no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_train_kernel.py -q

Yardstick: max |kernel - plain| / max |plain| per output or gradient leaf,
within 1e-4 in float32 (the two sum in different orders) and 2e-2 in
bfloat16 (where a different summation order can move a stored residual or
a rounded gate cotangent by one bf16 ulp, ~4e-3 of the value). Each
backward kernel gets the plain forward's residuals, as its plain twin does.
With teacher forcing below 1, fed tokens agree on >= 97.0% of rows (an
argmax can flip where two logits tie to ~1 ulp; the JAX package's own
kernel/scan contract).

The shapes cover the kernel instances the tile plan can pick: forward rows
per thread 8, 4, 2 and 1 (large embedding widths shrink the forward tile),
reverse-kernel rows per block 8, 4 and 2 (deep, wide stacks shrink it), both
vocab layouts (V <= 128 and V <= 512), H below, at and above one thread
per hidden unit, ragged batches, and one row of one step.
"""

import pytest
import torch

from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.losses import complete as complete_mod
from mlx_vae_tpu_torch.models.decoder import decoder_apply, init_decoder_params
from mlx_vae_tpu_torch.models.encoder import encoder_apply, init_encoder_params
from mlx_vae_tpu_torch.ops import fused_encoder as fe
from mlx_vae_tpu_torch.ops import fused_train_decoder as fd
from mlx_vae_tpu_torch.ops import train_common as tc

TOL = {"float32": 1e-4, "bfloat16": 2e-2}

# (forward rows per thread, reverse rows per block, shape, (B, L))
CONFIGS = [
    (8, 8, dict(num_layers=1, hidden_dim=32, embedding_dim=16, vocab_size=24), (37, 9)),
    (8, 8, dict(num_layers=2, hidden_dim=128, embedding_dim=16, vocab_size=24,
                num_conditions=3), (40, 7)),
    (8, 8, dict(num_layers=3, hidden_dim=100, embedding_dim=20, vocab_size=200), (33, 6)),
    (8, 8, dict(num_layers=2, hidden_dim=384, embedding_dim=64, vocab_size=80), (19, 5)),
    (8, 8, dict(num_layers=2, hidden_dim=64, embedding_dim=16, vocab_size=24), (1, 1)),
    (4, 4, dict(num_layers=8, hidden_dim=512, embedding_dim=16, vocab_size=24), (11, 3)),
    (4, 8, dict(num_layers=2, hidden_dim=32, embedding_dim=1007, vocab_size=24), (17, 4)),
    (2, 8, dict(num_layers=2, hidden_dim=32, embedding_dim=2307, vocab_size=200), (9, 4)),
    (1, 8, dict(num_layers=2, hidden_dim=32, embedding_dim=4807, vocab_size=24), (5, 4)),
    (2, 2, dict(num_layers=8, hidden_dim=1024, embedding_dim=16, vocab_size=24), (5, 3)),
]


def _cfg(shape, dtype="float32"):
    return ModelConfig(latent_dim=8, compute_dtype=dtype, use_pallas=True, **CONFIGS[shape][2])


@pytest.mark.parametrize("shape", range(len(CONFIGS)))
def test_config_picks_its_kernel_instances(shape):
    """The tile plan picks the instances each configuration is here to
    exercise (a CPU check of the host-side plan)."""
    rpt, rows, kw, _ = CONFIGS[shape]
    cfg = _cfg(shape)
    assert fe.fused_encoder_supported(cfg) and fd.fused_train_decoder_supported(cfg)
    for mod in (fe, fd):
        R, tj, tr = tc.fwd_tile(cfg.hidden_dim, mod._fwd_smem(cfg))
        assert (tj, tr) == (min(cfg.hidden_dim, 256), 256 // min(cfg.hidden_dim, 256))
        assert R == rpt * tr
    assert tc.bwd_rows(fd._bwd_smem(cfg)) == rows
    assert tc.bwd_rows(fe._bwd_smem(cfg)) == rows


def test_gates_refuse_what_the_kernels_do_not_take():
    assert not fe.fused_encoder_supported(ModelConfig(bidirectional=True))
    assert not fe.fused_encoder_supported(ModelConfig(apply_dropout=True))
    for cfg in (ModelConfig(num_layers=9), ModelConfig(vocab_size=600)):
        assert not fe.fused_encoder_supported(cfg)
        assert not fd.fused_train_decoder_supported(cfg)
    assert fe.fused_encoder_supported(ModelConfig())
    assert fd.fused_train_decoder_supported(ModelConfig(compute_dtype="bfloat16"))


# configurations a whole-stack kernel refuses: (kwargs, encoder refuses,
# decoder refuses). The encoder then runs layer by layer through the
# sequence kernels; the decoder's whole-stack route raises on the card.
REFUSED = [
    (dict(bidirectional=True), True, False),
    (dict(apply_dropout=True, dropout=0.2), True, False),
    (dict(vocab_size=600), True, True),
    (dict(num_conditions=8000), False, True),  # E + C beyond the decoder's shared memory
]


def _route_case(kw, device):
    """(cfg, encoder params, decoder params, x, cond, z, tf_mask) on ``device``."""
    cfg = ModelConfig(latent_dim=8, hidden_dim=32, embedding_dim=16, use_pallas=True, **kw)
    g = torch.Generator().manual_seed(6)
    enc, dec = (
        {k: {n: t.to(device) for n, t in v.items()} for k, v in init(g, cfg).items()}
        for init in (init_encoder_params, init_decoder_params))
    B, L = 3, 4
    x = torch.randint(0, cfg.vocab_size, (B, L), generator=g, dtype=torch.int32).to(device)
    cond = torch.randn((B, cfg.num_conditions), generator=g).to(device)
    z = torch.randn((B, cfg.latent_dim), generator=g).to(device)
    return cfg, enc, dec, x, cond, z, torch.ones((L,), dtype=torch.bool, device=device)


@pytest.mark.parametrize("case", range(len(REFUSED)))
def test_fused_route_takes_no_scan_off_the_cpu(case, monkeypatch):
    """Off the CPU the fused route goes to the kernel wrappers even for a
    configuration they refuse: on the meta device every dispatch stops at
    the wrappers' device check rather than running the scan (on the card
    the same call raises NotImplementedError, below)."""
    kw, enc_refuses, dec_refuses = REFUSED[case]
    cfg, enc, dec, x, cond, z, tf = _route_case(kw, "meta")
    assert fe.fused_encoder_supported(cfg) != enc_refuses
    assert fd.fused_train_decoder_supported(cfg) != dec_refuses
    with pytest.raises(ValueError, match="unsupported device meta"):
        encoder_apply(enc, cfg, x, cond)
    with pytest.raises(ValueError, match="unsupported device meta"):
        decoder_apply(dec, cfg, z, cond, target_seq=x, tf_mask=tf)
    # the loss's own decoder dispatch, behind an encoder stub
    monkeypatch.setattr(complete_mod, "encoder_apply", lambda *a, **k: (z, z))
    with pytest.raises(ValueError, match="unsupported device meta"):
        complete_mod.complete_vae_loss(enc, dec, None, cfg, x, cond, z, tf)


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU or interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _setup(shape, dtype, dev):
    cfg = _cfg(shape, dtype)
    B, L = CONFIGS[shape][3]
    g = torch.Generator().manual_seed(shape)
    enc = {k: {n: t.to(dev) for n, t in v.items()}
           for k, v in init_encoder_params(g, cfg).items()}
    dec = {k: {n: t.to(dev) for n, t in v.items()}
           for k, v in init_decoder_params(g, cfg).items()}
    tok = torch.randint(0, cfg.vocab_size, (B, L), generator=g, dtype=torch.int32).to(dev)
    cond = torch.randn((B, cfg.num_conditions), generator=g).to(dev)
    h0 = (0.5 * torch.randn((B, cfg.hidden_dim), generator=g)).to(dev)
    return cfg, enc, dec, tok, cond, h0, g


def _close(got, want, dtype):
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.float(), b.float()
        assert torch.isfinite(a).all(), f"leaf {i} not finite"
        rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        assert rel <= TOL[dtype], f"leaf {i}: rel {rel:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", range(len(CONFIGS)))
def test_encoder_kernels_match_plain(dev, shape, dtype):
    cfg, enc, _, tok, _, _, g = _setup(shape, dtype, dev)
    w = tc.prepare_stack_weights(enc, cfg, with_head=False)
    before = (fe.encoder_fwd.launches, fe.encoder_bwd.launches)
    k = fe.encoder_fwd(w, tok)
    p = fe.encoder_fwd_reference(w, tok)
    torch.cuda.synchronize()
    _close(k, p, dtype)
    dh = torch.randn((tok.shape[0], cfg.hidden_dim), generator=g).to(dev)
    kb = fe.encoder_bwd(w, tok, dh, *p[1:])
    pb = fe.encoder_bwd_reference(w, tok, dh, *p[1:])
    torch.cuda.synchronize()
    _close([*kb[0], *kb[1:]], [*pb[0], *pb[1:]], dtype)
    assert (fe.encoder_fwd.launches, fe.encoder_bwd.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("with_ce", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", range(len(CONFIGS)))
def test_decoder_kernels_match_plain(dev, shape, dtype, with_ce):
    cfg, _, dec, tok, cond, h0, g = _setup(shape, dtype, dev)
    B, L = tok.shape
    w = tc.prepare_stack_weights(dec, cfg, with_head=True)
    tf = torch.ones((L,), dtype=torch.bool, device=dev)
    fwd_count = "launches" if with_ce else "logits_launches"
    before = (getattr(fd.decoder_fwd, fwd_count), fd.decoder_bwd.launches)
    k = fd.decoder_fwd(w, h0, cond, tok, tf, with_ce)
    p = fd.decoder_fwd_reference(w, h0, cond, tok, tf, with_ce)
    torch.cuda.synchronize()
    assert torch.equal(k[1], p[1])
    _close((k[0], *k[2:]), (p[0], *p[2:]), dtype)
    din = (torch.randn((B,), generator=g) if with_ce
           else torch.randn((B, L, cfg.vocab_size), generator=g)).to(dev)
    kb = fd.decoder_bwd(w, din, tok, p[1], h0, cond, *p[2:], with_ce)
    pb = fd.decoder_bwd_reference(w, din, tok, p[1], h0, cond, *p[2:], with_ce)
    torch.cuda.synchronize()
    _close([*kb[0], *kb[1:]], [*pb[0], *pb[1:]], dtype)
    assert (getattr(fd.decoder_fwd, fwd_count), fd.decoder_bwd.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [1, 2, 6, 7])
def test_bf16_weight_gradients_repeat_bit_for_bit(dev, shape):
    """The tensor-core weight-gradient pass in all three row sources (the
    embedding gathered by token, a dense input, the previous h with and
    without h_init at t = 0) and with f32 dlogits (fc_out, rounded for the
    product, summed unrounded into its bias): two runs of each backward
    give the same bits, and they match the plain versions."""
    cfg, enc, dec, tok, cond, h0, g = _setup(shape, "bfloat16", dev)
    B, L = tok.shape
    we = tc.prepare_stack_weights(enc, cfg, with_head=False)
    wd = tc.prepare_stack_weights(dec, cfg, with_head=True)
    pe = fe.encoder_fwd_reference(we, tok)
    dh = torch.randn((B, cfg.hidden_dim), generator=g).to(dev)
    tf = torch.ones((L,), dtype=torch.bool, device=dev)
    pd = fd.decoder_fwd_reference(wd, h0, cond, tok, tf, False)
    dlog = torch.randn((B, L, cfg.vocab_size), generator=g).to(dev)
    runs = {
        "encoder": (lambda: fe.encoder_bwd(we, tok, dh, *pe[1:]),
                    lambda: fe.encoder_bwd_reference(we, tok, dh, *pe[1:])),
        "decoder": (lambda: fd.decoder_bwd(wd, dlog, tok, pd[1], h0, cond, *pd[2:], False),
                    lambda: fd.decoder_bwd_reference(wd, dlog, tok, pd[1], h0, cond, *pd[2:],
                                                     False)),
    }
    for name, (kern, plain) in runs.items():
        k1, k2, p = kern(), kern(), plain()
        torch.cuda.synchronize()
        flat = [[*r[0], *r[1:]] for r in (k1, k2, p)]
        _close(flat[0], flat[2], "bfloat16")
        for a, b in zip(flat[0], flat[1]):
            assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_argmax_feedback_matches_plain(dev, dtype):
    """Teacher forcing 0.6 over a longer sequence: the fed tokens follow
    the argmax where the mask is off."""
    cfg = ModelConfig(latent_dim=8, compute_dtype=dtype, num_layers=2, hidden_dim=64,
                      embedding_dim=16, vocab_size=40)
    g = torch.Generator().manual_seed(3)
    dec = {k: {n: t.to(dev) for n, t in v.items()}
           for k, v in init_decoder_params(g, cfg).items()}
    B, L = 300, 24
    tok = torch.randint(0, cfg.vocab_size, (B, L), generator=g, dtype=torch.int32).to(dev)
    cond = torch.randn((B, 1), generator=g).to(dev)
    h0 = torch.randn((B, cfg.hidden_dim), generator=g).to(dev)
    tf = (torch.rand((L,), generator=g) < 0.6).to(dev)
    w = tc.prepare_stack_weights(dec, cfg, with_head=True)
    k = fd.decoder_fwd(w, h0, cond, tok, tf, True)
    p = fd.decoder_fwd_reference(w, h0, cond, tok, tf, True)
    torch.cuda.synchronize()
    rows = (k[1] == p[1]).all(dim=0).float().mean().item()
    assert rows >= 0.97, rows
    assert not tf.all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_on_the_card_matches_the_cpu(dev, dtype):
    """encoder_stack and decoder_train_ce through autograd on CUDA tensors
    (the kernels) against the same calls on CPU tensors (the plain
    versions): values and every gradient."""
    cfg = ModelConfig(latent_dim=8, compute_dtype=dtype, num_layers=2, hidden_dim=64,
                      embedding_dim=16, vocab_size=24, use_pallas=True)
    g = torch.Generator().manual_seed(4)
    enc, dec = init_encoder_params(g, cfg), init_decoder_params(g, cfg)
    B, L = 21, 7
    tok = torch.randint(0, cfg.vocab_size, (B, L), generator=g, dtype=torch.int32)
    cond = torch.randn((B, 1), generator=g)
    h0 = torch.randn((B, cfg.hidden_dim), generator=g)
    tf = torch.rand((L,), generator=g) < 0.8

    def run(device):
        e = {k: {n: t.to(device).requires_grad_(True) for n, t in v.items()}
             for k, v in enc.items()}
        d = {k: {n: t.to(device).requires_grad_(True) for n, t in v.items()}
             for k, v in dec.items()}
        h, c = h0.to(device).requires_grad_(True), cond.to(device).requires_grad_(True)
        feat = fe.encoder_stack(e, cfg, tok.to(device))
        ce = fd.decoder_train_ce(d, cfg, h, c, tok.to(device), tf.to(device))
        loss = (feat * feat).sum() + ce.sum()
        loss.backward()
        leaves = [feat, ce, h.grad, c.grad]
        leaves += [t.grad for tree in (e, d) for v in tree.values() for t in v.values()
                   if t.grad is not None]
        return [t.detach().cpu() for t in leaves]

    _close(run(dev), run("cpu"), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(REFUSED)))
def test_fused_route_raises_on_the_card(dev, case):
    """With use_pallas on CUDA tensors a configuration the whole-stack
    decoder refuses raises NotImplementedError from the dispatch that
    reaches it; it never runs the scan in its place. An encoder the
    whole-stack kernel refuses runs through the per-layer sequence kernels."""
    from mlx_vae_tpu_torch.ops import fused_seq_lstm as fs

    kw, enc_refuses, dec_refuses = REFUSED[case]
    cfg, enc, dec, x, cond, z, tf = _route_case(kw, dev)
    before = fs.seq_lstm_fwd.launches
    mu, _ = encoder_apply(enc, cfg, x, cond)
    torch.cuda.synchronize()
    assert torch.isfinite(mu).all()
    assert fs.seq_lstm_fwd.launches - before == \
        (cfg.num_layers * (1 + cfg.bidirectional) if enc_refuses else 0)
    if dec_refuses:
        with pytest.raises(NotImplementedError, match="fused_train_decoder"):
            decoder_apply(dec, cfg, z, cond, target_seq=x, tf_mask=tf)
        with pytest.raises(NotImplementedError, match="fused_train_decoder"):
            complete_mod.complete_vae_loss(enc, dec, None, cfg, x, cond, z, tf)
