"""The train step's CUDA kernels (fused encoder, fused training decoder:
forward and backward each; in bf16 the decoder forward's step and vocab-head
chain, each head launch also alone, and the decoder backward's head pass and
reverse chain, each also alone; and the instances of the gate pair's
forward and backward) against their plain PyTorch versions, on the card. Tests
marked ``cuda`` skip without a CUDA device. This file imports no JAX, so it
also runs on a GPU machine without it:

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
    """The decoder's tile plan picks the instances each configuration is here
    to exercise; the encoder, on the tensor cores in both dtypes (f32 as
    split-TF32), plans every configuration with its split-TF32 kernels and
    none of the CUDA-core ones, and its shared-memory rule still takes them
    all, so no route moved (a CPU check of the host-side plans)."""
    rpt, rows, kw, (B, L) = CONFIGS[shape]
    cfg = _cfg(shape)
    assert fe.fused_encoder_supported(cfg) and fd.fused_train_decoder_supported(cfg)
    R, tj, tr = tc.fwd_tile(cfg.hidden_dim, fd._fwd_smem(cfg))
    assert (tj, tr) == (min(cfg.hidden_dim, 256), 256 // min(cfg.hidden_dim, 256))
    assert R == rpt * tr
    assert tc.bwd_rows(fd._bwd_smem(cfg)) == rows
    kernels = {p["kernel"] for p in fe.encoder_launch_plan(cfg, B, L)}
    assert kernels == {"seq_fwd_tf32_kernel", "gate_kernel", "enc_step_tf32_kernel",
                       "wgrad_tf32_kernel", "demb_kernel"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", range(len(CONFIGS)))
def test_encoder_launch_plan_fits_the_card(shape, dtype):
    """Every launch of the encoder's plan fits an H100 block and grid: its
    shared memory within MAX_SMEM (in f32 the split-TF32 ring, 197,632 B),
    grid y and z within 65,535, a weight-gradient pass's partials within the
    split-reduction scratch; the forward is n * L step launches and the
    reverse chain 1 + n * L."""
    B, L = CONFIGS[shape][3]
    cfg = _cfg(shape, dtype)
    plan = fe.encoder_launch_plan(cfg, B, L)
    for p in plan:
        assert p["smem"] <= tc.MAX_SMEM, p
        x, y, z = p["grid"]
        assert x >= 1 and 1 <= y <= 65535 and 1 <= z <= 65535, p
        if p.get("splits", 1) > 1:
            assert p["splits"] * p["K"] * p["N"] <= tc.SCRATCH_ELEMS, p
    n = cfg.num_layers
    fwd = sum(p["count"] for p in plan if p["kernel"].startswith("seq_fwd"))
    rev = sum(p["count"] for p in plan if p["kernel"] in ("gate_kernel", "enc_step_kernel",
                                                          "enc_step_tf32_kernel"))
    assert (fwd, rev) == (n * L, 1 + n * L)


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
# sequence kernels, the decoder (H=32) on the scan through the gate kernel
# pair, as the JAX package routes them.
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
    """Off the CPU every route goes to its kernel wrappers, chosen from the
    config before any launch: on the meta device each dispatch stops at a
    wrapper's device check rather than running a plain version. A decoder
    the whole-stack kernels refuse reaches the gate kernel of its scan and
    never the fused decoder."""
    from mlx_vae_tpu_torch.models.decoder import train_decoder_route

    kw, enc_refuses, dec_refuses = REFUSED[case]
    cfg, enc, dec, x, cond, z, tf = _route_case(kw, "meta")
    assert fe.fused_encoder_supported(cfg) != enc_refuses
    assert fd.fused_train_decoder_supported(cfg) != dec_refuses
    assert train_decoder_route(cfg) == ("scan" if dec_refuses else "fused")
    if dec_refuses:
        def refused(*a, **k):
            raise AssertionError("the fused decoder ran on a config it refuses")
        monkeypatch.setattr(fd, "decoder_train", refused)
        monkeypatch.setattr(fd, "decoder_train_ce", refused)
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
    """With use_pallas on CUDA tensors a configuration a whole-stack kernel
    refuses never reaches that kernel: an encoder it refuses runs through
    the per-layer sequence kernels, a decoder it refuses (H=32) on the scan
    through the gate kernel pair, L * n launches each way, and the loss
    agrees with the same call on the CPU."""
    from mlx_vae_tpu_torch.ops import fused_lstm as fl
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
        fused = (fd.decoder_fwd.launches, fd.decoder_bwd.launches)
        gates = (fl.gates_fwd.launches, fl.gates_bwd.launches)
        leaves = [t.requires_grad_(True) for v in dec.values() for t in v.values()]
        loss = complete_mod.complete_vae_loss(enc, dec, None, cfg, x, cond, z, tf)["total_loss"]
        loss.backward()
        torch.cuda.synchronize()
        n = x.shape[1] * cfg.num_layers
        assert (fl.gates_fwd.launches - gates[0], fl.gates_bwd.launches - gates[1]) == (n, n)
        assert (fd.decoder_fwd.launches, fd.decoder_bwd.launches) == fused
        cpu = [{k: {m: t.detach().cpu() for m, t in v.items()} for k, v in p.items()}
               for p in (enc, dec)]
        want = complete_mod.complete_vae_loss(*cpu, None, cfg, x.cpu(), cond.cpu(), z.cpu(),
                                              tf.cpu())["total_loss"]
        _close([loss.detach().cpu()], [want], "float32")
        assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in leaves)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", range(len(CONFIGS)))
def test_encoder_bf16_forward_is_the_sequence_step_layer_by_layer(dev, shape):
    """The bf16 whole-stack forward runs the sequence forward's step kernel
    layer by layer, gathering layer 0's input rows by token and addressing
    the residuals at rows t * n + l: its residuals and h_last equal, bit for
    bit, per-layer sequence forwards on dense inputs (the embedded tokens,
    then the layer below's h) from zero state, tokens outside [0, V)
    included; a second run repeats the first bit for bit."""
    from mlx_vae_tpu_torch.ops import fused_seq_lstm as fs

    cfg, enc, _, tok, _, _, _ = _setup(shape, "bfloat16", dev)
    B, L = tok.shape
    tok = tok.clone()
    tok[0, 0] = -1
    if B > 1 and L > 1:
        tok[1, 1] = cfg.vocab_size
    w = tc.prepare_stack_weights(enc, cfg, with_head=False)
    before = (fe.encoder_fwd.launches, fs.seq_lstm_fwd.launches)
    k1 = fe.encoder_fwd(w, tok)
    k2 = fe.encoder_fwd(w, tok)
    H, n = cfg.hidden_dim, cfg.num_layers
    zero = torch.zeros((B, H), device=dev)
    x = tc.embed_rows(w.emb, tok.T).contiguous()
    for l in range(n):
        hs, cs, gs, hf, _ = fs.seq_lstm_fwd(w.layers[l], w.bias[l].contiguous(), x, zero, zero)
        for a, b in zip((hs, cs, gs), k1[1:]):
            assert torch.equal(a, b[:, l])
        x = hs
    torch.cuda.synchronize()
    assert torch.equal(hf, k1[0])
    for a, b in zip(k1, k2):
        assert torch.equal(a, b)
    assert (fe.encoder_fwd.launches, fs.seq_lstm_fwd.launches) == (before[0] + 2, before[1] + n)


def _device_kernels(fn) -> list:
    """Names of the kernels that ``fn`` ran on the card (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", range(len(CONFIGS)))
def test_encoder_bf16_reverse_chain_matches_plain(dev, shape):
    """The bf16 reverse chain alone (the gate kernel, then one tensor-core
    product per (step, layer) with the gate step in its epilogue): dgates and
    dx0 against encoder_reverse_reference on the same residuals, over
    ragged batches, E from 16 to 4807 (tiles that straddle the input and h
    columns) and H = 100; a second run repeats the first bit for bit."""
    cfg, enc, _, tok, _, _, g = _setup(shape, "bfloat16", dev)
    w = tc.prepare_stack_weights(enc, cfg, with_head=False)
    _, hs, cs, gs = fe.encoder_fwd_reference(w, tok)
    dh = torch.randn((tok.shape[0], cfg.hidden_dim), generator=g).to(dev)
    lib = fe.build_library()
    st = tc.stream_of(dev)
    k1 = fe.launch_encoder_bwd(lib, w, tok, dh, hs, cs, gs, st, with_reverse=True)
    k2 = fe.launch_encoder_bwd(lib, w, tok, dh, hs, cs, gs, st, with_reverse=True)
    want = fe.encoder_reverse_reference(w, dh, hs, cs, gs)
    torch.cuda.synchronize()
    _close(k1[3:], want, "bfloat16")
    for a, b in zip([*k1[0], *k1[1:]], [*k2[0], *k2[1:]]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_backward_routes_by_dtype(dev, dtype):
    """Both dtypes run the reverse chain as 1 + n * L launches of
    hand-written kernels (train::gate_kernel once, then one tensor-core step
    kernel per (step, layer): enc_step_kernel in bf16, the split-TF32
    enc_step_tf32_kernel in f32) and the weight gradient as 2n tensor-core
    passes (wgrad_wgmma_kernel, wgrad_tf32_kernel); no CUDA-core
    enc_bwd_kernel or wgrad_f32_kernel."""
    import re

    cfg, enc, _, tok, _, _, g = _setup(2, dtype, dev)
    w = tc.prepare_stack_weights(enc, cfg, with_head=False)
    p = fe.encoder_fwd_reference(w, tok)
    dh = torch.randn((tok.shape[0], cfg.hidden_dim), generator=g).to(dev)
    names = _device_kernels(lambda: fe.encoder_bwd(w, tok, dh, *p[1:]))
    bf16 = dtype == "bfloat16"
    step = "enc_step_kernel" if bf16 else "enc_step_tf32_kernel"
    wgrad = "wgrad_wgmma_kernel" if bf16 else "wgrad_tf32_kernel"
    count = {k: sum(bool(re.search(rf"\b{k}\b", n)) for n in names)
             for k in ("gate_kernel", step, wgrad, "enc_bwd_kernel", "wgrad_f32_kernel")}
    L, n = tok.shape[1], cfg.num_layers
    want = {"gate_kernel": 1, step: n * L, wgrad: 2 * n, "enc_bwd_kernel": 0,
            "wgrad_f32_kernel": 0}
    assert count == want, names


@pytest.mark.cuda
@pytest.mark.parametrize("shape", range(len(CONFIGS)))
def test_encoder_f32_forward_is_the_split_step_layer_by_layer(dev, shape):
    """The f32 whole-stack forward (n * L launches of the split-TF32 step
    kernel, layer 0 gathering embedding rows by token, tokens outside [0, V)
    included) against its step twin composed layer by layer
    (encoder_fwd_steps_reference with split_tf32) within 1e-4; a second run
    repeats the first bit for bit."""
    cfg, enc, _, tok, _, _, _ = _setup(shape, "float32", dev)
    B, L = tok.shape
    tok = tok.clone()
    tok[0, 0] = -1
    if B > 1 and L > 1:
        tok[1, 1] = cfg.vocab_size
    w = tc.prepare_stack_weights(enc, cfg, with_head=False)
    before = fe.encoder_fwd.launches
    k1 = fe.encoder_fwd(w, tok)
    k2 = fe.encoder_fwd(w, tok)
    want = fe.encoder_fwd_steps_reference(w, tok, split_tf32=True)
    torch.cuda.synchronize()
    _close(k1, want, "float32")
    for a, b in zip(k1, k2):
        assert torch.equal(a, b)
    assert fe.encoder_fwd.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", range(len(CONFIGS)))
def test_encoder_f32_reverse_chain_matches_plain(dev, shape):
    """The f32 reverse chain alone (the gate kernel, then one split-TF32
    product per (step, layer) with the gate step in its epilogue): dgates
    and dx0 against encoder_reverse_reference on the same residuals within
    1e-4, over ragged batches, E from 16 to 4807 (tiles that straddle the
    input and h columns) and H = 100; a second run repeats the first bit for
    bit (dW, db, demb too)."""
    cfg, enc, _, tok, _, _, g = _setup(shape, "float32", dev)
    w = tc.prepare_stack_weights(enc, cfg, with_head=False)
    _, hs, cs, gs = fe.encoder_fwd_reference(w, tok)
    dh = torch.randn((tok.shape[0], cfg.hidden_dim), generator=g).to(dev)
    lib = fe.build_library()
    st = tc.stream_of(dev)
    k1 = fe.launch_encoder_bwd(lib, w, tok, dh, hs, cs, gs, st, with_reverse=True)
    k2 = fe.launch_encoder_bwd(lib, w, tok, dh, hs, cs, gs, st, with_reverse=True)
    want = fe.encoder_reverse_reference(w, dh, hs, cs, gs)
    torch.cuda.synchronize()
    _close(k1[3:], want, "float32")
    for a, b in zip([*k1[0], *k1[1:]], [*k2[0], *k2[1:]]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [1, 2, 6, 7])
def test_f32_weight_gradients_repeat_bit_for_bit(dev, shape):
    """The split-TF32 weight-gradient pass (every f32 backward's) in its row
    sources: the encoder's (the embedding gathered by token, the layer
    below's h, the previous h from zero state), the decoder's (its fed token,
    the conditions, h_init at t = 0, f32 dlogits for fc_out) and the
    sequence backward's (a dense input, h0 at t = 0), with widths not a
    multiple of 4 among them (C = 3, E = 20, H = 100): two runs of each
    backward give the same bits and match the plain versions within 1e-4."""
    from mlx_vae_tpu_torch.ops import fused_seq_lstm as fs

    cfg, enc, dec, tok, cond, h0, g = _setup(shape, "float32", dev)
    B, L = tok.shape
    E, H = cfg.embedding_dim, cfg.hidden_dim
    we = tc.prepare_stack_weights(enc, cfg, with_head=False)
    wd = tc.prepare_stack_weights(dec, cfg, with_head=True)
    pe = fe.encoder_fwd_reference(we, tok)
    dh = torch.randn((B, H), generator=g).to(dev)
    tf = torch.ones((L,), dtype=torch.bool, device=dev)
    pd = fd.decoder_fwd_reference(wd, h0, cond, tok, tf, False)
    dlog = torch.randn((B, L, cfg.vocab_size), generator=g).to(dev)
    xs = torch.randn((L, B, E), generator=g).to(dev)
    wl, bl = we.layers[0].contiguous(), we.bias[0].contiguous()  # [E + H, 4H]
    c0 = (0.3 * torch.randn((B, H), generator=g)).to(dev)
    ps = fs.seq_lstm_fwd_reference(wl, bl, xs, h0, c0)
    dhs = torch.randn((L, B, H), generator=g).to(dev)
    dhf, dcf = (torch.randn((B, H), generator=g).to(dev) for _ in range(2))
    runs = {
        "encoder": (lambda: fe.encoder_bwd(we, tok, dh, *pe[1:]),
                    lambda: fe.encoder_bwd_reference(we, tok, dh, *pe[1:])),
        "decoder": (lambda: fd.decoder_bwd(wd, dlog, tok, pd[1], h0, cond, *pd[2:], False),
                    lambda: fd.decoder_bwd_reference(wd, dlog, tok, pd[1], h0, cond, *pd[2:],
                                                     False)),
        "sequence": (lambda: [fs.seq_lstm_bwd_tm(wl, xs, h0, c0, *ps[:3], dhs, dhf, dcf)],
                     lambda: [fs.seq_lstm_bwd_reference(wl, xs, h0, c0, *ps[:3], dhs, dhf,
                                                        dcf)]),
    }
    for name, (kern, plain) in runs.items():
        k1, k2, p = kern(), kern(), plain()
        torch.cuda.synchronize()
        flat = [[*r[0], *r[1:]] for r in (k1, k2, p)]
        _close(flat[0], flat[2], "float32")
        for a, b in zip(flat[0], flat[1]):
            assert torch.equal(a, b), name


# the bf16 decoder forward's chain: (n, E, C, H, V, B, L) over one row, ragged
# batches, ragged E, C, H and V, and vocabularies of 1, 3 and 4 column tiles
DEC_FWD = [
    (1, 16, 1, 32, 80, 1, 5),
    (2, 20, 3, 100, 200, 37, 6),
    (3, 129, 1, 100, 80, 300, 4),
    (2, 129, 3, 32, 300, 129, 3),
    (2, 128, 1, 256, 80, 1000, 4),
    (1, 16, 5, 1024, 512, 130, 2),
]


def _dec_case(case, dtype, dev):
    n, E, C, H, V, B, L = DEC_FWD[case]
    cfg = ModelConfig(latent_dim=8, compute_dtype=dtype, num_layers=n, hidden_dim=H,
                      embedding_dim=E, num_conditions=C, vocab_size=V, use_pallas=True)
    g = torch.Generator().manual_seed(case)
    dec = {k: {m: t.to(dev) for m, t in v.items()} for k, v in init_decoder_params(g, cfg).items()}
    tok = torch.randint(0, V, (B, L), generator=g, dtype=torch.int32)
    for j, bad in enumerate((-1, V, 999)):  # no CE term; a zero embedding row where fed
        tok[(7 * j) % B, j % L] = bad
    cond = torch.randn((B, C), generator=g).to(dev)
    h0 = (0.5 * torch.randn((B, H), generator=g)).to(dev)
    return cfg, tc.prepare_stack_weights(dec, cfg, with_head=True), tok.to(dev), cond, h0


@pytest.mark.cuda
@pytest.mark.parametrize("with_ce", [True, False])
@pytest.mark.parametrize("case", range(len(DEC_FWD)))
def test_decoder_bf16_forward_chain_matches_plain(dev, case, with_ce):
    """The bf16 forward (n * L tensor-core step launches and L vocab-head
    launches) against its plain twin, teacher forcing all on: the same fed
    tokens, every output within 2e-2; a second call equals the first bit for
    bit."""
    cfg, w, tok, cond, h0 = _dec_case(case, "bfloat16", dev)
    L = tok.shape[1]
    tf = torch.ones((L,), dtype=torch.bool, device=dev)
    k1 = fd.decoder_fwd(w, h0, cond, tok, tf, with_ce)
    k2 = fd.decoder_fwd(w, h0, cond, tok, tf, with_ce)
    p = fd.decoder_fwd_reference(w, h0, cond, tok, tf, with_ce)
    torch.cuda.synchronize()
    assert torch.equal(k1[1], p[1])
    _close((k1[0], *k1[2:]), (p[0], *p[2:]), "bfloat16")
    for a, b in zip(k1, k2):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("with_ce", [True, False])
@pytest.mark.parametrize("case", range(len(DEC_FWD)))
def test_decoder_head_kernel_matches_plain(dev, case, with_ce):
    """One dec_head_kernel launch at every step, alone, on the plain
    forward's residuals against decoder_head_step_reference on the same
    inputs (targets outside [0, V) included): both read the same rounded
    operands, so each step's CE term (from zero) or logits is within 1e-4;
    under teacher forcing 0.5, forced next tokens equal the target and
    argmax-fed ones agree on >= 99.0% of rows at every step."""
    cfg, w, tok, cond, h0 = _dec_case(case, "bfloat16", dev)
    B, L = tok.shape
    g = torch.Generator().manual_seed(case + 100)
    tf = (torch.rand((L,), generator=g) < 0.5).to(dev)
    _, toks, hs, _, _ = fd.decoder_fwd_reference(w, h0, cond, tok, tf, with_ce)
    lib, st = fd.build_library(), tc.stream_of(dev)
    out_shape = (B,) if with_ce else (B, L, cfg.vocab_size)
    k_out = torch.randn(out_shape, generator=g).to(dev)
    p_out = k_out.clone()
    k_toks, p_toks = toks.clone(), toks.clone()
    tf_i = tf.to(torch.int32)
    for t in range(L):
        if with_ce:
            k_out.zero_()
            p_out.zero_()
        fd.launch_decoder_head(lib, w, t, hs, tok, tf_i, k_toks, k_out, with_ce, st)
        fd.decoder_head_step_reference(w, t, hs, tok, tf, p_toks, p_out, with_ce)
        torch.cuda.synchronize()
        got, want = (k_out, p_out) if with_ce else (k_out[:, t], p_out[:, t])
        assert torch.isfinite(got).all(), t
        rel = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
        assert rel <= 1e-4, (t, rel)
        if t + 1 < L:
            if tf[t]:
                assert torch.equal(k_toks[t + 1], tok[:, t]), t
            else:
                assert (k_toks[t + 1] == p_toks[t + 1]).float().mean().item() >= 0.99, t


@pytest.mark.cuda
@pytest.mark.parametrize("with_ce", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_forward_routes_by_dtype(dev, dtype, with_ce):
    """bf16: one set-up launch, then n * L launches of the tensor-core step
    kernel (train_common.cuh:seq_fwd_step_kernel) and L of dec_head_kernel,
    and no dec_fwd_kernel; f32 still runs the CUDA-core dec_fwd_kernel, once."""
    import re

    cfg, w, tok, cond, h0 = _dec_case(2, dtype, dev)
    L, n = tok.shape[1], cfg.num_layers
    tf = torch.ones((L,), dtype=torch.bool, device=dev)
    names = _device_kernels(lambda: fd.decoder_fwd(w, h0, cond, tok, tf, with_ce))
    kernels = ("dec_init_kernel", "seq_fwd_step_kernel", "dec_head_kernel", "dec_fwd_kernel")
    count = {k: sum(bool(re.search(rf"\b{k}\b", m)) for m in names) for k in kernels}
    want = (dict(zip(kernels, (1, n * L, L, 0))) if dtype == "bfloat16" else
            dict(zip(kernels, (0, 0, 0, 1))))
    assert count == want, names


def _dec_bwd_inputs(case, with_ce, dev):
    """A DEC_FWD case's plain forward residuals (teacher forcing all on) and
    a backward cotangent: (cfg, w, tok, cond, h0, (toks, hs, cs, gs), din)."""
    cfg, w, tok, cond, h0 = _dec_case(case, "bfloat16", dev)
    B, L = tok.shape
    tf = torch.ones((L,), dtype=torch.bool, device=dev)
    res = fd.decoder_fwd_reference(w, h0, cond, tok, tf, with_ce)[1:]
    g = torch.Generator().manual_seed(case + 200)
    din = (torch.randn((B,), generator=g) if with_ce
           else torch.randn((B, L, cfg.vocab_size), generator=g)).to(dev)
    return cfg, w, tok, cond, h0, res, din


@pytest.mark.cuda
@pytest.mark.parametrize("with_ce", [True, False])
@pytest.mark.parametrize("case", range(len(DEC_FWD)))
def test_decoder_bf16_reverse_chain_matches_plain(dev, case, with_ce):
    """The bf16 backward's reverse alone (the head pass, the gate kernel, one
    tensor-core product per (step, layer) with the gate step in its epilogue,
    the d(h_init) sum): dgates, dx0, dlog, d(h_init) and d(cond) against
    decoder_reverse_steps_reference on the same residuals within 2e-2, over
    one row, ragged batches, ragged E, C, H and V, tiles that straddle E,
    E + C and K_l, and targets outside [0, V); a second run repeats the first
    bit for bit, gradient sums included."""
    _, w, tok, cond, h0, (toks, hs, cs, gs), din = _dec_bwd_inputs(case, with_ce, dev)
    lib, st = fd.build_library(), tc.stream_of(dev)
    run = lambda: fd.launch_decoder_bwd(lib, w, din, tok, toks, h0, cond, hs, cs, gs,  # noqa: E731
                                        with_ce, st, with_reverse=True)
    k1, k2 = run(), run()
    want = fd.decoder_reverse_steps_reference(w, din, tok, hs, cs, gs, with_ce)
    torch.cuda.synchronize()
    _close(k1[7:], want, "bfloat16")
    for a, b in zip([*k1[0], *k1[1:]], [*k2[0], *k2[1:]]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("with_ce", [True, False])
@pytest.mark.parametrize("case", range(len(DEC_FWD)))
def test_decoder_head_bwd_matches_plain(dev, case, with_ce):
    """The bf16 backward's head pass alone (dec_head_bwd_kernel, then
    dec_dtop_kernel) against decoder_head_bwd_reference on the same stored
    h: both read the same rounded operands, so dlog and dtop are within 1e-4
    of their largest magnitude, over vocabularies of 1, 3 and 4 column tiles
    and targets outside [0, V)."""
    _, w, tok, _, _, (_, hs, _, _), din = _dec_bwd_inputs(case, with_ce, dev)
    lib, st = fd.build_library(), tc.stream_of(dev)
    got = fd.launch_decoder_head_bwd(lib, w, din, tok, hs, with_ce, st)
    want = fd.decoder_head_bwd_reference(w, din, tok, hs, with_ce)
    torch.cuda.synchronize()
    for name, a, b in zip(("dlog", "dtop"), got, want):
        assert torch.isfinite(a).all(), name
        rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        assert rel <= 1e-4, (name, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_backward_routes_by_dtype(dev, dtype):
    """bf16: the head pass (dec_head_bwd_kernel, dec_dtop_kernel), then
    train::gate_kernel once and dec_step_kernel per (step, layer), and no
    dec_bwd_kernel; f32 still runs the CUDA-core dec_bwd_kernel, once."""
    import re

    cfg, w, tok, cond, h0 = _dec_case(2, dtype, dev)
    B, L = tok.shape
    n = cfg.num_layers
    p = fd.decoder_fwd_reference(w, h0, cond, tok, torch.ones((L,), dtype=torch.bool,
                                                                device=dev), True)
    dce = torch.randn((B,), device=dev)
    names = _device_kernels(lambda: fd.decoder_bwd(w, dce, tok, p[1], h0, cond, *p[2:], True))
    kernels = ("dec_head_bwd_kernel", "dec_dtop_kernel", "gate_kernel", "dec_step_kernel",
               "dec_bwd_kernel")
    count = {k: sum(bool(re.search(rf"\b{k}\b", m)) for m in names) for k in kernels}
    want = (dict(zip(kernels, (1, 1, 1, n * L, 0))) if dtype == "bfloat16" else
            dict(zip(kernels, (0, 0, 0, 0, 1))))
    assert count == want, names


# (H, offset in floats of the gates' view, units a thread): the gate pair's
# backward on its vector instance (H % 4 == 0, every pointer 16-byte
# aligned) and its scalar one (odd or ragged H, and a view that breaks the
# gates' 16-byte alignment)
GATES_BWD = [(256, 0, 4), (1024, 0, 4), (1, 0, 1), (3, 0, 1), (102, 0, 1), (256, 1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(GATES_BWD)))
def test_gates_bwd_vector_and_scalar_paths(dev, case):
    """gates_bwd against gates_bwd_reference within 1e-5 of each output's
    largest magnitude, on the instance the profiler names
    (gates_bwd_kernel<4> or <1>)."""
    import re

    from mlx_vae_tpu_torch.ops import fused_lstm as fl

    H, off, units = GATES_BWD[case]
    B = 37
    g = torch.Generator().manual_seed(case)
    flat = (3 * torch.randn((off + B * 4 * H,), generator=g)).to(dev)
    gates = flat[off:].view(B, 4 * H)
    c, dh, dc = ((3 * torch.randn((B, H), generator=g)).to(dev) for _ in range(3))
    got = []
    names = _device_kernels(lambda: got.extend(fl.gates_bwd(gates, c, dh, dc)))
    want = fl.gates_bwd_reference(gates, c, dh, dc)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-5 * max(b.abs().max().item(), 1e-30)
    ran = [m for m in names if re.search(r"\bgates_bwd_kernel\b", m)]
    assert len(ran) == 1 and f"gates_bwd_kernel<{units}>" in ran[0], names


# (B, H, offset in floats of the gates' view, units a thread): the gate
# pair's forward on its vector instance (H % 4 == 0, every pointer 16-byte
# aligned) and its scalar one (odd or ragged H, a view one float off the
# gates' 16-byte alignment), from one row to a ragged row count
GATES_FWD = [(4096, 256, 0, 4), (37, 1024, 0, 4), (1, 256, 0, 4), (1, 3, 0, 1), (37, 102, 0, 1),
             (37, 256, 1, 1), (5, 1, 0, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(GATES_FWD)))
def test_gates_fwd_vector_and_scalar_paths(dev, case):
    """gates_fwd against gates_fwd_reference within 1e-5 of each output's
    largest magnitude, on the instance the profiler names
    (gates_fwd_kernel<4, 1> or <1, 1>)."""
    import re

    from mlx_vae_tpu_torch.ops import fused_lstm as fl

    B, H, off, units = GATES_FWD[case]
    g = torch.Generator().manual_seed(case)
    flat = (3 * torch.randn((off + B * 4 * H,), generator=g)).to(dev)
    gates = flat[off:].view(B, 4 * H)
    c = (3 * torch.randn((B, H), generator=g)).to(dev)
    got = []
    names = _device_kernels(lambda: got.extend(fl.gates_fwd(gates, c)))
    want = fl.gates_fwd_reference(gates, c)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-5 * max(b.abs().max().item(), 1e-30)
    ran = [m for m in names if re.search(r"\bgates_fwd_kernel\b", m)]
    assert len(ran) == 1 and f"gates_fwd_kernel<{units}, 1>" in ran[0], names
