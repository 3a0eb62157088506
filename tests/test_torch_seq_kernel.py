"""The per-layer sequence LSTM kernels and the LSTM gate kernels against
their plain PyTorch versions, on the card, and the routes that reach them.
Tests marked ``cuda`` skip without a CUDA device. This file imports no JAX,
so it also runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_seq_kernel.py -q

Yardstick: max |kernel - plain| / max |plain| per output or gradient leaf,
within 1e-4 in float32 (the two sum in different orders) and 2e-2 in
bfloat16 (a different summation order can move a stored residual or a
rounded gate cotangent by one bf16 ulp, ~4e-3 of the value). Each backward
kernel gets the plain forward's residuals, as its plain twin does.

Both dtypes run the sequence kernels on the tensor cores (bf16 on bf16
operands, f32 as split-TF32). The shapes cover widths from 32 to 8192 and
inputs to 5000 (the f32 support rule's shared-memory plans, kept from the
CUDA-core kernels, are checked on the CPU), unaligned widths, ragged
batches, one row of one step, residuals addressed inside layer-stacked
arrays, and operands that start off a 16-byte boundary.
"""

import pytest
import torch

from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.models.decoder import init_decoder_params
from mlx_vae_tpu_torch.ops import decoder_cv as dcv
from mlx_vae_tpu_torch.ops import fused_lstm as fl
from mlx_vae_tpu_torch.ops import fused_seq_lstm as fs
from mlx_vae_tpu_torch.ops import train_common as tc

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (the f32 support rule's forward rows per thread and reverse rows per
# block, I, H, B, L)
SEQ = [
    (8, 8, 128, 128, 37, 7),
    (8, 8, 129, 256, 19, 5),
    (8, 8, 100, 100, 33, 6),
    (8, 8, 1024, 1024, 20, 3),
    (8, 8, 2048, 1024, 9, 2),
    (8, 4, 64, 2048, 11, 3),
    (4, 4, 2000, 2048, 6, 3),
    (4, 8, 3000, 64, 7, 4),
    (2, 8, 3000, 32, 5, 3),
    (1, 8, 5000, 32, 5, 3),
    (4, 2, 16, 4096, 3, 2),
    (2, 1, 16, 8192, 2, 2),
    (8, 8, 128, 128, 1, 1),
]


@pytest.mark.parametrize("case", range(len(SEQ)))
def test_tile_plan_picks_its_instances(case):
    """A CPU check of the f32 support rule's shared-memory plans (those of
    the CUDA-core kernels that ran f32 before the split-TF32 ones, kept so
    that no route moves)."""
    rpt, rows, I, H, _, _ = SEQ[case]
    R, tj, tr = tc.fwd_tile(H, fs._fwd_smem(I, H))
    assert (tj, tr, R) == (min(H, 256), 256 // min(H, 256), rpt * (256 // min(H, 256)))
    assert tc.bwd_rows(fs._bwd_smem(H)) == rows
    assert fs.fused_seq_supported(I, H, torch.bfloat16)


# (I, H, f32 reverse rows per block or None where one row does not fit)
BWD_PLAN = [(128, 64, 8), (129, 200, 8), (1024, 1024, 8), (64, 2048, 4), (16, 4096, 2),
            (16, 8192, 1), (16, 9000, None)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(BWD_PLAN)))
def test_bwd_plan_and_support(case, dtype):
    """A CPU check of the backward's support rule: f32 where one row's
    reverse state fits a block's shared memory (the CUDA-core plan the rule
    keeps), bf16 (per-step GEMMs through a fixed shared-memory ring) at any
    width."""
    I, H, rows = BWD_PLAN[case]
    if dtype == "bfloat16":
        assert fs.bwd_plan(H, torch.bfloat16) == 0
        assert fs.fused_seq_supported(I, H, torch.bfloat16)
    else:
        assert fs.bwd_plan(H, torch.float32) == rows
        assert fs.fused_seq_supported(I, H, torch.float32) == (rows is not None)


# (I, H): bf16 takes any width (the forward's and the backward's per-step
# GEMMs go through a fixed shared-memory ring); f32 only where the support
# rule's row of forward state and row of reverse state fit a block's shared
# memory
WIDE = [(50000, 8192), (16, 9000), (129, 100), (1024, 1024)]


@pytest.mark.parametrize("case", range(len(WIDE)))
def test_bf16_forward_takes_any_width(case):
    """A CPU check of the forward's support rule and of the step kernel's
    plan at each width."""
    I, H = WIDE[case]
    assert fs.fused_seq_supported(I, H, torch.bfloat16)
    f32_fits = (tc.fwd_tile(H, fs._fwd_smem(I, H)) is not None
                and fs.bwd_plan(H, torch.float32) is not None)
    assert fs.fused_seq_supported(I, H, torch.float32) == f32_fits
    ixp, kp, np_ = tc.fwd_step_plan(I, H)
    assert (ixp % 64, kp % 64, np_ % 128) == (0, 0, 0)
    assert I <= ixp < I + 64 and H <= kp - ixp < H + 64 and 4 * H <= np_ < 4 * H + 128


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU or interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.float(), b.float()
        assert torch.isfinite(a).all(), f"leaf {i} not finite"
        rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        assert rel <= TOL[dtype], f"leaf {i}: rel {rel:.3e}"


def _seq_inputs(I, H, B, L, dtype, dev, stride=1, seed=0):
    g = torch.Generator().manual_seed(seed)
    wdt = DT[dtype]
    s = 1.0 / H ** 0.5
    wcat = ((torch.rand((I + H, 4 * H), generator=g) * 2 - 1) * s).to(wdt).to(dev)
    bias = ((torch.rand((4 * H,), generator=g) * 2 - 1) * s).to(dev)
    xs = torch.randn((L * stride, B, I), generator=g).to(wdt).to(dev)
    h0, c0 = (0.3 * torch.randn((B, H), generator=g)).to(dev), \
        (0.3 * torch.randn((B, H), generator=g)).to(dev)
    cot = [torch.randn(s_, generator=g).to(dev) for s_ in ((L, B, H), (B, H), (B, H))]
    return wcat, bias, xs, h0, c0, cot


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(SEQ)))
def test_seq_kernels_match_plain(dev, case, dtype):
    _, _, I, H, B, L = SEQ[case]
    wcat, bias, xs, h0, c0, (dhs, dhf, dcf) = _seq_inputs(I, H, B, L, dtype, dev)
    before = (fs.seq_lstm_fwd.launches, fs.seq_lstm_bwd_tm.launches)
    k = fs.seq_lstm_fwd(wcat, bias, xs, h0, c0)
    p = fs.seq_lstm_fwd_reference(wcat, bias, xs, h0, c0)
    torch.cuda.synchronize()
    _close(k, p, dtype)
    kb = fs.seq_lstm_bwd_tm(wcat, xs, h0, c0, *p[:3], dhs, dhf, dcf)
    pb = fs.seq_lstm_bwd_reference(wcat, xs, h0, c0, *p[:3], dhs, dhf, dcf)
    torch.cuda.synchronize()
    _close(kb, pb, dtype)
    assert (fs.seq_lstm_fwd.launches, fs.seq_lstm_bwd_tm.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offsets", [(0, 0), (1, 2), (2, 1)])
def test_seq_bwd_strided_matches_dense(dev, dtype, offsets):
    """Residuals and inputs as rows of [L*3, B, .] arrays give the dense
    call's results bit for bit."""
    ro, xo = offsets
    I, H, B, L = 96, 128, 21, 5
    wcat, bias, xs3, h0, c0, (dhs, dhf, dcf) = _seq_inputs(I, H, B, L, dtype, dev, stride=3)
    xs = xs3[xo::3].contiguous()
    hs, cs, gs, _, _ = fs.seq_lstm_fwd(wcat, bias, xs, h0, c0)
    stk = []
    for a in (hs, cs, gs):
        big = torch.randn((L * 3,) + tuple(a.shape[1:]), device=dev).to(a.dtype)
        big[ro::3] = a
        stk.append(big)
    dense = fs.seq_lstm_bwd_tm(wcat, xs, h0, c0, hs, cs, gs, dhs, dhf, dcf)
    strided = fs.seq_lstm_bwd_tm(wcat, xs3, h0, c0, *stk, dhs, dhf, dcf, res_stride=3,
                                 res_offset=ro, xs_stride=3, xs_offset=xo)
    torch.cuda.synchronize()
    for a, b in zip(strided, dense):
        assert torch.equal(a, b)


# the bf16 backward's ragged edges: I = 129 (the scaled decoder's layer 0:
# unaligned input rows), I = H; B not a multiple of the 128-row tile; H = 200
# (4H not a multiple of the 64-deep stage); odd H (no row 16-byte aligned)
WGMMA_BWD = [(I, H, B) for H in (64, 200) for I in (128, 129, H) for B in (1000, 2048)]
WGMMA_BWD.append((33, 37, 19))


@pytest.mark.cuda
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("case", range(len(WGMMA_BWD)))
def test_seq_bwd_bf16_matches_plain(dev, case, strided):
    """The tensor-core backward against its plain version on every output
    and gradient leaf, dense and with residuals and inputs addressed inside
    layer-stacked arrays; two runs agree bit for bit."""
    I, H, B = WGMMA_BWD[case]
    L = 4
    rs, ro, xst, xo = (3, 1, 2, 1) if strided else (1, 0, 1, 0)
    wcat, bias, xs, h0, c0, (dhs, dhf, dcf) = _seq_inputs(I, H, B, L, "bfloat16", dev,
                                                          stride=xst, seed=case)
    res = fs.seq_lstm_fwd_reference(wcat, bias, xs[xo::xst].contiguous(), h0, c0)[:3]
    if strided:
        stk = []
        for a in res:
            big = torch.randn((L * rs,) + tuple(a.shape[1:]), device=dev).to(a.dtype)
            big[ro::rs] = a
            stk.append(big)
        res = stk
    kw = dict(res_stride=rs, res_offset=ro, xs_stride=xst, xs_offset=xo)
    before = fs.seq_lstm_bwd_tm.launches
    k1 = fs.seq_lstm_bwd_tm(wcat, xs, h0, c0, *res, dhs, dhf, dcf, **kw)
    k2 = fs.seq_lstm_bwd_tm(wcat, xs, h0, c0, *res, dhs, dhf, dcf, **kw)
    p = fs.seq_lstm_bwd_reference(wcat, xs, h0, c0, *res, dhs, dhf, dcf, **kw)
    torch.cuda.synchronize()
    assert fs.seq_lstm_bwd_tm.launches == before + 2
    _close(k1, p, "bfloat16")
    for a, b in zip(k1, k2):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("case", range(len(WGMMA_BWD)))
def test_seq_f32_matches_plain_and_repeats(dev, case, strided):
    """The split-TF32 forward and backward against their plain f32 versions
    on every output and gradient leaf, dense and with residuals and inputs
    addressed inside layer-stacked arrays (the backward at residual stride
    3 offset 1, input stride 2 offset 1; the forward's input at stride 2
    offset 1); two runs of each agree bit for bit (one writer per element,
    sums in a fixed order)."""
    I, H, B = WGMMA_BWD[case]
    L = 4
    rs, ro, xst, xo = (3, 1, 2, 1) if strided else (1, 0, 1, 0)
    wcat, bias, xs, h0, c0, (dhs, dhf, dcf) = _seq_inputs(I, H, B, L, "float32", dev,
                                                          stride=xst, seed=case)
    fkw = dict(xs_stride=xst, xs_offset=xo)
    f1 = fs.seq_lstm_fwd(wcat, bias, xs, h0, c0, **fkw)
    f2 = fs.seq_lstm_fwd(wcat, bias, xs, h0, c0, **fkw)
    res = fs.seq_lstm_fwd_reference(wcat, bias, xs, h0, c0, **fkw)
    torch.cuda.synchronize()
    _close(f1, res, "float32")
    for a, b in zip(f1, f2):
        assert torch.equal(a, b)
    res = res[:3]
    if strided:
        stk = []
        for a in res:
            big = torch.randn((L * rs,) + tuple(a.shape[1:]), device=dev)
            big[ro::rs] = a
            stk.append(big)
        res = stk
    kw = dict(res_stride=rs, res_offset=ro, xs_stride=xst, xs_offset=xo)
    k1 = fs.seq_lstm_bwd_tm(wcat, xs, h0, c0, *res, dhs, dhf, dcf, **kw)
    k2 = fs.seq_lstm_bwd_tm(wcat, xs, h0, c0, *res, dhs, dhf, dcf, **kw)
    p = fs.seq_lstm_bwd_reference(wcat, xs, h0, c0, *res, dhs, dhf, dcf, **kw)
    torch.cuda.synchronize()
    _close(k1, p, "float32")
    for a, b in zip(k1, k2):
        assert torch.equal(a, b)


def _kernel_counts(fn, names) -> dict:
    """How many launches of each kernel in ``names`` ``fn`` made on the
    card (torch.profiler), after a warm-up call. A trace in which CUPTI
    recorded no device event at all is taken again, up to 3 traces (as
    ``chip_smoke.py``'s profiles are)."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # CUPTI can drop a kernel launched as the profiler starts (the f32
            # backward's first launch is its gate_kernel): a first kernel and a
            # synchronize open the window before fn's launches
            torch.ones(1, device="cuda")
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        ran = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if ran:
            break
    return {k: sum(bool(re.search(rf"\b{k}\b", n)) for n in ran) for k in names}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seq_kernels_route_by_dtype(dev, dtype):
    """The forward is L launches of the step kernel (seq_fwd_tf32_kernel in
    f32, seq_fwd_step_kernel in bf16); the backward one gate_kernel, L step
    launches (seq_step_tf32_kernel, seq_step_kernel) and the weight-gradient
    passes (wgrad_tf32_kernel, wgrad_wgmma_kernel), one for the input rows
    and one for the recurrent rows; no CUDA-core seq_fwd_kernel or
    seq_bwd_kernel."""
    I, H, B, L = 129, 256, 300, 5
    wcat, bias, xs, h0, c0, (dhs, dhf, dcf) = _seq_inputs(I, H, B, L, dtype, dev)
    bf16 = dtype == "bfloat16"
    fwd, step, wgrad = (("seq_fwd_step_kernel", "seq_step_kernel", "wgrad_wgmma_kernel") if bf16
                        else ("seq_fwd_tf32_kernel", "seq_step_tf32_kernel",
                              "wgrad_tf32_kernel"))
    old = ("seq_fwd_kernel", "seq_bwd_kernel")
    got = _kernel_counts(lambda: fs.seq_lstm_fwd(wcat, bias, xs, h0, c0), (fwd, *old))
    assert got == {fwd: L, "seq_fwd_kernel": 0, "seq_bwd_kernel": 0}, got
    res = fs.seq_lstm_fwd_reference(wcat, bias, xs, h0, c0)[:3]
    got = _kernel_counts(lambda: fs.seq_lstm_bwd_tm(wcat, xs, h0, c0, *res, dhs, dhf, dcf),
                         ("gate_kernel", step, wgrad, *old))
    assert got == {"gate_kernel": 1, step: L, wgrad: 2, "seq_fwd_kernel": 0,
                   "seq_bwd_kernel": 0}, got


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose first element sits one element past a
    16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seq_kernels_take_misaligned_views(dev, dtype):
    """wcat, xs, h0 and c0 as contiguous views that start off a 16-byte
    boundary: the loaders take their element path (the reverse product's
    rows of wcat, the forward's input and h0 rows, the weight gradient's
    rows) and the results equal the aligned call's within the file's
    tolerance of the plain version."""
    I, H, B, L = 128, 128, 70, 3
    wcat, bias, xs, h0, c0, (dhs, dhf, dcf) = _seq_inputs(I, H, B, L, dtype, dev, seed=3)
    mw, mx, mh, mc = (_misaligned(t) for t in (wcat, xs, h0, c0))
    k = fs.seq_lstm_fwd(mw, bias, mx, mh, mc)
    p = fs.seq_lstm_fwd_reference(wcat, bias, xs, h0, c0)
    torch.cuda.synchronize()
    _close(k, p, dtype)
    kb = fs.seq_lstm_bwd_tm(mw, mx, mh, mc, *p[:3], dhs, dhf, dcf)
    pb = fs.seq_lstm_bwd_reference(wcat, xs, h0, c0, *p[:3], dhs, dhf, dcf)
    torch.cuda.synchronize()
    _close(kb, pb, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 32), (37, 100), (4096, 1024), (2048, 4096)])
def test_gate_kernels_match_plain(dev, shape):
    B, H = shape
    g = torch.Generator().manual_seed(B)
    gates, c, dh, dc = ((3 * torch.randn(s, generator=g)).to(dev) for s in
                        ((B, 4 * H), (B, H), (B, H), (B, H)))
    before = (fl.gates_fwd.launches, fl.gates_bwd.launches)
    _close(fl.gates_fwd(gates, c), fl.gates_fwd_reference(gates, c), "float32")
    _close(fl.gates_bwd(gates, c, dh, dc), fl.gates_bwd_reference(gates, c, dh, dc), "float32")
    torch.cuda.synchronize()
    assert (fl.gates_fwd.launches, fl.gates_bwd.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_on_the_card_matches_the_cpu(dev, dtype):
    """lstm_sequence_fused, decoder_train_cvp and fused_lstm_gates through
    autograd on CUDA tensors (the kernels) against the same calls on CPU
    tensors (the plain versions): values and every gradient."""
    cfg = ModelConfig(latent_dim=8, compute_dtype=dtype, num_layers=3, hidden_dim=64,
                      embedding_dim=16, vocab_size=24, use_pallas=True)
    g = torch.Generator().manual_seed(5)
    dec = init_decoder_params(g, cfg)
    B, L = 21, 7
    tok = torch.randint(0, cfg.vocab_size, (B, L), generator=g, dtype=torch.int32)
    cond = torch.randn((B, 1), generator=g)
    h0 = torch.randn((B, cfg.hidden_dim), generator=g)
    tf = torch.rand((L,), generator=g) < 0.8
    xs = torch.randn((B, L, 40), generator=g)
    lp = {k: 0.2 * torch.randn(s, generator=g) for k, s in
          (("Wx", (256, 40)), ("Wh", (256, 64)), ("bias", (256,)))}
    gates = torch.randn((B, 256), generator=g)

    def run(device):
        d = {k: {n: t.to(device).requires_grad_(True) for n, t in v.items()}
             for k, v in dec.items()}
        p = {k: v.to(device).requires_grad_(True) for k, v in lp.items()}
        h, c = h0.to(device).requires_grad_(True), cond.to(device).requires_grad_(True)
        x, gt = xs.to(device).requires_grad_(True), gates.to(device).requires_grad_(True)
        logits = dcv.decoder_train_cvp(d, cfg, h, c, tok.to(device), tf.to(device))
        hs, (hf, cf) = fs.lstm_sequence_fused(p, x, h, 0.5 * h, cfg.dtype)
        gh, gc = fl.fused_lstm_gates(gt, h)
        loss = ((logits * logits).sum() + (hs.float() * 1.3).sum() + hf.sum() + 0.3 * cf.sum()
                + (gh * gc).sum())
        loss.backward()
        leaves = [logits, hs, hf, cf, gh, gc, h.grad, c.grad, x.grad, gt.grad]
        leaves += [t.grad for t in p.values()]
        leaves += [t.grad for v in d.values() for t in v.values() if t.grad is not None]
        return [t.detach().cpu() for t in leaves]

    _close(run(dev), run("cpu"), dtype)


@pytest.mark.cuda
def test_fused_seq_refuses_on_the_card(dev):
    """A width whose row does not fit shared memory raises
    NotImplementedError; it never runs the plain version in its place."""
    w = torch.zeros((16 + 9000, 4 * 9000), device=dev)
    with pytest.raises(NotImplementedError, match="fused_seq_lstm"):
        fs.seq_lstm_fwd(w, torch.zeros((4 * 9000,), device=dev),
                        torch.zeros((1, 1, 16), device=dev), torch.zeros((1, 9000), device=dev),
                        torch.zeros((1, 9000), device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(SEQ)))
def test_seq_fwd_strided_and_repeated(dev, case, dtype):
    """The forward with its input at rows 2t + 1 of a [2L, B, I] array and
    its residuals at rows 3t + 2 of [3L, B, .] arrays gives the dense call's
    results bit for bit and leaves the other rows alone; a second dense run
    repeats the first bit for bit (one writer per element, no atomics); the
    launch counter rises once a call."""
    _, _, I, H, B, L = SEQ[case]
    wcat, bias, xs2, h0, c0, _ = _seq_inputs(I, H, B, L, dtype, dev, stride=2, seed=case)
    xs = xs2[1::2].contiguous()
    before = fs.seq_lstm_fwd.launches
    d1 = fs.seq_lstm_fwd(wcat, bias, xs, h0, c0)
    d2 = fs.seq_lstm_fwd(wcat, bias, xs, h0, c0)
    out = tuple(torch.zeros((3 * L,) + tuple(a.shape[1:]), dtype=a.dtype, device=dev)
                for a in d1[:3])
    st = fs.seq_lstm_fwd(wcat, bias, xs2, h0, c0, res_stride=3, res_offset=2, xs_stride=2,
                         xs_offset=1, out=out)
    torch.cuda.synchronize()
    assert fs.seq_lstm_fwd.launches == before + 3
    for a, b in zip(d1, d2):
        assert torch.equal(a, b)
    for a, b in zip(d1[:3], st[:3]):
        assert torch.equal(b[2::3], a)
        assert not b[0::3].any() and not b[1::3].any()
    assert torch.equal(st[3], d1[3]) and torch.equal(st[4], d1[4])
