"""Port per-layer sequence LSTM vs the JAX package on the same numpy inputs.

* ``lstm_sequence_fused`` (on CPU tensors: the plain twins of the sequence
  kernels) against ``lstm_sequence_pallas(..., interpret=True)``: forward
  values and the gradients of the params, the inputs, ``h0`` and ``c0``,
  also with the JAX kernel's gate-axis blocking forced
  (``TestGateBlockedSeqLSTM``'s G = 2, 4).
* ``seq_lstm_bwd_tm`` against ``lstm_seq_bwd_pallas_tm(..., interpret=True)``
  on residuals and inputs that are rows of layer-stacked arrays (stride 3,
  offset 1), and against its own dense call.
* ``lstm_sequence_cv`` against the JAX ``lstm_sequence_cv``.

I = H = 128, B = 16, L = 7, non-zero h0 and c0 (``TestFusedSequenceLSTM``'s
shapes). Tolerances: float32 forward values 1e-5, gradients 1e-4 (the JAX
package's kernel-vs-autodiff tolerance; the frameworks sum in different
orders). bfloat16: both sides store activated gates in bf16 and round the
same operands, so each leaf agrees within 2e-2 of its largest magnitude
(one bf16 ulp is ~4e-3 relative; the port's ``db`` sums rounded gate
cotangents where the TPU kernel sums them in f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_vae_tpu.ops import lstm as jlstm
from mlx_vae_tpu.ops import pallas_seq_lstm as psl
from mlx_vae_tpu_torch.ops import fused_seq_lstm as fs
from mlx_vae_tpu_torch.ops import lstm as tlstm

I = H = 128
B, L = 16, 7
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed=0, I_=I):
    params = jax.tree_util.tree_map(np.array,
                                    jlstm.init_lstm_params(jax.random.PRNGKey(seed), I_, H))
    rng = np.random.default_rng(seed + 1)
    xs = rng.standard_normal((B, L, I_)).astype(np.float32)
    h0 = (0.1 * rng.standard_normal((B, H))).astype(np.float32)
    c0 = (0.1 * rng.standard_normal((B, H))).astype(np.float32)
    return params, xs, h0, c0


def _close(got, want, dtype, what="", tol=None):
    got = np.asarray(torch.as_tensor(got).float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)
    else:
        err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-3)
        assert err < 2e-2, f"{what}: scaled err {err:.3e}"


def _loss_jax(fn):
    def f(p, x, h, c):
        hs, (hf, cf) = fn(p, x, h, c)
        return jnp.sum(hs.astype(jnp.float32) * 1.3) + jnp.sum(hf * 0.7) + jnp.sum(cf * 0.3)
    return f


def _port_grads(fn, params, xs, h0, c0):
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    tx, th, tc = (torch.from_numpy(a).requires_grad_(True) for a in (xs, h0, c0))
    hs, (hf, cf) = fn(tp, tx, th, tc)
    loss = (hs.float() * 1.3).sum() + (hf * 0.7).sum() + (cf * 0.3).sum()
    loss.backward()
    return (hs.detach(), hf.detach(), cf.detach()), \
        {"Wx": tp["Wx"].grad, "Wh": tp["Wh"].grad, "bias": tp["bias"].grad}, \
        (tx.grad, th.grad, tc.grad)


@pytest.mark.parametrize("G", [None, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_sequence_matches_pallas_interpret(dtype, G, monkeypatch):
    params, xs, h0, c0 = _inputs()
    jdt, tdt = DT[dtype]
    monkeypatch.setattr(psl, "_FORCE_G", G)
    jfn = lambda p, x, h, c: psl.lstm_sequence_pallas(p, x, h, c, jdt, True)  # noqa: E731
    jargs = tuple(jnp.asarray(a) for a in (xs, h0, c0))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jhs, (jhf, jcf) = jfn(jp, *jargs)
    jg = jax.grad(_loss_jax(jfn), argnums=(0, 1, 2, 3))(jp, *jargs)
    (ths, thf, tcf), tgp, tgx = _port_grads(
        lambda p, x, h, c: fs.lstm_sequence_fused(p, x, h, c, tdt), params, xs, h0, c0)
    assert ths.dtype == tdt and thf.dtype == torch.float32
    for got, want, what in ((ths, jhs, "hs"), (thf, jhf, "hf"), (tcf, jcf, "cf")):
        _close(got, want, dtype, what, 1e-5)
    for k in ("Wx", "Wh", "bias"):
        _close(tgp[k], jg[0][k], dtype, k, 1e-4)
    for got, want, what in zip(tgx, jg[1:], ("xs", "h0", "c0")):
        _close(got, want, dtype, what, 1e-4)


def _stacked(a, stride, offset, rng):
    """``a [L, B, .]`` as rows ``t * stride + offset`` of a larger array whose
    other rows hold noise."""
    out = rng.standard_normal((a.shape[0] * stride,) + a.shape[1:]).astype(np.float32)
    out = np.array(jnp.asarray(out).astype(a.dtype))
    out[offset::stride] = np.asarray(a)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_tm_strided_matches_pallas_interpret(dtype):
    """Residuals and inputs addressed inside ``[L*3, B, .]`` arrays at
    offset 1 (the decoder's layer-stacked residuals), with non-zero h0, c0
    and final-state cotangents."""
    params, xs, h0, c0 = _inputs(3)
    jdt, tdt = DT[dtype]
    (_, _), res = psl._fwd(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(xs),
                           jnp.asarray(h0), jnp.asarray(c0), jdt, True)
    _, _, _, _, hs_t, cs_t, gs_t = res
    rng = np.random.default_rng(5)
    dhs = rng.standard_normal((L, B, H)).astype(np.float32)
    dhf, dcf = (rng.standard_normal((B, H)).astype(np.float32) for _ in range(2))
    w = jnp.concatenate([params["Wx"].T, params["Wh"].T], axis=0).astype(jdt)
    xs_t = jnp.swapaxes(jnp.asarray(xs), 0, 1).astype(jdt)
    stk = [_stacked(np.asarray(a), 3, 1, rng) for a in (hs_t, cs_t, gs_t, xs_t)]
    want = psl.lstm_seq_bwd_pallas_tm(
        w, jnp.asarray(stk[3]), jnp.asarray(h0), jnp.asarray(c0), *map(jnp.asarray, stk[:3]),
        jnp.asarray(dhs), jnp.asarray(dhf), jnp.asarray(dcf), True, res_stride=3, res_offset=1,
        xs_stride=3, xs_offset=1)
    t = lambda a: torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(tdt)  # noqa
    f = torch.from_numpy
    got = fs.seq_lstm_bwd_tm(t(w), *(t(a) for a in (stk[3],)), f(h0), f(c0),
                             *(t(a) for a in stk[:3]), f(dhs), f(dhf), f(dcf),
                             res_stride=3, res_offset=1, xs_stride=3, xs_offset=1)
    for g, wv, what in zip(got, want, ("dxs", "dwcat", "db", "dh0", "dc0")):
        _close(g, wv, dtype, what, 1e-4)
    dense = fs.seq_lstm_bwd_tm(t(w), t(xs_t), f(h0), f(c0), t(hs_t), t(cs_t), t(gs_t),
                               f(dhs), f(dhf), f(dcf))
    for g, d in zip(got, dense):
        assert torch.equal(g, d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_sequence_cv_matches_jax(dtype):
    params, xs, h0, c0 = _inputs(7, I_=48)
    jdt, tdt = DT[dtype]
    jfn = lambda p, x, h, c: jlstm.lstm_sequence_cv(p, x, h, c, jdt)  # noqa: E731
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jargs = tuple(jnp.asarray(a) for a in (xs, h0, c0))
    jhs, (jhf, jcf) = jfn(jp, *jargs)
    jg = jax.grad(_loss_jax(jfn), argnums=(0, 1, 2, 3))(jp, *jargs)
    (ths, thf, tcf), tgp, tgx = _port_grads(
        lambda p, x, h, c: tlstm.lstm_sequence_cv(p, x, h, c, tdt), params, xs, h0, c0)
    for got, want, what in ((ths, jhs, "hs"), (thf, jhf, "hf"), (tcf, jcf, "cf")):
        _close(got, want, dtype, what, 1e-5)
    for k in ("Wx", "Wh", "bias"):
        _close(tgp[k], jg[0][k], dtype, k, 1e-4)
    for got, want, what in zip(tgx, jg[1:], ("xs", "h0", "c0")):
        _close(got, want, dtype, what, 1e-4)


def test_cv_forward_equals_the_scan():
    """``lstm_sequence_cv`` and ``lstm_sequence`` share the forward."""
    params, xs, h0, c0 = _inputs(2)
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    a = tlstm.lstm_sequence(p, torch.from_numpy(xs), torch.from_numpy(h0), torch.from_numpy(c0))
    b = tlstm.lstm_sequence_cv(p, torch.from_numpy(xs), torch.from_numpy(h0),
                               torch.from_numpy(c0))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1][0], b[1][0])


def test_supported_gate_and_cpu_counts():
    """The kernels take any width whose row fits shared memory, in f32 and
    bf16; the plain twins on CPU tensors launch nothing."""
    for dt in (torch.float32, torch.bfloat16):
        assert fs.fused_seq_supported(1024, 1024, dt)   # scaled layers 1..3
        assert fs.fused_seq_supported(128, 1024, dt)    # encoder layer 0
        assert fs.fused_seq_supported(129, 1024, dt)    # decoder layer 0: E + C
        assert fs.fused_seq_supported(2048, 1024, dt)   # bidirectional input
    assert not fs.fused_seq_supported(128, 128, torch.float16)
    assert not fs.fused_seq_supported(128, 9000, torch.float32)
    params, xs, h0, c0 = _inputs(1)
    before = (fs.seq_lstm_fwd.launches, fs.seq_lstm_bwd_tm.launches)
    _port_grads(lambda p, x, h, c: fs.lstm_sequence_fused(p, x, h, c), params, xs, h0, c0)
    assert (fs.seq_lstm_fwd.launches, fs.seq_lstm_bwd_tm.launches) == before


def test_wrappers_refuse_other_devices():
    """Off the CPU a wrapper launches its kernel or raises: on the meta
    device it stops at the device check."""
    m = dict(device="meta")
    w = torch.empty((2 * H, 4 * H), **m)
    xs_t, h0 = torch.empty((L, B, H), **m), torch.empty((B, H), **m)
    with pytest.raises(ValueError, match="unsupported device meta"):
        fs.seq_lstm_fwd(w, torch.empty((4 * H,), **m), xs_t, h0, h0)
    with pytest.raises(ValueError, match="unsupported device meta"):
        fs.seq_lstm_bwd_tm(w, xs_t, h0, h0, xs_t, xs_t, torch.empty((L, B, 4 * H), **m), xs_t,
                           h0, h0)


# ---- the bf16 forward's step kernel, through its plain twin ----

from mlx_vae_tpu_torch.ops import train_common as tc  # noqa: E402


@pytest.mark.parametrize("IH", [(129, 100), (128, 128), (16, 32), (200, 64)])
def test_interleave_weight_layout(IH):
    """The step kernel's weight copy: row 128 T + 32 q + j holds column
    q * H + u (u = 32 T + j) of the combined weight, input rows at k < I and
    recurrent rows from Ixp on; every other entry is zero."""
    I_, H_ = IH
    ixp, kp, np_ = tc.fwd_step_plan(I_, H_)
    assert ixp % 64 == 0 and ixp - 64 < I_ <= ixp and kp % 64 == 0 and kp - ixp >= H_
    assert np_ == 128 * -(-H_ // 32)
    w = torch.randn((I_ + H_, 4 * H_))
    wt = tc.interleave_weight(w, I_, H_)
    assert wt.shape == (np_, kp)
    n = tc.gate_columns(H_)
    assert sorted(n.tolist()) == sorted(set(n.tolist()))
    for q in range(4):
        for u in (0, H_ // 2, H_ - 1):
            row = 128 * (u // 32) + 32 * q + u % 32
            assert int(n[q * H_ + u]) == row
            assert torch.equal(wt[row, :I_], w[:I_, q * H_ + u])
            assert torch.equal(wt[row, ixp:ixp + H_], w[I_:, q * H_ + u])
    mask = torch.zeros_like(wt, dtype=torch.bool)
    mask[n, :I_] = True
    mask[n, ixp:ixp + H_] = True
    assert not wt[~mask].any()


# (I, H, B, L, input stride/offset, residual stride/offset)
STEP_CASES = [(129, 100, 19, 5, (1, 0), (1, 0)), (128, 128, 16, 7, (2, 1), (3, 2)),
              (16, 32, 8, 3, (3, 0), (2, 1))]


def _compose_steps(wcat, bias, xs, h0, c0, I_, H_, L_, xst, res, split_tf32=False):
    """The step twin over L steps; residuals at (stride, offset) ``res``
    (``split_tf32``: the f32 kernel's product)."""
    rs, ro = res
    B_ = h0.shape[0]
    wt = tc.interleave_weight(wcat, I_, H_)
    hs = torch.zeros((L_ * rs, B_, H_), dtype=wcat.dtype)
    cs, gs = torch.zeros_like(hs), torch.zeros((L_ * rs, B_, 4 * H_), dtype=wcat.dtype)
    c, hf = torch.empty((B_, H_)), torch.empty((B_, H_))
    for t in range(L_):
        tc.seq_fwd_step_reference(wt, bias, t, xs, c, hs, cs, gs, I_, H_, x_stride=xst[0],
                                  x_offset=xst[1], h0=h0, c0=c0, res_stride=rs,
                                  res_offset=ro, hf=hf if t == L_ - 1 else None,
                                  split_tf32=split_tf32)
    return hs, cs, gs, hf, c


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "split_tf32"])
@pytest.mark.parametrize("case", range(len(STEP_CASES)))
def test_fwd_steps_compose_to_the_plain_forward(case, dtype):
    """The step twin (input rows at a stride, residual rows at a stride, h0
    at t = 0) composed over L equals seq_lstm_fwd_reference bit for bit
    (also through seq_lstm_fwd's strided arguments on CPU tensors), and
    matches lstm_sequence_pallas(interpret=True) within the file's
    tolerances. ``split_tf32``: the f32 kernel's twin (its products
    split-TF32) within 1e-6 (absolute and relative) of the plain f32
    forward, and within 1e-5 of the JAX f32 forward."""
    I_, H_, B_, L_, xst, res = STEP_CASES[case]
    split = dtype == "split_tf32"
    dtype = "float32" if split else dtype
    jdt, tdt = DT[dtype]
    params = jax.tree_util.tree_map(np.array,
                                    jlstm.init_lstm_params(jax.random.PRNGKey(case), I_, H_))
    rng = np.random.default_rng(case)
    xs = rng.standard_normal((B_, L_, I_)).astype(np.float32)
    h0 = (0.1 * rng.standard_normal((B_, H_))).astype(np.float32)
    c0 = (0.1 * rng.standard_normal((B_, H_))).astype(np.float32)
    wcat = torch.from_numpy(np.concatenate([params["Wx"].T, params["Wh"].T])).to(tdt)
    bias = torch.from_numpy(params["bias"]).float()
    xs_t = torch.from_numpy(np.ascontiguousarray(xs.swapaxes(0, 1))).to(tdt)
    xs_big = torch.from_numpy(rng.standard_normal((L_ * xst[0], B_, I_)).astype(np.float32)
                              ).to(tdt)
    xs_big[xst[1]::xst[0]] = xs_t
    th0, tc0 = torch.from_numpy(h0), torch.from_numpy(c0)
    got = _compose_steps(wcat, bias, xs_big, th0, tc0, I_, H_, L_, xst, res, split)
    want = fs.seq_lstm_fwd_reference(wcat, bias, xs_t, th0, tc0)
    rs, ro = res
    if split:
        for g, w_ in zip((*(a[ro::rs] for a in got[:3]), *got[3:]), want):
            np.testing.assert_allclose(g.numpy(), w_.numpy(), rtol=1e-6, atol=1e-6)
    else:
        for g, w_ in zip(got[:3], want[:3]):
            assert torch.equal(g[ro::rs], w_)
        assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
        out = tuple(torch.zeros_like(a) for a in got[:3])
        strided = fs.seq_lstm_fwd(wcat, bias, xs_big, th0, tc0, res_stride=rs, res_offset=ro,
                                  xs_stride=xst[0], xs_offset=xst[1], out=out)
        for g, s_ in zip(got, strided):
            assert torch.equal(g, s_)
    (_, (jhf, jcf)), jres = psl._fwd(jax.tree_util.tree_map(jnp.asarray, params),
                                     jnp.asarray(xs), jnp.asarray(h0), jnp.asarray(c0), jdt,
                                     True)
    for g, jv, what in zip(got, (*jres[4:], jhf, jcf), ("hs", "cs", "gs", "hf", "cf")):
        g = g[ro::rs] if g.dim() == 3 else g
        _close(g, jv, dtype, what, 1e-5)


def _leaf_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want| (the card tests' yardstick)."""
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


# (input width, residuals and input at stride 2 offset 1, non-zero c0):
# H = 100, B = 19, L = 6
REV_CASES = [(I_, strided, c0) for I_ in (129, 100) for strided in (False, True)
             for c0 in (False, True)]


@pytest.mark.parametrize("case", range(len(REV_CASES)))
def test_reverse_steps_match_the_plain_backward_and_jax(case):
    """The f32 backward launch by launch, as the split-TF32 kernels form it
    (seq_reverse_steps_reference(split_tf32=True): gate_kernel, then one
    seq_step_tf32_kernel a step, then wgrad_tf32_kernel), within 2e-6 of
    each leaf's largest magnitude of seq_lstm_bwd_reference (the split
    keeps ~2^-21 of each product; over the six-step chain dh0 reaches
    ~1e-6), and within 1e-4 of
    lstm_seq_bwd_pallas_tm(interpret=True) on the same residuals
    and cotangents; without split_tf32 the twin equals the plain backward
    bit for bit. Dense and layer-stacked residuals and inputs (stride 2,
    offset 1), I in {129, H}, zero and non-zero c0."""
    I_, strided, nonzero_c0 = REV_CASES[case]
    H_, B_, L_ = 100, 19, 6
    params = jax.tree_util.tree_map(
        np.array, jlstm.init_lstm_params(jax.random.PRNGKey(case), I_, H_))
    rng = np.random.default_rng(case + 11)
    xs = rng.standard_normal((B_, L_, I_)).astype(np.float32)
    h0 = (0.3 * rng.standard_normal((B_, H_))).astype(np.float32)
    c0 = (0.3 * rng.standard_normal((B_, H_)) * nonzero_c0).astype(np.float32)
    (_, _), res = psl._fwd(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(xs),
                           jnp.asarray(h0), jnp.asarray(c0), jnp.float32, True)
    dhs = rng.standard_normal((L_, B_, H_)).astype(np.float32)
    dhf, dcf = (rng.standard_normal((B_, H_)).astype(np.float32) for _ in range(2))
    w = np.concatenate([params["Wx"].T, params["Wh"].T], axis=0)
    arrays = [np.array(a) for a in (*res[4:], xs.swapaxes(0, 1))]
    kw = {}
    if strided:
        arrays = [_stacked(a, 2, 1, rng) for a in arrays]
        kw = dict(res_stride=2, res_offset=1, xs_stride=2, xs_offset=1)
    hs_t, cs_t, gs_t, xs_t = arrays
    want = psl.lstm_seq_bwd_pallas_tm(
        jnp.asarray(w), jnp.asarray(xs_t), jnp.asarray(h0), jnp.asarray(c0), jnp.asarray(hs_t),
        jnp.asarray(cs_t), jnp.asarray(gs_t), jnp.asarray(dhs), jnp.asarray(dhf),
        jnp.asarray(dcf), True, **kw)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (w, xs_t, h0, c0, hs_t, cs_t, gs_t, dhs, dhf, dcf)]
    plain = fs.seq_lstm_bwd_reference(*args, **kw)
    steps = fs.seq_reverse_steps_reference(*args, **kw)
    split = fs.seq_reverse_steps_reference(*args, **kw, split_tf32=True)
    for p, st, sp, jv, what in zip(plain, steps, split, want,
                                   ("dxs", "dwcat", "db", "dh0", "dc0")):
        assert torch.equal(st, p), what
        assert _leaf_err(sp, p) <= 2e-6, what
        _close(sp, jv, "float32", what, 1e-4)
