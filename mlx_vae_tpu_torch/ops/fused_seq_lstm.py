"""One LSTM layer over a whole sequence: CUDA kernels, wrappers and their
plain PyTorch versions.

Counterpart of ``mlx_vae_tpu/ops/pallas_seq_lstm.py``: the forward of
``lstm_sequence_pallas`` and the time-major backward
``lstm_seq_bwd_pallas_tm``. The kernels are in ``csrc/fused_seq_lstm.cu``
(CUDA C++ for ``sm_90a``; both dtypes run one frame on the tensor cores,
``wgmma``: bf16 on bf16 operands, f32 as split-TF32, every f32 product as
three TF32 products of the operands' hi and lo parts); their design and
what bounds them are noted at the top of that file. The forward is
``csrc/train_common.cuh``'s step kernel (``seq_fwd_step_kernel`` in bf16,
``seq_fwd_tf32_kernel`` in f32), L launches a call, reading a
gate-interleaved copy of the weight that the wrapper builds per call
(``ops/train_common.py:interleave_weight``). The backward's reverse chain
is a gate kernel for the last step, then one GEMM ``dgates_t W^T`` a step
whose epilogue runs the gate step of ``t - 1``
(:func:`seq_reverse_steps_reference` is its plain twin launch by launch),
then the weight-gradient sums.

* :func:`seq_lstm_fwd`: ``xs_t [L, B, I]`` (compute dtype), ``h0``/``c0``
  ``[B, H]`` f32 -> ``hs_t``, ``cs_t [L, B, H]`` and activated gates
  ``gs_t [L, B, 4H]`` in the compute dtype, ``hf``/``cf [B, H]`` f32. The
  input and the residuals may be addressed inside layer-stacked arrays as
  in the backward.
* :func:`seq_lstm_bwd_tm`: the reverse pass from those residuals, with f32
  per-step output cotangents ``dhs_t [L, B, H]`` and final-state cotangents
  ``dhf``/``dcf`` -> ``(dxs_t [L, B, I], dwcat [I + H, 4H], db [4H], dh0,
  dc0)``, all f32. ``res_stride/res_offset`` (and ``xs_stride/xs_offset``)
  address one layer inside layer-stacked ``[L * stride, B, .]`` arrays
  without a copy: row t of the layer is row ``t * stride + offset``.
* :func:`lstm_sequence_fused`: the ``torch.autograd.Function`` over both,
  the counterpart of ``lstm_sequence_pallas`` (``xs [B, L, I]`` ->
  ``(hs [B, L, H] in the compute dtype, (hf, cf))``).

Each wrapper launches its kernel on CUDA tensors (counted in ``.launches``)
and runs its plain version on CPU tensors. Shapes outside
:func:`fused_seq_supported` raise ``NotImplementedError`` on CUDA; a failed
build or launch raises ``RuntimeError``. The weight gradient sums rounded
gate cotangents (the kernels' residual contract), so in bf16 ``db`` differs
from the TPU kernel's f32 sum by rounding only.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mlx_vae_tpu_torch.ops.build import load_library
from mlx_vae_tpu_torch.ops.train_common import (
    MAX_SMEM, SCRATCH_ELEMS, bwd_rows, cell_step_reference, check, fwd_tile, interleave_weight,
    raise_if, require_cuda, reverse_step_reference, shifted, split_tf32_matmul, stream_of,
    sum_outer)

_DTYPES = (torch.float32, torch.bfloat16)


# ----------------------------------------------------------- plain version

def _rows(a: torch.Tensor, stride: int, offset: int, L: int) -> torch.Tensor:
    return a[offset::stride][:L]


def _residuals(L: int, B: int, H: int, wdt, dev, out=None):
    """``(hs, cs, gs)``: ``out``, or new ``[L, B, H]``, ``[L, B, H]`` and
    ``[L, B, 4H]`` arrays in ``wdt``."""
    if out is not None:
        return out
    hs = torch.empty((L, B, H), dtype=wdt, device=dev)
    return hs, torch.empty_like(hs), torch.empty((L, B, 4 * H), dtype=wdt, device=dev)


def seq_lstm_fwd_reference(wcat: torch.Tensor, bias: torch.Tensor, xs_t: torch.Tensor,
                           h0: torch.Tensor, c0: torch.Tensor, res_stride: int = 1,
                           res_offset: int = 0, xs_stride: int = 1, xs_offset: int = 0,
                           out=None):
    """Plain twin of the forward kernel (contract of :func:`seq_lstm_fwd`)."""
    wdt = wcat.dtype
    L = xs_t.shape[0] // xs_stride
    xs = _rows(xs_t, xs_stride, xs_offset, L)
    B, H = h0.shape
    hs, cs, gs = _residuals(L * res_stride, B, H, wdt, xs_t.device, out)
    h, c = h0.float(), c0.float()
    for t in range(L):
        h, c, g = cell_step_reference(wcat, bias, xs[t].float(), h, c, wdt)
        r = t * res_stride + res_offset
        hs[r], cs[r], gs[r] = h, c, g
    return hs, cs, gs, h, c


def seq_lstm_bwd_reference(wcat, xs_t, h0, c0, hs_t, cs_t, gs_t, dhs_t, dhf, dcf,
                           res_stride: int = 1, res_offset: int = 0, xs_stride: int = 1,
                           xs_offset: int = 0):
    """Plain twin of the backward kernels (contract of
    :func:`seq_lstm_bwd_tm`)."""
    wdt = wcat.dtype
    L = hs_t.shape[0] // res_stride
    hs, cs, gs = (_rows(a, res_stride, res_offset, L) for a in (hs_t, cs_t, gs_t))
    xs = _rows(xs_t, xs_stride, xs_offset, L)
    I = xs.shape[-1]
    w = wcat.float()
    dh, dc = dhf.float(), dcf.float()
    dgates = torch.empty(gs.shape, dtype=wdt, device=gs.device)
    dxs = torch.empty(xs.shape, dtype=torch.float32, device=gs.device)
    for t in range(L - 1, -1, -1):
        dg, dc = reverse_step_reference(gs[t], cs[t], cs[t - 1] if t else c0, dh + dhs_t[t],
                                        dc, wdt)
        dgates[t] = dg
        dinp = dg @ w.T
        dxs[t], dh = dinp[:, :I], dinp[:, I:]
    dwcat = sum_outer(torch.cat([xs.to(wdt), shifted(hs, h0)], dim=-1), dgates)
    return dxs, dwcat, dgates.float().sum(dim=(0, 1)), dh, dc


def seq_reverse_steps_reference(wcat, xs_t, h0, c0, hs_t, cs_t, gs_t, dhs_t, dhf, dcf,
                                res_stride: int = 1, res_offset: int = 0, xs_stride: int = 1,
                                xs_offset: int = 0, split_tf32: bool = False):
    """The backward launch by launch (contract of :func:`seq_lstm_bwd_tm`):
    ``gate_kernel`` runs the gate step of t = L-1 from ``dhf``, ``dcf`` and
    ``dhs[L-1]``; then for t = L-1 .. 0 one step launch forms ``dinp_t =
    dgates_t W^T``, writes its input columns to ``dxs[t]`` and runs the gate
    step of t-1 on its h columns (``dh0`` at t = 0), the running dc carried
    from launch to launch as the kernels carry it in ``dc0``; then the
    weight-gradient sums. ``split_tf32``: the f32 kernels' products
    (``seq_step_tf32_kernel``, ``wgrad_tf32_kernel``), each
    :func:`~mlx_vae_tpu_torch.ops.train_common.split_tf32_matmul`. Equals
    :func:`seq_lstm_bwd_reference` bit for bit without ``split_tf32``."""
    wdt = wcat.dtype
    L = hs_t.shape[0] // res_stride
    hs, cs, gs = (_rows(a, res_stride, res_offset, L) for a in (hs_t, cs_t, gs_t))
    xs = _rows(xs_t, xs_stride, xs_offset, L)
    I = xs.shape[-1]
    mm = split_tf32_matmul if split_tf32 else torch.matmul
    w = wcat.float().T
    dgates = torch.empty(gs.shape, dtype=wdt, device=gs.device)
    dxs = torch.empty(xs.shape, dtype=torch.float32, device=gs.device)

    def gate(s, dh, dc):  # the gate step of s: dgates[s], and the new dc
        dgates[s], dc = reverse_step_reference(gs[s], cs[s], cs[s - 1] if s else c0,
                                               dh + dhs_t[s], dc, wdt)
        return dc

    dc = gate(L - 1, dhf.float(), dcf.float())
    for t in range(L - 1, -1, -1):
        dinp = mm(dgates[t].float(), w)
        dxs[t] = dinp[:, :I]
        if t > 0:
            dc = gate(t - 1, dinp[:, I:], dc)
    a = torch.cat([xs.to(wdt), shifted(hs, h0)], dim=-1)
    dwcat = (split_tf32_matmul(a.reshape(-1, a.shape[-1]).float().T,
                               dgates.reshape(-1, dgates.shape[-1]).float())
             if split_tf32 else sum_outer(a, dgates))
    return dxs, dwcat, dgates.float().sum(dim=(0, 1)), dinp[:, I:], dc


# ------------------------------------------------------------------ kernels

# The f32 support rule below is the shared-memory plan of the CUDA-core
# kernels that ran f32 before its split-TF32 kernels (one row's forward
# state, and one row's reverse state, in a block's shared memory). The
# split-TF32 kernels take any width, as the bf16 ones do; the rule is kept
# so that no model changes route with the kernels.

def _fwd_smem(I: int, H: int):
    return lambda r: r * I + 3 * r * H


def _bwd_smem(H: int):
    return lambda r: 7 * r * H


def bwd_plan(H: int, dtype) -> Optional[int]:
    """Rows per block of the CUDA-core f32 reverse plan (dh, dc, output
    cotangent and dgates in shared memory), or None where one row does not
    fit. 0 for bf16: its per-step GEMMs tile rows and columns through a
    fixed shared-memory ring, so any width fits."""
    return 0 if dtype == torch.bfloat16 else bwd_rows(_bwd_smem(H))


def _unsupported_reason(I: int, H: int, dtype) -> Optional[str]:
    if dtype not in _DTYPES:
        return f"compute dtype {dtype}"
    if dtype == torch.float32 and (fwd_tile(H, _fwd_smem(I, H)) is None
                                   or bwd_plan(H, dtype) is None):
        return f"shared-memory plan: one row of I={I}, H={H} > {MAX_SMEM} B"
    return None


def fused_seq_supported(input_size: int, hidden: int, dtype) -> bool:
    """Shapes the kernels take: bf16 at any width (per-step GEMMs through a
    fixed shared-memory ring, both ways); f32 where one row's forward state
    (input, h twice, c) and one row's reverse state (:func:`bwd_plan`) fit a
    block's shared memory (the rule above). Any batch."""
    return _unsupported_reason(input_size, hidden, dtype) is None


def build_library(verbose: bool = False) -> ctypes.CDLL:
    """Build ``csrc/fused_seq_lstm.cu`` (``ops/build.py``), load it and
    declare its C interface."""
    lib = load_library("fused_seq_lstm", verbose)
    p, i, lg = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.seq_fwd_launch.argtypes = [p] + [i] * 2 + [p] * 7 + [i] * 2 + [p] * 2 + [i] * 5 + [p]
    lib.seq_fwd_launch.restype = i
    lib.seq_bwd_launch.argtypes = ([p] * 3 + [i] * 2 + [p] + [i] * 2 + [p] * 13 + [lg]
                                   + [i] * 5 + [p])
    lib.seq_bwd_launch.restype = i
    lib.seq_error_string.argtypes = [i]
    lib.seq_error_string.restype = ctypes.c_char_p
    return lib


def launch_seq_fwd(lib, wcat, bias, xs_t, h0, c0, stream: int, res_stride: int = 1,
                   res_offset: int = 0, xs_stride: int = 1, xs_offset: int = 0, out=None):
    """Allocate the outputs (the residuals unless ``out`` holds them), build
    the weight's interleaved copy and launch the forward kernels (no device
    or support checks: :func:`seq_lstm_fwd` makes them)."""
    wdt = wcat.dtype
    B, I = xs_t.shape[1:]
    H = h0.shape[1]
    L = xs_t.shape[0] // xs_stride
    hs, cs, gs = _residuals(L * res_stride, B, H, wdt, xs_t.device, out)
    hf, cf = torch.empty_like(h0), torch.empty_like(h0)
    wt = interleave_weight(wcat, I, H)
    rc = lib.seq_fwd_launch(xs_t.data_ptr(), xs_stride, xs_offset, h0.data_ptr(), c0.data_ptr(),
                            wt.data_ptr(), bias.data_ptr(), hs.data_ptr(), cs.data_ptr(),
                            gs.data_ptr(), res_stride, res_offset, hf.data_ptr(), cf.data_ptr(),
                            B, L, I, H, int(wdt == torch.bfloat16), stream)
    raise_if(rc, "seq_lstm forward", lib.seq_error_string)
    return hs, cs, gs, hf, cf


def seq_lstm_fwd(wcat: torch.Tensor, bias: torch.Tensor, xs_t: torch.Tensor,
                 h0: torch.Tensor, c0: torch.Tensor, res_stride: int = 1, res_offset: int = 0,
                 xs_stride: int = 1, xs_offset: int = 0, out=None):
    """The forward. ``wcat [I + H, 4H]`` in the compute dtype (it sets the
    dtype), ``bias [4H]`` f32. Row t of the input is row ``t * xs_stride +
    xs_offset`` of ``xs_t [L * xs_stride, B, I]``; the residuals go to rows
    ``t * res_stride + res_offset`` of ``out = (hs, cs, gs)`` (``[L *
    res_stride, B, .]``, new arrays if None; their other rows are left as
    they are). CPU tensors run the plain version; CUDA tensors launch the
    kernels, counted once per call in ``seq_lstm_fwd.launches``."""
    if xs_t.device.type == "cpu":
        return seq_lstm_fwd_reference(wcat, bias, xs_t, h0, c0, res_stride, res_offset,
                                      xs_stride, xs_offset, out)
    I = xs_t.shape[-1]
    B, H = h0.shape
    L = xs_t.shape[0] // xs_stride
    wdt, dev = wcat.dtype, xs_t.device
    require_cuda(xs_t, "fused_seq_lstm forward", _unsupported_reason(I, H, wdt))
    _check_offsets(res_stride, res_offset, xs_stride, xs_offset)
    check(xs_t, "xs_t", (L * xs_stride, B, I), wdt, dev)
    check(wcat, "wcat", (I + H, 4 * H), wdt, dev)
    check(bias, "bias", (4 * H,), torch.float32, dev)
    check(h0, "h0", (B, H), torch.float32, dev)
    check(c0, "c0", (B, H), torch.float32, dev)
    if out is not None:
        for name, t, last in zip(("hs", "cs", "gs"), out, (H, H, 4 * H)):
            check(t, name, (L * res_stride, B, last), wdt, dev)
    lib = build_library()
    with torch.cuda.device(dev):
        res = launch_seq_fwd(lib, wcat, bias, xs_t, h0, c0, stream_of(dev), res_stride,
                             res_offset, xs_stride, xs_offset, out)
    seq_lstm_fwd.launches += 1
    return res


seq_lstm_fwd.launches = 0


def _check_offsets(res_stride: int, res_offset: int, xs_stride: int, xs_offset: int) -> None:
    if not (0 <= res_offset < res_stride and 0 <= xs_offset < xs_stride):
        raise ValueError(f"offsets ({res_offset}, {xs_offset}) outside strides "
                         f"({res_stride}, {xs_stride})")


def launch_seq_bwd(lib, wcat, xs_t, h0, c0, hs_t, cs_t, gs_t, dhs_t, dhf, dcf, res_stride,
                   res_offset, xs_stride, xs_offset, stream: int):
    """Allocate the outputs and scratch and launch the backward kernels (no
    device or support checks: :func:`seq_lstm_bwd_tm` makes them). The
    reverse chain reads ``wcat`` as it lies."""
    wdt = wcat.dtype
    L, B, H = dhs_t.shape
    I = xs_t.shape[-1]
    dev = dhs_t.device
    f32 = dict(dtype=torch.float32, device=dev)
    h0w = h0.to(wdt).contiguous()
    dgates = torch.empty((L, B, 4 * H), dtype=wdt, device=dev)
    dxs = torch.empty((L, B, I), **f32)
    dwcat = torch.empty((I + H, 4 * H), **f32)
    db = torch.empty((4 * H,), **f32)
    dh0, dc0 = torch.empty((B, H), **f32), torch.empty((B, H), **f32)
    scratch_elems = max(SCRATCH_ELEMS, (max(I, H) + 1) * 4 * H)
    scratch = torch.empty((scratch_elems,), **f32)
    rc = lib.seq_bwd_launch(
        gs_t.data_ptr(), cs_t.data_ptr(), hs_t.data_ptr(), res_stride, res_offset,
        xs_t.data_ptr(), xs_stride, xs_offset, h0w.data_ptr(), c0.data_ptr(), wcat.data_ptr(),
        dhs_t.data_ptr(), dhf.data_ptr(), dcf.data_ptr(), dgates.data_ptr(), dxs.data_ptr(),
        dwcat.data_ptr(), db.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), scratch.data_ptr(),
        scratch_elems, B, L, I, H, int(wdt == torch.bfloat16), stream)
    raise_if(rc, "seq_lstm backward", lib.seq_error_string)
    return dxs, dwcat, db, dh0, dc0


def seq_lstm_bwd_tm(wcat: torch.Tensor, xs_t: torch.Tensor, h0: torch.Tensor,
                    c0: torch.Tensor, hs_t: torch.Tensor, cs_t: torch.Tensor,
                    gs_t: torch.Tensor, dhs_t: torch.Tensor, dhf: torch.Tensor,
                    dcf: torch.Tensor, res_stride: int = 1, res_offset: int = 0,
                    xs_stride: int = 1, xs_offset: int = 0):
    """The time-major backward (``lstm_seq_bwd_pallas_tm``). ``wcat``,
    ``xs_t`` and the residuals are in the compute dtype, everything else
    f32. CPU tensors run the plain version; CUDA tensors launch the kernels,
    counted once per call in ``seq_lstm_bwd_tm.launches``."""
    if dhs_t.device.type == "cpu":
        return seq_lstm_bwd_reference(wcat, xs_t, h0, c0, hs_t, cs_t, gs_t, dhs_t, dhf, dcf,
                                      res_stride, res_offset, xs_stride, xs_offset)
    L, B, H = dhs_t.shape
    I = xs_t.shape[-1]
    wdt, dev = wcat.dtype, dhs_t.device
    require_cuda(dhs_t, "fused_seq_lstm backward", _unsupported_reason(I, H, wdt))
    _check_offsets(res_stride, res_offset, xs_stride, xs_offset)
    check(wcat, "wcat", (I + H, 4 * H), wdt, dev)
    check(xs_t, "xs_t", (L * xs_stride, B, I), wdt, dev)
    for name, t, last in (("hs_t", hs_t, H), ("cs_t", cs_t, H), ("gs_t", gs_t, 4 * H)):
        check(t, name, (L * res_stride, B, last), wdt, dev)
    for name, t in (("h0", h0), ("c0", c0), ("dhf", dhf), ("dcf", dcf)):
        check(t, name, (B, H), torch.float32, dev)
    check(dhs_t, "dhs_t", (L, B, H), torch.float32, dev)
    lib = build_library()
    with torch.cuda.device(dev):
        res = launch_seq_bwd(lib, wcat, xs_t, h0, c0, hs_t, cs_t, gs_t, dhs_t, dhf, dcf,
                             res_stride, res_offset, xs_stride, xs_offset, stream_of(dev))
    seq_lstm_bwd_tm.launches += 1
    return res


seq_lstm_bwd_tm.launches = 0


# ------------------------------------------------------------ autograd

class _SeqLSTM(torch.autograd.Function):

    @staticmethod
    def forward(ctx, dtype, xs, h0, c0, wx, wh, bias):
        wcat = torch.cat([wx.T, wh.T], dim=0).to(dtype).contiguous()
        xs_t = xs.detach().transpose(0, 1).to(dtype).contiguous()
        h0 = h0.detach().float().contiguous()
        c0 = c0.detach().float().contiguous()
        hs_t, cs_t, gs_t, hf, cf = seq_lstm_fwd(wcat, bias.detach().float().contiguous(),
                                                xs_t, h0, c0)
        ctx.save_for_backward(wcat, xs_t, h0, c0, hs_t, cs_t, gs_t)
        ctx.xs_dtype = xs.dtype
        return hs_t.transpose(0, 1).contiguous(), hf, cf

    @staticmethod
    def backward(ctx, dhs, dhf, dcf):
        wcat, xs_t, h0, c0, hs_t, cs_t, gs_t = ctx.saved_tensors
        I = xs_t.shape[-1]
        dxs_t, dwcat, db, dh0, dc0 = seq_lstm_bwd_tm(
            wcat, xs_t, h0, c0, hs_t, cs_t, gs_t, dhs.transpose(0, 1).float().contiguous(),
            dhf.float().contiguous(), dcf.float().contiguous())
        dxs = dxs_t.transpose(0, 1).to(ctx.xs_dtype)
        return None, dxs, dh0, dc0, dwcat[:I].T, dwcat[I:].T, db


def lstm_sequence_fused(params: dict, xs: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                        dtype=torch.float32):
    """``lstm_sequence_pallas``: ``xs [B, L, I]`` -> ``(hs [B, L, H] in
    ``dtype``, (h_final, c_final) f32)`` through the kernel pair."""
    hs, hf, cf = _SeqLSTM.apply(dtype, xs, h0, c0, params["Wx"], params["Wh"], params["bias"])
    return hs, (hf, cf)
