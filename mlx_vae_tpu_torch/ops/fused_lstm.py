"""The LSTM cell's elementwise tail: CUDA kernels, wrappers and their plain
PyTorch versions.

Counterpart of ``mlx_vae_tpu/ops/pallas_lstm.py:fused_lstm_gates``:
pre-activation gates ``[B, 4H]`` and ``c [B, H]`` (f32) -> ``(h', c')`` in
one pass, with a backward that recomputes the activations from ``(gates,
c)`` instead of storing them. The kernels are in ``csrc/fused_lstm_gates.cu``
(CUDA C++ for ``sm_90a``); their design and what bounds them are noted at the
top of that file.

:func:`fused_lstm_gates` is one ``torch.autograd.Function`` whose forward is
:func:`gates_fwd` and whose backward is :func:`gates_bwd`. Each launches its
kernel on CUDA tensors (counted in ``.launches``) and runs its plain version,
:func:`gates_fwd_reference` / :func:`gates_bwd_reference`, on CPU tensors. A
failed build or launch raises ``RuntimeError``.
"""

from __future__ import annotations

import ctypes

import torch

from mlx_vae_tpu_torch.ops.build import load_library
from mlx_vae_tpu_torch.ops.lstm import gate_activations
from mlx_vae_tpu_torch.ops.train_common import check, raise_if, require_cuda, stream_of


# ----------------------------------------------------------- plain version

def gates_fwd_reference(gates: torch.Tensor, c: torch.Tensor):
    """Plain twin of the forward kernel: ``(h', c')``."""
    i, f, g, o = gate_activations(gates, c.shape[1])
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def gates_bwd_reference(gates: torch.Tensor, c: torch.Tensor, dh: torch.Tensor,
                        dc: torch.Tensor):
    """Plain twin of the backward kernel: ``(dgates [B, 4H], dc_prev [B, H])``."""
    i, f, g, o = gate_activations(gates, c.shape[1])
    tc = torch.tanh(f * c + i * g)
    dct = dc + dh * o * (1.0 - tc * tc)
    dgates = torch.cat([dct * g * i * (1.0 - i), dct * c * f * (1.0 - f),
                        dct * i * (1.0 - g * g), dh * tc * o * (1.0 - o)], dim=1)
    return dgates, dct * f


# ------------------------------------------------------------------ kernels

def build_library(verbose: bool = False) -> ctypes.CDLL:
    """Build ``csrc/fused_lstm_gates.cu`` (``ops/build.py``), load it and
    declare its C interface."""
    lib = load_library("fused_lstm_gates", verbose)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gates_fwd_launch.argtypes = [p] * 4 + [i] * 2 + [p]
    lib.gates_fwd_launch.restype = i
    lib.gates_bwd_launch.argtypes = [p] * 6 + [i] * 2 + [p]
    lib.gates_bwd_launch.restype = i
    lib.gates_error_string.argtypes = [i]
    lib.gates_error_string.restype = ctypes.c_char_p
    return lib


def _check_pair(gates: torch.Tensor, c: torch.Tensor, what: str):
    require_cuda(gates, what, None)
    B, H = c.shape
    check(gates, "gates", (B, 4 * H), torch.float32, gates.device)
    check(c, "c", (B, H), torch.float32, gates.device)
    return B, H


def gates_fwd(gates: torch.Tensor, c: torch.Tensor):
    """The forward (contract of :func:`gates_fwd_reference`; f32
    ``[B, 4H]`` and ``[B, H]``). CPU tensors run the plain version; CUDA
    tensors launch the kernel, counted in ``gates_fwd.launches``."""
    if gates.device.type == "cpu":
        return gates_fwd_reference(gates, c)
    B, H = _check_pair(gates, c, "fused_lstm_gates forward")
    h_out, c_out = torch.empty_like(c), torch.empty_like(c)
    lib = build_library()
    with torch.cuda.device(gates.device):
        rc = lib.gates_fwd_launch(gates.data_ptr(), c.data_ptr(), h_out.data_ptr(),
                                  c_out.data_ptr(), B, H, stream_of(gates.device))
    raise_if(rc, "fused_lstm_gates forward", lib.gates_error_string)
    gates_fwd.launches += 1
    return h_out, c_out


gates_fwd.launches = 0


def gates_bwd(gates: torch.Tensor, c: torch.Tensor, dh: torch.Tensor, dc: torch.Tensor):
    """The backward (contract of :func:`gates_bwd_reference`). CPU tensors
    run the plain version; CUDA tensors launch the kernel, counted in
    ``gates_bwd.launches``."""
    if gates.device.type == "cpu":
        return gates_bwd_reference(gates, c, dh, dc)
    B, H = _check_pair(gates, c, "fused_lstm_gates backward")
    check(dh, "dh", (B, H), torch.float32, gates.device)
    check(dc, "dc", (B, H), torch.float32, gates.device)
    dgates, dc_prev = torch.empty_like(gates), torch.empty_like(c)
    lib = build_library()
    with torch.cuda.device(gates.device):
        rc = lib.gates_bwd_launch(gates.data_ptr(), c.data_ptr(), dh.data_ptr(), dc.data_ptr(),
                                  dgates.data_ptr(), dc_prev.data_ptr(), B, H,
                                  stream_of(gates.device))
    raise_if(rc, "fused_lstm_gates backward", lib.gates_error_string)
    gates_bwd.launches += 1
    return dgates, dc_prev


gates_bwd.launches = 0


# ------------------------------------------------------------ autograd

class _FusedGates(torch.autograd.Function):

    @staticmethod
    def forward(ctx, gates, c):
        gates = gates.detach().float().contiguous()
        c = c.detach().float().contiguous()
        ctx.save_for_backward(gates, c)
        return gates_fwd(gates, c)

    @staticmethod
    def backward(ctx, dh, dc):
        gates, c = ctx.saved_tensors
        return gates_bwd(gates, c, dh.float().contiguous(), dc.float().contiguous())


def fused_lstm_gates(gates: torch.Tensor, c: torch.Tensor):
    """``(h', c')`` from pre-activation ``gates [B, 4H]`` and ``c [B, H]``,
    f32, through the kernel pair (``fused_lstm_gates``)."""
    return _FusedGates.apply(gates, c)
