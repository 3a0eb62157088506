"""LSTM cell ops (counterpart of ``mlx_vae_tpu/ops/lstm.py``).

Parameter layout mirrors MLX ``nn.LSTM``: ``{"Wx": [4H, in], "Wh": [4H, H],
"bias": [4H]}``, gate order (i, f, g, o), ``c' = σ(f)·c + σ(i)·tanh(g)``,
``h' = σ(o)·tanh(c')``. One ``[x, h] @ W_cat`` matmul per step with inputs
cast to the compute dtype and float32 accumulation. ``lstm_sequence`` is the
plain per-layer encoder path (autograd differentiates the loop);
``lstm_sequence_cv`` is the same forward with the hand-written backward of
the JAX package's custom VJP (the encoder's plain route at H >= 768 or
``custom_vjp``). With ``use_pallas`` the gate tail runs as the fused gate
kernel pair (``ops/fused_lstm.py``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from mlx_vae_tpu_torch.models.layers import mm_f32, uniform_init


def init_lstm_params(gen: torch.Generator, input_size: int,
                     hidden_size: int) -> dict:
    """Uniform(-k, k) with k = 1/sqrt(hidden_size), matching MLX nn.LSTM."""
    scale = 1.0 / math.sqrt(hidden_size)
    return {
        "Wx": uniform_init(gen, (4 * hidden_size, input_size), scale),
        "Wh": uniform_init(gen, (4 * hidden_size, hidden_size), scale),
        "bias": uniform_init(gen, (4 * hidden_size,), scale),
    }


def gate_activations(gates: torch.Tensor, H: int):
    """``(σ(i), σ(f), tanh(g), σ(o))`` of pre-activation ``gates [..., 4H]``."""
    return (torch.sigmoid(gates[..., :H]), torch.sigmoid(gates[..., H:2 * H]),
            torch.tanh(gates[..., 2 * H:3 * H]), torch.sigmoid(gates[..., 3 * H:]))


def lstm_gates(gates: torch.Tensor, c: torch.Tensor, use_pallas: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Elementwise LSTM update from pre-activation ``gates [..., 4H]``. With
    ``use_pallas`` (2-D ``[B, 4H]`` gates) the fused gate kernel pair does
    it: the kernels on CUDA tensors, their plain versions on CPU tensors."""
    if use_pallas and gates.dim() == 2:
        from mlx_vae_tpu_torch.ops.fused_lstm import fused_lstm_gates
        return fused_lstm_gates(gates, c)
    i, f, g, o = gate_activations(gates, c.shape[-1])
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def combined_weight(params: dict) -> torch.Tensor:
    """``[in + H, 4H]`` fused input+recurrent weight."""
    return torch.cat([params["Wx"].T, params["Wh"].T], dim=0)


def lstm_cell(params: dict, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              dtype=torch.float32, use_pallas: bool = False):
    """One LSTM step: ``x [B, in]``, ``h/c [B, H]`` -> ``(h', c')``."""
    inp = torch.cat([x, h], dim=1)
    gates = mm_f32(inp, combined_weight(params), dtype) + params["bias"].float()
    return lstm_gates(gates, c, use_pallas)


def lstm_sequence(params: dict, xs: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                  dtype=torch.float32) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence LSTM: ``xs [B, L, in]`` -> ``(outputs [B, L, H], (h, c))``,
    one fused ``[x_t, h] @ W`` matmul + gate update per step (autograd
    differentiates the loop). JAX's ``unroll`` and ``remat`` are XLA
    scheduling knobs with no counterpart here."""
    w = combined_weight(params)
    bias = params["bias"].float()
    h, c = h0, c0
    outs = []
    for t in range(xs.shape[1]):
        gates = mm_f32(torch.cat([xs[:, t], h], dim=1), w, dtype) + bias
        h, c = lstm_gates(gates, c)
        outs.append(h)
    return torch.stack(outs, dim=1), (h, c)


class _SeqCV(torch.autograd.Function):
    """``lstm_sequence`` whose backward is the JAX package's hand-written
    one: the forward stores the pre-activation gates in the compute dtype;
    the backward runs a reverse loop that only threads the (dh, dc) chain
    (one ``dgates @ Wh`` per step) and emits dgates, then forms dWx, dWh
    and dxs as single products over the flattened ``[L*B, .]`` rows."""

    @staticmethod
    def forward(ctx, dtype, xs, h0, c0, wx, wh, bias):
        w = torch.cat([wx.T, wh.T], dim=0)
        b = bias.float()
        h, c = h0.float(), c0.float()
        hs, cs, gates_t = [], [], []
        for t in range(xs.shape[1]):
            gates = mm_f32(torch.cat([xs[:, t], h], dim=1), w, dtype) + b
            h, c = lstm_gates(gates, c)
            hs.append(h)
            cs.append(c)
            gates_t.append(gates.to(dtype))
        hs_t, cs_t, gates_t = torch.stack(hs), torch.stack(cs), torch.stack(gates_t)
        ctx.save_for_backward(xs, h0, c0, wx, wh, hs_t, cs_t, gates_t)
        ctx.dtype = dtype
        return hs_t.transpose(0, 1).contiguous(), h, c

    @staticmethod
    def backward(ctx, dhs, dhf, dcf):
        xs, h0, c0, wx, wh, hs_t, cs_t, gates_t = ctx.saved_tensors
        dtype = ctx.dtype
        L, B, H = hs_t.shape
        dhs_t = dhs.transpose(0, 1).float()
        c_prev_t = torch.cat([c0.float()[None], cs_t[:-1]], dim=0)
        dh, dc = dhf.float(), dcf.float()
        dgates_t = []
        for t in range(L - 1, -1, -1):
            i, f, gg, o = gate_activations(gates_t[t].float(), H)
            tc = torch.tanh(cs_t[t])
            dh_total = dh + dhs_t[t]
            dc_tot = dc + dh_total * o * (1.0 - tc * tc)
            dgates = torch.cat([dc_tot * gg * i * (1.0 - i), dc_tot * c_prev_t[t] * f * (1.0 - f),
                                dc_tot * i * (1.0 - gg * gg), dh_total * tc * o * (1.0 - o)],
                               dim=1)
            dh = mm_f32(dgates, wh, dtype)
            dc = dc_tot * f
            dgates_t.append(dgates.to(dtype))
        dg = torch.stack(dgates_t[::-1]).reshape(L * B, 4 * H)
        h_prev = torch.cat([h0.float()[None], hs_t[:-1]], dim=0).reshape(L * B, H)
        xs_flat = xs.transpose(0, 1).reshape(L * B, -1)
        dwx = mm_f32(dg.T, xs_flat, dtype)
        dwh = mm_f32(dg.T, h_prev, dtype)
        dxs = mm_f32(dg, wx, dtype).reshape(L, B, -1).transpose(0, 1).to(xs.dtype)
        return None, dxs, dh, dc, dwx, dwh, dg.float().sum(dim=0)


def lstm_sequence_cv(params: dict, xs: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                     dtype=torch.float32
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """``lstm_sequence`` with the hand-written backward (``lstm_sequence_cv``
    of the JAX package): ``xs [B, L, in]`` -> ``(outputs [B, L, H], (h, c))``,
    f32."""
    hs, h, c = _SeqCV.apply(dtype, xs, h0, c0, params["Wx"], params["Wh"], params["bias"])
    return hs, (h, c)
