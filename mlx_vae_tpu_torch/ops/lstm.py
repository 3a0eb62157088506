"""LSTM cell ops (counterpart of ``mlx_vae_tpu/ops/lstm.py``).

Parameter layout mirrors MLX ``nn.LSTM``: ``{"Wx": [4H, in], "Wh": [4H, H],
"bias": [4H]}``, gate order (i, f, g, o), ``c' = σ(f)·c + σ(i)·tanh(g)``,
``h' = σ(o)·tanh(c')``. One ``[x, h] @ W_cat`` matmul per step with inputs
cast to the compute dtype and float32 accumulation. The sequence and
custom-VJP variants wait for the training slice.
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


def lstm_gates(gates: torch.Tensor, c: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Elementwise LSTM update from pre-activation ``gates [..., 4H]``."""
    h = c.shape[-1]
    i = torch.sigmoid(gates[..., :h])
    f = torch.sigmoid(gates[..., h:2 * h])
    g = torch.tanh(gates[..., 2 * h:3 * h])
    o = torch.sigmoid(gates[..., 3 * h:])
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def combined_weight(params: dict) -> torch.Tensor:
    """``[in + H, 4H]`` fused input+recurrent weight."""
    return torch.cat([params["Wx"].T, params["Wh"].T], dim=0)


def lstm_cell(params: dict, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              dtype=torch.float32):
    """One LSTM step: ``x [B, in]``, ``h/c [B, H]`` -> ``(h', c')``."""
    inp = torch.cat([x, h], dim=1)
    gates = mm_f32(inp, combined_weight(params), dtype) + params["bias"].float()
    return lstm_gates(gates, c)
