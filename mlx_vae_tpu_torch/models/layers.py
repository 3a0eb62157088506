"""Shared functional layers (counterpart of ``mlx_vae_tpu/models/layers.py``).

Parameter naming/layout mirrors MLX modules (``weight [out, in]``, applied as
``x @ W^T + b``). Matmul inputs are cast to the compute dtype and the
product is accumulated in float32 — the JAX code's
``preferred_element_type=float32``. A product of two bf16 values is exact in
float32, so casting the rounded inputs back up and multiplying in float32 is
the same function.
"""

from __future__ import annotations

import math

import torch


def uniform_init(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0 - 1.0) * scale


def init_linear(gen: torch.Generator, in_features: int, out_features: int,
                bias: bool = True) -> dict:
    """MLX ``nn.Linear`` init: Uniform(-k, k), k = 1/sqrt(in_features)."""
    scale = 1.0 / math.sqrt(in_features)
    p = {"weight": uniform_init(gen, (out_features, in_features), scale)}
    if bias:
        p["bias"] = uniform_init(gen, (out_features,), scale)
    return p


def mm_f32(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """``x @ w`` with both operands rounded to ``dtype``, accumulated in f32."""
    return x.to(dtype).float() @ w.to(dtype).float()


def linear(params: dict, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    out = mm_f32(x, params["weight"].T, dtype)
    if "bias" in params:
        out = out + params["bias"].float()
    return out


def init_embedding(gen: torch.Generator, num_embeddings: int, dims: int) -> dict:
    """MLX ``nn.Embedding`` init: Normal(0, 1) * dims^-0.5."""
    w = torch.randn((num_embeddings, dims), generator=gen, dtype=torch.float32)
    return {"weight": w * (dims ** -0.5)}


def embedding(params: dict, ids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Token lookup as a row read (the JAX one-hot matmul is a TPU idiom
    for the same function)."""
    return params["weight"].to(dtype)[ids.long()]
