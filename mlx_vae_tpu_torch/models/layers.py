"""Shared functional layers (counterpart of ``mlx_vae_tpu/models/layers.py``).

Parameter naming/layout mirrors MLX modules (``weight [out, in]``, applied as
``x @ W^T + b``). Matmul inputs are cast to the compute dtype and the
product is accumulated in float32 — the JAX code's
``preferred_element_type=float32``. A product of two bf16 values is exact in
float32, so casting the rounded inputs back up and multiplying in float32 is
the same function.

Under a tensor-parallel mesh (``parallel/mesh.py``; the GSPMD route of the
JAX package) a layer's leaves may hold only this rank's row block:
:func:`linear` runs column-parallel where its weight is split (the vocab
head) and gathers a split bias at use, and :func:`embedding` is
vocab-parallel where its table is split. Without a mesh both are the
single-device functions.
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


def full_rows(t: torch.Tensor, n: int, mesh=None) -> torch.Tensor:
    """``t`` with all its ``n`` rows: gathered over the model group where
    this rank holds a block of them (a split bias, gathered at use)."""
    if mesh is None or t.shape[0] == n:
        return t
    from mlx_vae_tpu_torch.parallel.comm import gather_from_model
    return gather_from_model(t, mesh, dim=0)


def linear(params: dict, x: torch.Tensor, dtype=torch.float32, mesh=None,
           out_features: int = None) -> torch.Tensor:
    """``x @ W^T + b``. Under ``mesh``, a weight holding fewer than
    ``out_features`` rows (default: its own rows, i.e. replicated) is this
    rank's block of output columns: the product runs column-parallel and
    the model group's columns are gathered after."""
    w, b = params["weight"], params.get("bias")
    n = w.shape[0] if out_features is None else out_features
    if mesh is not None and w.shape[0] < n:
        from mlx_vae_tpu_torch.parallel.comm import copy_to_model, gather_from_model
        out = mm_f32(copy_to_model(x, mesh), w.T, dtype)
        if b is not None:
            out = out + b.float()
        return gather_from_model(out, mesh)
    out = mm_f32(x, w.T, dtype)
    if b is not None:
        out = out + full_rows(b, n, mesh).float()
    return out


def init_embedding(gen: torch.Generator, num_embeddings: int, dims: int) -> dict:
    """MLX ``nn.Embedding`` init: Normal(0, 1) * dims^-0.5."""
    w = torch.randn((num_embeddings, dims), generator=gen, dtype=torch.float32)
    return {"weight": w * (dims ** -0.5)}


def embedding(params: dict, ids: torch.Tensor, dtype=torch.float32,
              onehot: bool = False, mesh=None, num_embeddings: int = None) -> torch.Tensor:
    """Token lookup. ``onehot=True`` computes ``one_hot(ids) @ table`` as the
    JAX package does (its gradient is a matmul, not a scatter); both give
    the table's rows in ``dtype``. Under ``mesh`` a table of fewer than
    ``num_embeddings`` rows is this rank's vocabulary block: tokens outside
    it look up row 0, their rows are zeroed, and the model group's rows
    are summed."""
    w = params["weight"]
    if mesh is not None and num_embeddings is not None and w.shape[0] < num_embeddings:
        from mlx_vae_tpu_torch.parallel.comm import reduce_from_model
        k = w.shape[0]
        local = ids.long() - mesh.model_rank * k
        inside = (local >= 0) & (local < k)
        rows = embedding(params, torch.where(inside, local, 0), dtype, onehot)
        return reduce_from_model(rows.masked_fill(~inside[..., None], 0), mesh)
    w = w.to(dtype)
    if onehot:
        oh = torch.nn.functional.one_hot(ids.long(), w.shape[0]).to(dtype)
        return (oh.float() @ w.float()).to(dtype)
    return w[ids.long()]
