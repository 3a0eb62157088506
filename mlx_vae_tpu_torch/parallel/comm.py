"""The collectives of multi-device training, built on ``all_reduce`` alone.

gloo takes CUDA tensors for ``all_reduce`` and ``broadcast`` only, and NCCL
takes everything, so writing every collective as an all-reduce gives one
code path under gloo on the CPU, under gloo with two ranks sharing one card
(NCCL refuses two ranks on one GPU) and under NCCL across cards.

* :func:`grad_mean_`: the data-parallel gradient mean (``jax.lax.pmean``
  over ``'data'``), one flat bucket per dtype.
* :func:`reduce_metrics`: the step's metrics across the data group by the
  rules of ``mlx_vae_tpu/train/steps.py:_reduce_metrics_over`` (mean; max
  for ``mu_abs_max`` and ``logvar_max``; min for ``logvar_min``).
* Four autograd functions for the tensor-parallel route (what GSPMD
  inserts): :func:`copy_to_model`, :func:`gather_from_model`,
  :func:`reduce_from_model` and :func:`gather_rows_over_data`.

A gather here is an all-reduce of a zero-filled buffer that holds this
rank's block: exact (``x + 0 = x``), but it moves ``n`` times the bytes of
``all_gather_into_tensor``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mlx_vae_tpu_torch.utils.tree import tree_leaves

_MAX_KEYS = ("mu_abs_max", "logvar_max")
_MIN_KEYS = ("logvar_min",)


@torch.no_grad()
def grad_mean_(trees, group):
    """Average every leaf of the sequence of trees ``trees`` over ``group``
    in place: one all-reduce of one flat buffer per dtype, divided by the
    group's size. Returns ``trees``."""
    n = dist.get_world_size(group)
    by_dtype = {}
    for leaf in (x for t in trees for x in tree_leaves(t)):
        by_dtype.setdefault(leaf.dtype, []).append(leaf)
    for leaves in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in leaves])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        o = 0
        for g in leaves:
            g.copy_(flat[o:o + g.numel()].view_as(g))
            o += g.numel()
    return trees


@torch.no_grad()
def reduce_metrics(metrics: dict, group) -> dict:
    """The data group's metrics: the mean of each, the max of
    ``mu_abs_max`` / ``logvar_max`` and the min of ``logvar_min`` (two
    all-reduces: the min rides the max as its negation)."""
    n = dist.get_world_size(group)
    mean_keys = [k for k in metrics if k not in _MAX_KEYS + _MIN_KEYS]
    ext_keys = [k for k in metrics if k in _MAX_KEYS + _MIN_KEYS]
    out = {}
    if mean_keys:
        v = torch.stack([metrics[k].float() for k in mean_keys])
        dist.all_reduce(v, group=group)
        v = v / n
        out.update({k: v[i] for i, k in enumerate(mean_keys)})
    if ext_keys:
        v = torch.stack([-metrics[k].float() if k in _MIN_KEYS else metrics[k].float()
                         for k in ext_keys])
        dist.all_reduce(v, op=dist.ReduceOp.MAX, group=group)
        out.update({k: -v[i] if k in _MIN_KEYS else v[i] for i, k in enumerate(ext_keys)})
    return {k: out[k] for k in metrics}


def all_gather_rows(x: torch.Tensor, n: int, index: int, group, dim: int = 0) -> torch.Tensor:
    """The ``n`` ranks' blocks of ``group`` concatenated along ``dim``, this
    rank's at block ``index``: an all-reduce of a zero-filled buffer."""
    shape = list(x.shape)
    k = shape[dim]
    shape[dim] = n * k
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    out.narrow(dim, index * k, k).copy_(x)
    dist.all_reduce(out, group=group)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.model_group)
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.k = mesh, dim, x.shape[dim]
        return all_gather_rows(x.contiguous(), mesh.model, mesh.model_rank,
                               mesh.model_group, dim)

    @staticmethod
    def backward(ctx, grad):
        m = ctx.mesh.model_rank
        return grad.narrow(ctx.dim, m * ctx.k, ctx.k).contiguous(), None, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=mesh.model_group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherRowsOverData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.k = mesh, x.shape[0]
        return all_gather_rows(x.contiguous(), mesh.data, mesh.data_rank, mesh.data_group)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        return grad.narrow(0, mesh.data_rank * ctx.k, ctx.k) * mesh.data, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Forward identity; backward sums the gradient over the model group
    (the input of a column-parallel product, whose local slice sees only
    its own columns' part of the gradient)."""
    return _CopyToModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    """Forward: the model group's blocks of ``x`` concatenated along
    ``dim``; backward: this rank's block of the (replicated) gradient."""
    return _GatherFromModel.apply(x, mesh, dim % x.dim())


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Forward: the sum over the model group; backward: identity."""
    return _ReduceFromModel.apply(x, mesh)


def gather_rows_over_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """Forward: every data rank's rows of ``x`` in data-rank order. Backward:
    this rank's rows of the gradient, times the data size, because every
    data rank computes the same function of the gathered rows and the
    gradient mean over the data group divides by that size."""
    return _GatherRowsOverData.apply(x, mesh)


def host_gather_rows(mesh, blocks: list) -> list:
    """Every data rank's ``blocks`` (a list of numpy row blocks, one per
    batch) joined batch by batch in data-rank order, over the host group."""
    import numpy as np

    every = [None] * mesh.data
    dist.all_gather_object(every, blocks, group=mesh.host_group)
    return [np.concatenate([every[r][i] for r in range(mesh.data)])
            for i in range(len(blocks))]
