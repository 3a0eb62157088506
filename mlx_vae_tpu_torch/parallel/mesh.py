"""The ``(data, model)`` mesh over ``torch.distributed`` ranks (counterpart
of ``mlx_vae_tpu/parallel/mesh.py``).

JAX runs one controller over every device and names a mesh of them; here
each device is one process (a rank), and a :class:`Mesh` is what one rank
knows of the grid: its sizes, this rank's coordinates (row-major like the
JAX ``make_mesh`` reshape, so rank index = d * model + m), the process
groups of its data row and its model column, and a gloo group over the
mesh's ranks for host-side gathers.

Tensor parallelism shards the leaves that :func:`param_pspec` names on the
``model`` axis as contiguous row blocks by model rank (the JAX table:
embeddings and ``fc_out`` by vocabulary rows, LSTM ``Wx`` / ``Wh`` by gate
rows, and every leaf named ``bias``); a leaf whose dimension does not divide
stays replicated, as ``shard_params`` of the JAX package places it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from mlx_vae_tpu_torch.utils.tree import tree_map

# Trailing key names of the leaves that shard on 'model' (dimension 0).
_MODEL_SHARDED = (
    ("embedding", "weight"),
    ("fc_out", "weight"),
    ("fc_out", "bias"),
    ("Wx",),
    ("Wh",),
    ("bias",),
)


@dataclass(frozen=True)
class Mesh:
    """This rank's view of a ``(data, model)`` grid of ranks."""

    data: int
    model: int
    data_rank: int
    model_rank: int
    ranks: tuple
    data_group: object
    model_group: object
    host_group: object

    @property
    def index(self) -> int:
        """This rank's position in the mesh (``d * model + m``)."""
        return self.data_rank * self.model + self.model_rank

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}


def world_size() -> int:
    """Ranks in the default process group (1 when there is none)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def torchrun_env() -> bool:
    """Whether torchrun's environment names this process's rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device) -> torch.device:
    """The device this rank computes on: on CUDA the card the process has
    selected (``torch.cuda.set_device``), or ``device`` as given when it
    names an index; the CPU as is."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def init_distributed(device, backend: Optional[str] = None) -> torch.device:
    """Join the default process group and return this rank's device.

    An already-initialized group is used as it is. Otherwise torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``) gives the rendezvous; on CUDA the rank takes card
    ``LOCAL_RANK`` modulo the visible cards. The backend defaults to nccl
    on CUDA and gloo on the CPU. Without either, nothing is initialized.
    """
    device = torch.device(device)
    if not dist.is_initialized() and torchrun_env():
        if device.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", "0"))
            torch.cuda.set_device(local % torch.cuda.device_count())
        dist.init_process_group(backend or default_backend(device), init_method="env://")
    return rank_device(device)


def make_mesh(model_parallel: int = 1, ranks: Optional[Sequence[int]] = None
              ) -> Optional[Mesh]:
    """A ``(len(ranks) // model_parallel, model_parallel)`` mesh over
    ``ranks`` (default: every rank of the default group). Collective: every
    rank of the default group calls it, in the same order; a rank outside
    ``ranks`` gets None."""
    world = world_size()
    ranks = tuple(range(world) if ranks is None else ranks)
    tp = max(1, model_parallel)
    n = len(ranks)
    if n % tp != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={tp}")
    nd = n // tp
    grid = np.asarray(ranks).reshape(nd, tp)
    me = rank()
    data_group = model_group = None
    for m in range(tp):  # every rank creates every group, in one order
        g = dist.new_group([int(r) for r in grid[:, m]])
        if me in grid[:, m]:
            data_group = g
    for d in range(nd):
        g = dist.new_group([int(r) for r in grid[d]])
        if me in grid[d]:
            model_group = g
    host_group = dist.new_group(list(ranks), backend="gloo")
    if me not in ranks:
        return None
    i = ranks.index(me)
    return Mesh(data=nd, model=tp, data_rank=i // tp, model_rank=i % tp, ranks=ranks,
                data_group=data_group, model_group=model_group, host_group=host_group)


def fold_seed(seed: int, index: int) -> int:
    """A generator seed for shard ``index`` of a run seeded ``seed``: the
    counterpart of ``jax.random.fold_in(key, axis_index)``."""
    return int(np.random.SeedSequence([int(seed), int(index)]).generate_state(1)[0])


def param_pspec(path: tuple) -> Optional[str]:
    """``"model"`` where a leaf at ``path`` (its key names) shards its
    dimension 0 on the model axis, else None (replicated); the JAX table,
    keyed by the trailing names, so ``("bias",)`` matches every bias."""
    names = tuple(path)
    for suffix in _MODEL_SHARDED:
        if names[-len(suffix):] == suffix:
            return "model"
    return None


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_layout(tree, model_parallel: int):
    """A tree of bools beside ``tree`` (full arrays): True where the leaf is
    split over ``model_parallel`` ranks, False where it is replicated (no
    model axis in its spec, or a dimension 0 that does not divide)."""
    def split(path, leaf):
        return (model_parallel > 1 and param_pspec(path) is not None
                and leaf.ndim > 0 and leaf.shape[0] % model_parallel == 0)
    return _map_with_path(split, tree)


def shard_params(mesh: Mesh, tree, layout):
    """This rank's part of a tree of full tensors: the contiguous row block
    ``model_rank`` of each split leaf (``layout``), the rest as it is."""
    def local(leaf, split):
        if not split:
            return leaf
        k = leaf.shape[0] // mesh.model
        return leaf[mesh.model_rank * k:(mesh.model_rank + 1) * k].clone()
    return tree_map(local, tree, layout)


@torch.no_grad()
def gather_params(mesh: Mesh, tree, layout):
    """Fresh full tensors of every leaf: this rank's part of each split leaf
    gathered over the model group (a collective: every rank of the mesh
    calls this), a copy of each replicated one."""
    from mlx_vae_tpu_torch.parallel.comm import all_gather_rows

    def full(leaf, split):
        return all_gather_rows(leaf, mesh.model, mesh.model_rank, mesh.model_group) \
            if split else leaf.detach().clone()
    return tree_map(full, tree, layout)


def visible_devices(device) -> int:
    """The cards a run on ``device`` could spread over (1 on the CPU)."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def build_kernels_once(device, sources: Sequence[str]) -> None:
    """On CUDA under a process group of several ranks: rank 0 builds those
    of ``sources`` (``csrc/<name>.cu``, the kernels the caller launches)
    that this checkout has not built, one ``nvcc`` each, all at once, while
    the others wait at a barrier; then each loads what it uses. Concurrent
    builds would be safe (``ops/build.py`` writes a per-process file and
    renames it) but redundant."""
    if torch.device(device).type != "cuda" or world_size() == 1:
        return
    if rank() == 0:
        from mlx_vae_tpu_torch.ops.build import compile_sources
        compile_sources(sources)
    dist.barrier()
