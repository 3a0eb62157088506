"""Multi-device training, evaluation and generation over ``torch.distributed``
(counterpart of ``mlx_vae_tpu/parallel``): one process per rank
(:mod:`.launch`), a ``(data, model)`` mesh of them (:mod:`.mesh`) and the
collectives the data-parallel and tensor-parallel steps use (:mod:`.comm`).
"""

from mlx_vae_tpu_torch.parallel.mesh import (
    Mesh,
    fold_seed,
    gather_params,
    init_distributed,
    make_mesh,
    param_layout,
    param_pspec,
    shard_params,
)

__all__ = [
    "Mesh",
    "fold_seed",
    "gather_params",
    "init_distributed",
    "make_mesh",
    "param_layout",
    "param_pspec",
    "shard_params",
]
