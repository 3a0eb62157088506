"""Adam and global-norm gradient clipping (counterpart of
``mlx_vae_tpu/train/optim.py``).

The MLX reference's Adam has no bias correction (``m / (sqrt(v) + eps)``);
``bias_correction=True`` gives standard Adam. Clipping scales every grad by
``max_norm / (norm + 1e-8)`` only when the joint norm exceeds ``max_norm``,
with tensor ops (no host sync).

The JAX step donates params and optimizer states and returns new ones;
here :func:`adam_update` updates them IN PLACE under ``torch.no_grad()`` and
returns the same dicts, so the caller's tensors hold the new values.
"""

from __future__ import annotations

import torch

from mlx_vae_tpu_torch.utils.tree import global_norm, tree_leaves, tree_map, tree_zeros_like


def adam_init(params) -> dict:
    step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
    return {"step": step, "m": tree_zeros_like(params), "v": tree_zeros_like(params)}


@torch.no_grad()
def adam_update(params, grads, state, lr, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8, bias_correction: bool = False):
    """One Adam step, in place on ``params`` and ``state``. Returns
    ``(params, state)``."""
    state["step"] += 1
    if bias_correction:
        step = state["step"].float()
        c1, c2 = 1.0 - b1 ** step, 1.0 - b2 ** step

    def update(p, g, m, v):
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        if bias_correction:
            p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + eps))
        else:
            p.sub_(lr * m / (torch.sqrt(v) + eps))

    tree_map(update, params, grads, state["m"], state["v"])
    return params, state


def clip_by_global_norm(grads_trees: tuple, max_norm: float):
    """Jointly clip a tuple of grad trees. Returns ``(clipped_trees, norm)``."""
    norm = global_norm(*grads_trees)
    scale = torch.where(norm > max_norm, max_norm / (norm + 1e-8), torch.ones_like(norm))
    return tuple(tree_map(lambda g: g * scale, t) for t in grads_trees), norm
