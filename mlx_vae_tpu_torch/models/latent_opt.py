"""Latent-space property optimization (counterpart of
``mlx_vae_tpu/models/latent_opt.py``): gradient-based molecular design.

A batch ``[B, latent]`` of independent candidates descends, per row,

    ||predictor(z) - target||^2  +  prior_weight * ||z||^2 / latent_dim

by plain bias-corrected Adam (b1 0.9, b2 0.999, eps 1e-8 added after the
square root; unrelated to the trainer's MLX-parity variant in
``train/optim.py``), each update followed by a per-coordinate clip to
``[-z_clip, z_clip]``. The quadratic prior term keeps the candidates where
the decoder was trained (``mu`` is tanh-bounded to [-2, 2],
``models/encoder.py``).

The JAX version is one jitted ``lax.scan`` of two XLA matmuls a step, with
no Pallas kernel; here it is a loop of ``steps`` updates on ``z0``'s
device, its products plain ``torch`` ops. The predictor's params carry no
gradient: ``z`` is the only leaf. The objective trajectory stays on the
device until the caller reads it.
"""

from __future__ import annotations

import torch

from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.models.predictor import predictor_apply
from mlx_vae_tpu_torch.utils.tree import tree_map


def latent_objective(predictor_params: dict, cfg: ModelConfig, z: torch.Tensor,
                     target, prior_weight: float = 0.0) -> torch.Tensor:
    """Per-candidate objective ``[B]`` (lower is better).

    ``target`` is in NORMALIZED property units (z-scored by the train-set
    stats, what the predictor was trained against) and broadcasts from
    ``[C]`` or ``[B, C]``.
    """
    pred = predictor_apply(predictor_params, cfg, z)
    target = torch.as_tensor(target, dtype=torch.float32, device=pred.device)
    mse = torch.sum((pred - target.expand(pred.shape)) ** 2, dim=-1)
    if prior_weight:
        mse = mse + prior_weight * torch.mean(z ** 2, dim=-1)
    return mse


def optimize_latent(params: dict, cfg: ModelConfig, z0: torch.Tensor, target, *,
                    steps: int = 300, lr: float = 0.05, prior_weight: float = 0.01,
                    z_clip: float = 3.0):
    """Descend the latent objective from ``z0 [B, latent]``.

    ``params`` is the model tree; its ``"predictor"`` leaves are tensors on
    ``z0``'s device. Returns ``(z_opt, info)``: ``info["objective"]`` is the
    batch-mean objective ``[steps + 1]`` (entry ``t`` at the iterate after
    ``t`` updates: each step's pre-update value, then the final iterate's),
    ``info["pred_init"]`` and ``info["pred_final"]`` the predictions at
    ``z0`` and ``z_opt`` (normalized units). The summed objective makes each
    row's gradient that of optimizing the row alone.
    """
    if "predictor" not in params:
        raise ValueError(
            "checkpoint has no predictor head — latent optimization needs a "
            "model trained with --use_property_predictor (lambda_prop > 0)")
    pp = tree_map(torch.Tensor.detach, params["predictor"])
    z0 = z0.detach().float()
    dev = z0.device
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    b1, b2, eps = 0.9, 0.999, 1e-8
    z, m, v = z0, torch.zeros_like(z0), torch.zeros_like(z0)
    t = torch.zeros((), dtype=torch.float32, device=dev)  # f32 step count, as JAX's
    traj = []
    for _ in range(steps):
        with torch.enable_grad():
            zg = z.detach().requires_grad_(True)
            loss = torch.sum(latent_objective(pp, cfg, zg, target, prior_weight))
            (g,) = torch.autograd.grad(loss, zg)
        with torch.no_grad():
            t = t + 1
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mhat = m / (1 - b1 ** t)
            vhat = v / (1 - b2 ** t)
            z = z - lr * mhat / (torch.sqrt(vhat) + eps)
            z = torch.clamp(z, -z_clip, z_clip)
            traj.append(loss.detach() / z.shape[0])
    with torch.no_grad():
        final = torch.mean(latent_objective(pp, cfg, z, target, prior_weight))
        info = {
            "objective": torch.stack(traj + [final]),
            "pred_init": predictor_apply(pp, cfg, z0),
            "pred_final": predictor_apply(pp, cfg, z),
        }
    return z, info
