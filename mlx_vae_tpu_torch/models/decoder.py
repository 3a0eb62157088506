"""Autoregressive conditional decoder (counterpart of
``mlx_vae_tpu/models/decoder.py``).

The initial state is h = (z_proj + cond_proj)/2 replicated over layers and
c = 0. ``decoder_apply`` is the teacher-forced decode: the per-step coin
flips ``tf_mask [L]`` come from the caller, the fed-back argmax carries no
gradient, and ``reference_zero_state`` restarts every step from zero state.
Routes of the teacher-forced decode (the JAX package's ``decoder_apply``),
all but the last only without ``reference_zero_state``:

* ``cfg.use_pallas`` and the stack's weights fit in L2
  (``ops/train_common.py:stack_fits_l2``): the fused training decoder
  (``ops/fused_train_decoder.py``). On CUDA a configuration its kernels do
  not take raises ``NotImplementedError``; on the CPU it takes the routes
  below.
* ``custom_vjp`` or H >= 768: ``ops/decoder_cv.py``'s
  ``decoder_train_cvp`` with ``use_pallas`` (off the CPU always, on the CPU
  where ``decoder_cvp_supported``), else ``decoder_train_cv``.
* The scan, one ``lstm_cell`` per layer and step, with ``use_pallas``
  through the fused gate kernel pair (``ops/fused_lstm.py``).

The kernels launch on CUDA tensors; CPU tensors run their plain versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.models.layers import embedding, init_embedding, init_linear, linear
from mlx_vae_tpu_torch.ops.lstm import init_lstm_params, lstm_cell
from mlx_vae_tpu_torch.ops.train_common import stack_fits_l2


def init_decoder_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    params = {
        "z_to_hidden": init_linear(gen, cfg.latent_dim, cfg.hidden_dim),
        "condition_to_hidden": init_linear(gen, cfg.num_conditions, cfg.hidden_dim),
        "embedding": init_embedding(gen, cfg.vocab_size, cfg.embedding_dim),
    }
    for i in range(cfg.num_layers):
        in_size = cfg.embedding_dim + cfg.num_conditions if i == 0 else cfg.hidden_dim
        params[f"lstm_layer_{i}"] = init_lstm_params(gen, in_size, cfg.hidden_dim)
    params["fc_out"] = init_linear(gen, cfg.hidden_dim, cfg.vocab_size)
    return params


def hidden_init_row(params: dict, cfg: ModelConfig, z: torch.Tensor,
                    conditions: torch.Tensor) -> torch.Tensor:
    """The shared per-layer initial h ``[B, H]`` = (z_proj + cond_proj)/2."""
    hidden_z = linear(params["z_to_hidden"], z, cfg.dtype)
    hidden_c = linear(params["condition_to_hidden"], conditions, cfg.dtype)
    return (hidden_z + hidden_c) / 2.0


def initialize_hidden_state(params: dict, cfg: ModelConfig, z: torch.Tensor,
                            conditions: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h, c) ``[num_layers, B, H]``: h replicated over layers, c = 0."""
    row = hidden_init_row(params, cfg, z, conditions)
    h = row.unsqueeze(0).expand((cfg.num_layers,) + tuple(row.shape))
    return h, torch.zeros_like(h)


def _stacked_cell(params: dict, cfg: ModelConfig, x: torch.Tensor,
                  h: torch.Tensor, c: torch.Tensor):
    """One timestep through the layer stack. ``h/c [num_layers, B, H]``."""
    new_h, new_c = [], []
    for layer in range(cfg.num_layers):
        hl, cl = lstm_cell(params[f"lstm_layer_{layer}"], x, h[layer], c[layer],
                           dtype=cfg.dtype, use_pallas=cfg.use_pallas)
        new_h.append(hl)
        new_c.append(cl)
        x = hl
    return x, torch.stack(new_h), torch.stack(new_c)


def train_decoder_route(cfg: ModelConfig, device) -> str:
    """The teacher-forced decode's route on ``device`` (the module
    docstring's list): ``"fused"``, ``"cvp"``, ``"cv"`` or ``"scan"``."""
    on_cpu = torch.device(device).type == "cpu"
    if cfg.reference_zero_state:
        return "scan"
    if cfg.use_pallas and stack_fits_l2(cfg):
        from mlx_vae_tpu_torch.ops.fused_train_decoder import fused_train_decoder_supported
        # off the CPU the fused route launches its kernels or raises
        if not on_cpu or fused_train_decoder_supported(cfg):
            return "fused"
    if cfg.custom_vjp or cfg.hidden_dim >= 768:
        from mlx_vae_tpu_torch.ops.decoder_cv import decoder_cvp_supported
        return "cvp" if cfg.use_pallas and (not on_cpu or decoder_cvp_supported(cfg)) else "cv"
    return "scan"


def train_route_refusal(cfg: ModelConfig, device) -> Optional[str]:
    """Why the kernels of :func:`train_decoder_route` on ``device`` would
    refuse ``cfg`` (they raise ``NotImplementedError`` at their first
    launch; the JAX package routes such a config to its scan instead), or
    None. The CPU runs the plain versions and refuses nothing."""
    route = train_decoder_route(cfg, device)
    if torch.device(device).type == "cpu":
        return None
    if route == "fused":
        from mlx_vae_tpu_torch.ops.fused_train_decoder import _unsupported_reason
        reason = _unsupported_reason(cfg)
        return None if reason is None else f"the fused training decoder does not take {reason}"
    if route == "cvp":
        from mlx_vae_tpu_torch.ops.decoder_cv import decoder_cvp_supported
        if not decoder_cvp_supported(cfg):
            return "the per-layer decoder kernels do not take this model"
    return None


def decoder_apply(params: dict, cfg: ModelConfig, z: torch.Tensor,
                  conditions: torch.Tensor, target_seq: Optional[torch.Tensor] = None,
                  max_length: int = 80, tf_mask: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Autoregressive decode -> logits ``[B, L, vocab]`` f32.

    With ``target_seq [B, L]``, ``tf_mask [L]`` (bool) is required: the
    token fed at step t+1 is ``target_seq[:, t]`` where ``tf_mask[t]``, else
    the argmax of step t's logits. Without it, L = ``max_length`` with pure
    argmax feedback.
    """
    B = z.shape[0]
    dev = z.device
    cond_f = conditions.float()
    if target_seq is not None:
        L = target_seq.shape[1]
        if tf_mask is None:
            raise ValueError("decoder_apply with target_seq requires tf_mask")
        targets = target_seq.to(torch.int32)
        tf_mask = tf_mask.to(dev).bool()
        route = train_decoder_route(cfg, dev)
        if route == "fused":
            from mlx_vae_tpu_torch.ops.fused_train_decoder import decoder_train
            h_init = hidden_init_row(params, cfg, z, cond_f)
            return decoder_train(params, cfg, h_init, cond_f, targets, tf_mask)
        if route in ("cvp", "cv"):
            from mlx_vae_tpu_torch.ops.decoder_cv import decoder_train_cv, decoder_train_cvp
            h_init = hidden_init_row(params, cfg, z, cond_f)
            run = decoder_train_cvp if route == "cvp" else decoder_train_cv
            return run(params, cfg, h_init, cond_f, targets, tf_mask)
    else:
        L = max_length
        targets = torch.zeros((B, L), dtype=torch.int32, device=dev)
        tf_mask = torch.zeros((L,), dtype=torch.bool, device=dev)

    h, c = initialize_hidden_state(params, cfg, z, cond_f)
    token = torch.full((B,), cfg.start_token, dtype=torch.int32, device=dev)
    logits_all = []
    for t in range(L):
        if cfg.reference_zero_state:
            h, c = torch.zeros_like(h), torch.zeros_like(c)
        emb = embedding(params["embedding"], token, cfg.dtype, onehot=cfg.embed_onehot)
        x = torch.cat([emb.float(), cond_f], dim=1)
        out, h, c = _stacked_cell(params, cfg, x, h, c)
        logits = linear(params["fc_out"], out, cfg.dtype)
        pred = torch.argmax(logits.detach(), dim=1).to(torch.int32)
        token = torch.where(tf_mask[t], targets[:, t], pred)
        logits_all.append(logits)
    return torch.stack(logits_all, dim=1)
