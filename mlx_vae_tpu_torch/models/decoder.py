"""Autoregressive conditional decoder (counterpart of
``mlx_vae_tpu/models/decoder.py``).

The initial state is h = (z_proj + cond_proj)/2 replicated over layers and
c = 0. ``decoder_apply`` is the teacher-forced decode: the per-step coin
flips ``tf_mask [L]`` come from the caller, the fed-back argmax carries no
gradient, and ``reference_zero_state`` restarts every step from zero state.
Routes of the teacher-forced decode (:func:`train_decoder_route`, the JAX
package's ``decoder_apply``), chosen from the config before any launch by
asking the kernels' predicates, all but the last only without
``reference_zero_state``:

* ``"fused"``: ``cfg.use_pallas``, the stack's weights fit in L2
  (``ops/train_common.py:stack_fits_l2``) and the fused training decoder's
  kernels take the configuration (``fused_train_decoder_supported``):
  ``ops/fused_train_decoder.py``.
* ``custom_vjp`` or H >= 768: ``"cvp"``, ``ops/decoder_cv.py``'s
  ``decoder_train_cvp``, with ``use_pallas`` where its kernels take the
  configuration (``decoder_cvp_supported``), else ``"cv"``,
  ``decoder_train_cv``.
* ``"scan"``: one ``lstm_cell`` per layer and step, with ``use_pallas``
  through the fused gate kernel pair (``ops/fused_lstm.py``), and the vocab
  head a product outside any kernel, as in the JAX scan.

The kernels launch on CUDA tensors and their plain versions run on CPU
tensors; a kernel that fails to build or launch raises.
Under a tensor-parallel ``mesh`` the teacher-forced decode always takes
the scan, with the vocab-parallel embedding, column-parallel gates and
vocab head, and split biases gathered at use (``models/layers.py``,
``ops/lstm.py``).
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
                    conditions: torch.Tensor, mesh=None) -> torch.Tensor:
    """The shared per-layer initial h ``[B, H]`` = (z_proj + cond_proj)/2."""
    hidden_z = linear(params["z_to_hidden"], z, cfg.dtype, mesh)
    hidden_c = linear(params["condition_to_hidden"], conditions, cfg.dtype, mesh)
    return (hidden_z + hidden_c) / 2.0


def initialize_hidden_state(params: dict, cfg: ModelConfig, z: torch.Tensor,
                            conditions: torch.Tensor, mesh=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h, c) ``[num_layers, B, H]``: h replicated over layers, c = 0."""
    row = hidden_init_row(params, cfg, z, conditions, mesh)
    h = row.unsqueeze(0).expand((cfg.num_layers,) + tuple(row.shape))
    return h, torch.zeros_like(h)


def _stacked_cell(params: dict, cfg: ModelConfig, x: torch.Tensor,
                  h: torch.Tensor, c: torch.Tensor, mesh=None):
    """One timestep through the layer stack. ``h/c [num_layers, B, H]``."""
    new_h, new_c = [], []
    for layer in range(cfg.num_layers):
        hl, cl = lstm_cell(params[f"lstm_layer_{layer}"], x, h[layer], c[layer],
                           dtype=cfg.dtype, use_pallas=cfg.use_pallas, mesh=mesh)
        new_h.append(hl)
        new_c.append(cl)
        x = hl
    return x, torch.stack(new_h), torch.stack(new_c)


def train_decoder_route(cfg: ModelConfig, device=None) -> str:
    """The teacher-forced decode's route (the module docstring's list):
    ``"fused"``, ``"cvp"``, ``"cv"`` or ``"scan"``. The same on every
    device, so ``device`` does not enter."""
    if cfg.reference_zero_state:
        return "scan"
    if cfg.use_pallas and stack_fits_l2(cfg):
        from mlx_vae_tpu_torch.ops.fused_train_decoder import fused_train_decoder_supported
        if fused_train_decoder_supported(cfg):
            return "fused"
    if cfg.custom_vjp or cfg.hidden_dim >= 768:
        from mlx_vae_tpu_torch.ops.decoder_cv import decoder_cvp_supported
        return "cvp" if cfg.use_pallas and decoder_cvp_supported(cfg) else "cv"
    return "scan"


def decoder_apply(params: dict, cfg: ModelConfig, z: torch.Tensor,
                  conditions: torch.Tensor, target_seq: Optional[torch.Tensor] = None,
                  max_length: int = 80, tf_mask: Optional[torch.Tensor] = None,
                  mesh=None) -> torch.Tensor:
    """Autoregressive decode -> logits ``[B, L, vocab]`` f32.

    With ``target_seq [B, L]``, ``tf_mask [L]`` (bool) is required: the
    token fed at step t+1 is ``target_seq[:, t]`` where ``tf_mask[t]``, else
    the argmax of step t's logits. Without it, L = ``max_length`` with pure
    argmax feedback. ``mesh``: the tensor-parallel mesh whose model group
    splits ``params`` (None: one device).
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
        route = "scan" if mesh is not None else train_decoder_route(cfg)
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

    h, c = initialize_hidden_state(params, cfg, z, cond_f, mesh)
    token = torch.full((B,), cfg.start_token, dtype=torch.int32, device=dev)
    logits_all = []
    for t in range(L):
        if cfg.reference_zero_state:
            h, c = torch.zeros_like(h), torch.zeros_like(c)
        emb = embedding(params["embedding"], token, cfg.dtype, onehot=cfg.embed_onehot,
                        mesh=mesh, num_embeddings=cfg.vocab_size)
        x = torch.cat([emb.float(), cond_f], dim=1)
        out, h, c = _stacked_cell(params, cfg, x, h, c, mesh)
        logits = linear(params["fc_out"], out, cfg.dtype, mesh, cfg.vocab_size)
        pred = torch.argmax(logits.detach(), dim=1).to(torch.int32)
        token = torch.where(tf_mask[t], targets[:, t], pred)
        logits_all.append(logits)
    return torch.stack(logits_all, dim=1)
