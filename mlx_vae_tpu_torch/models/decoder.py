"""Autoregressive conditional decoder pieces used by generation
(counterpart of ``mlx_vae_tpu/models/decoder.py:41-85``).

The initial state is h = (z_proj + cond_proj)/2 replicated over layers and
c = 0. ``decoder_apply`` (teacher-forced training/eval decode) waits for the
training slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.models.layers import init_embedding, init_linear, linear
from mlx_vae_tpu_torch.ops.lstm import init_lstm_params, lstm_cell


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
                           dtype=cfg.dtype)
        new_h.append(hl)
        new_c.append(cl)
        x = hl
    return x, torch.stack(new_h), torch.stack(new_c)
