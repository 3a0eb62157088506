"""Property predictor head: z -> predicted properties (counterpart of
``mlx_vae_tpu/models/predictor.py``)."""

from __future__ import annotations

import torch

from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.models.layers import init_linear, linear


def init_predictor_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return {
        "fc_hidden": init_linear(gen, cfg.latent_dim, cfg.hidden_dim),
        "fc_out": init_linear(gen, cfg.hidden_dim, cfg.num_conditions),
    }


def predictor_apply(params: dict, cfg: ModelConfig, z: torch.Tensor) -> torch.Tensor:
    h = torch.relu(linear(params["fc_hidden"], z, cfg.dtype))
    return linear(params["fc_out"], h, cfg.dtype)
