"""Plain scan sampler (counterpart of ``mlx_vae_tpu/models/sampling.py``).

The JAX ``lax.scan`` becomes a Python loop over ``max_length`` steps. Rows
that emit ``end_token`` keep it in place and emit ``pad_token`` afterwards.
This sampler is the port's referee for the decoder path and the only
sampler that honours ``reference_zero_state``; the serving path runs the
fused kernel (``ops/fused_decoder.py``).
"""

from __future__ import annotations

import torch

from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.models.decoder import _stacked_cell, initialize_hidden_state
from mlx_vae_tpu_torch.models.layers import embedding, linear
from mlx_vae_tpu_torch.ops.sampling import sample_logits


@torch.no_grad()
def generate_with_temperature(
    params: dict,
    cfg: ModelConfig,
    z: torch.Tensor,
    conditions: torch.Tensor,
    generator: torch.Generator = None,
    max_length: int = 80,
    temperature=1.0,
    greedy: bool = False,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """Generate token sequences ``[B, max_length] int32``.

    ``generator`` draws the sampling noise (unused when ``greedy``) and must
    live on ``z``'s device.
    """
    B = z.shape[0]
    cond_f = conditions.float()
    h, c = initialize_hidden_state(params, cfg, z, cond_f)
    token = torch.full((B,), cfg.start_token, dtype=torch.int32, device=z.device)
    ended = torch.zeros((B,), dtype=torch.bool, device=z.device)
    out = []
    for _ in range(max_length):
        if cfg.reference_zero_state:
            h, c = torch.zeros_like(h), torch.zeros_like(c)
        emb = embedding(params["embedding"], token, cfg.dtype)
        x = torch.cat([emb.float(), cond_f], dim=1)
        top, h, c = _stacked_cell(params, cfg, x, h, c)
        logits = linear(params["fc_out"], top, cfg.dtype)
        sampled = sample_logits(logits, generator, temperature, greedy=greedy,
                                top_k=top_k, top_p=top_p)
        token = torch.where(ended, cfg.pad_token, sampled).to(torch.int32)
        ended = ended | (token == cfg.end_token)
        out.append(token)
    return torch.stack(out, dim=1)
