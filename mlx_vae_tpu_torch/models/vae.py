"""Prior sampling (counterpart of ``mlx_vae_tpu/models/vae.py:vae_generate``).

Draws z ~ N(0, I) and decodes it with the fused sampler
(``ops/fused_decoder.py``): on CUDA tensors that is the kernel, on CPU
tensors its plain version; neither implements ``reference_zero_state``
(the plain scan sampler ``models/sampling.py`` does). The ``ARCVAE`` facade
waits for the encoder slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.models.decoder import hidden_init_row
from mlx_vae_tpu_torch.ops.fused_decoder import (FusedWeights, block_rows,
                                                 fused_generate, prepare_weights)


@torch.no_grad()
def vae_generate(params: dict, cfg: ModelConfig, conditions: torch.Tensor,
                 generator: torch.Generator, max_length: int = 80,
                 temperature: float = 1.0, greedy: bool = False,
                 top_k: int = 0, top_p: float = 1.0,
                 weights: Optional[FusedWeights] = None) -> torch.Tensor:
    """Sample ``[B, max_length]`` int32 tokens for ``conditions [B, C]``.

    ``params`` is the model tree (``{"decoder": ...}``) as tensors on the
    conditions' device, and ``generator`` (on that device too) draws z, then
    one sampler seed per ``block_rows(B)`` rows. ``weights`` are the
    decoder's prepared kernel weights; pass them to reuse one preparation
    across calls.
    """
    dev = conditions.device
    B = conditions.shape[0]
    dec = params["decoder"]
    z = torch.randn((B, cfg.latent_dim), generator=generator, device=dev)
    cond = conditions.float().contiguous()
    nb = -(-B // block_rows(B))
    seeds = torch.randint(0, 2**31 - 1, (nb,), generator=generator,
                          device=dev, dtype=torch.int32)
    temps = torch.full((nb,), float(temperature), dtype=torch.float32, device=dev)
    if weights is None:
        weights = prepare_weights(dec, cfg, dev)
    h0 = hidden_init_row(dec, cfg, z, cond).contiguous()
    return fused_generate(weights, h0, cond, seeds, temps, max_length,
                          greedy=greedy, top_k=top_k, top_p=top_p)
