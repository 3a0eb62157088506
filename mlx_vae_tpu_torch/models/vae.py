"""The VAE's forward and prior sampling (counterpart of
``mlx_vae_tpu/models/vae.py:vae_forward`` and ``vae_generate``).

``vae_forward`` is encode -> reparameterize -> teacher-forced decode to
logits; with ``cfg.use_pallas`` it runs the fused encoder and the logits
specialization of the fused training decoder. ``vae_generate`` draws
z ~ N(0, I) and decodes it with the sampler the config takes
(:func:`generation_sampler`, as the JAX package routes): the fused sampler
(``ops/fused_decoder.py``; on CUDA tensors the kernel, on CPU tensors its
plain version) when ``cfg.use_pallas`` and the kernel takes the config,
else the plain scan sampler (``models/sampling.py``), which also honours
``reference_zero_state``.

``ARCVAE`` is the facade (``mlx_vae_tpu/models/vae.py:ARCVAE``): one param
tree with ``__call__`` and ``generate``. It draws its initial params from a
``torch.Generator`` (encoder, decoder, then the predictor, in turn from one
generator), where the JAX facade splits a threefry key three ways: the
shapes, key names and uniform scales are the same, the draws are not.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.models.decoder import (decoder_apply, hidden_init_row,
                                               init_decoder_params)
from mlx_vae_tpu_torch.models.encoder import (encoder_apply, init_encoder_params,
                                               reparameterize)
from mlx_vae_tpu_torch.models.predictor import init_predictor_params
from mlx_vae_tpu_torch.models.sampling import generate_with_temperature
from mlx_vae_tpu_torch.ops.fused_decoder import (FusedWeights, block_rows,
                                                 fused_generate, fused_generate_supported,
                                                 prepare_weights)
from mlx_vae_tpu_torch.utils.tree import params_from_numpy, params_to_numpy


def vae_forward(params: dict, cfg: ModelConfig, x: torch.Tensor,
                conditions: torch.Tensor, eps: torch.Tensor, tf_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """encode -> reparameterize -> decode with teacher forcing. Returns
    ``(logits, mu, logvar, z)``. ``eps [B, latent]`` and ``tf_mask [L]`` are
    the noise the JAX version draws from its key."""
    mu, logvar = encoder_apply(params["encoder"], cfg, x, conditions)
    z = reparameterize(eps, mu, logvar)
    logits = decoder_apply(params["decoder"], cfg, z, conditions, target_seq=x,
                           tf_mask=tf_mask)
    return logits, mu, logvar, z


def generation_sampler(cfg: ModelConfig) -> str:
    """``"fused"`` where ``cfg.use_pallas`` holds and the fused sampler takes
    the config (``fused_generate_supported``), else ``"scan"``: the route
    ``vae_generate`` takes, decided from the config before any launch."""
    return "fused" if cfg.use_pallas and fused_generate_supported(cfg) else "scan"


@torch.no_grad()
def vae_generate(params: dict, cfg: ModelConfig, conditions: torch.Tensor,
                 generator: torch.Generator, max_length: int = 80,
                 temperature: float = 1.0, greedy: bool = False,
                 top_k: int = 0, top_p: float = 1.0,
                 weights: Optional[FusedWeights] = None) -> torch.Tensor:
    """Sample ``[B, max_length]`` int32 tokens for ``conditions [B, C]``.

    ``params`` is the model tree (``{"decoder": ...}``) as tensors on the
    conditions' device, and ``generator`` (on that device too) draws z,
    then, on the fused route, one sampler seed per ``block_rows(B)`` rows,
    or on the scan route the sampling noise. ``weights`` are the decoder's
    prepared kernel weights (fused route only); pass them to reuse one
    preparation across calls.
    """
    dev = conditions.device
    B = conditions.shape[0]
    dec = params["decoder"]
    z = torch.randn((B, cfg.latent_dim), generator=generator, device=dev)
    cond = conditions.float().contiguous()
    if generation_sampler(cfg) == "scan":
        return generate_with_temperature(dec, cfg, z, cond, generator, max_length=max_length,
                                         temperature=temperature, greedy=greedy,
                                         top_k=top_k, top_p=top_p)
    nb = -(-B // block_rows(B))
    seeds = torch.randint(0, 2**31 - 1, (nb,), generator=generator,
                          device=dev, dtype=torch.int32)
    temps = torch.full((nb,), float(temperature), dtype=torch.float32, device=dev)
    if weights is None:
        weights = prepare_weights(dec, cfg, dev)
    h0 = hidden_init_row(dec, cfg, z, cond).contiguous()
    return fused_generate(weights, h0, cond, seeds, temps, max_length,
                          greedy=greedy, top_k=top_k, top_p=top_p)


class ARCVAE:
    """The model's params with its forward and sampler. ``generator`` (a CPU
    ``torch.Generator``; seed 0 when None) draws the initial params, which
    then live on ``device`` as float32 masters. ``device`` is the card
    unless the caller asks for the CPU: without CUDA the default raises
    rather than moving the model to the CPU."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                 with_predictor: bool = False, device="cuda"):
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"ARCVAE(device={device!r}) but CUDA is not available; pass "
                               "device='cpu' to run the plain PyTorch versions on the CPU")
        self.cfg = cfg
        self.latent_dim = cfg.latent_dim
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        params = {"encoder": init_encoder_params(gen, cfg),
                  "decoder": init_decoder_params(gen, cfg)}
        if with_predictor:
            params["predictor"] = init_predictor_params(gen, cfg)
        self.params = params_from_numpy(params_to_numpy(params), device)

    def __call__(self, x: torch.Tensor, conditions: torch.Tensor, eps: torch.Tensor,
                 tf_mask: torch.Tensor):
        """``(logits, mu, logvar, z)``; ``eps`` and ``tf_mask`` as in
        :func:`vae_forward`."""
        return vae_forward(self.params, self.cfg, x, conditions, eps, tf_mask)

    def generate(self, batch_size: int, conditions, generator: torch.Generator,
                 max_length: int = 80, temperature: float = 1.0, greedy: bool = False,
                 top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
        """``[batch_size, max_length]`` tokens for ``conditions [batch_size, C]``
        (moved to the params' device), drawn from ``generator`` (on that
        device)."""
        dev = self.params["decoder"]["fc_out"]["weight"].device
        conditions = torch.as_tensor(conditions, dtype=torch.float32, device=dev)
        if conditions.shape[0] != batch_size:
            raise ValueError(f"conditions has {conditions.shape[0]} rows, "
                             f"batch_size is {batch_size}")
        return vae_generate(self.params, self.cfg, conditions, generator,
                            max_length=max_length, temperature=temperature,
                            greedy=greedy, top_k=top_k, top_p=top_p)
