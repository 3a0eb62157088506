"""Conditional sequence encoder (counterpart of ``mlx_vae_tpu/models/encoder.py``).

Token embedding -> ``num_layers`` stacked LSTMs -> last-step pooling ->
condition projection concatenated with the pooled state -> ``fc_mu`` and the
two-layer ``fc_logvar`` heads, bounded as ``mu = 2 tanh(mu_raw / 2)`` in
[-2, 2] and ``logvar = tanh(logvar_raw / 2) - 1`` in [-2, 0].

Routes (the JAX package's ``encoder_apply``):

* ``cfg.use_pallas`` and the whole-stack encoder (``ops/fused_encoder.py``)
  takes the configuration and its weights fit in L2
  (``ops/train_common.py:stack_fits_l2``): the whole stack in one kernel
  pair.
* Otherwise layer by layer (both directions with ``bidirectional``,
  inter-layer dropout from the caller's keep-masks with ``apply_dropout``):
  with ``use_pallas`` each layer is ``ops/fused_seq_lstm.py``'s
  ``lstm_sequence_fused``; else ``ops/lstm.py:lstm_sequence_cv`` at
  ``custom_vjp`` or H >= 768, and ``ops/lstm.py:lstm_sequence`` below.

The fused routes launch their CUDA kernels on CUDA tensors (a configuration
no kernel takes raises ``NotImplementedError``) and run their plain versions
on CPU tensors. Randomness comes from the caller: :func:`reparameterize`
takes ``eps`` and dropout takes keep-masks or a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.models.layers import embedding, init_embedding, init_linear, linear
from mlx_vae_tpu_torch.ops.lstm import init_lstm_params, lstm_sequence, lstm_sequence_cv
from mlx_vae_tpu_torch.ops.train_common import stack_fits_l2


def init_encoder_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    params = {"embedding": init_embedding(gen, cfg.vocab_size, cfg.embedding_dim)}
    out_dim = cfg.hidden_dim * (2 if cfg.bidirectional else 1)
    for i in range(cfg.num_layers):
        in_size = cfg.embedding_dim if i == 0 else out_dim
        params[f"lstm_layer_{i}"] = init_lstm_params(gen, in_size, cfg.hidden_dim)
        if cfg.bidirectional:
            params[f"lstm_layer_{i}_rev"] = init_lstm_params(gen, in_size, cfg.hidden_dim)
    combined = out_dim + cfg.hidden_dim
    params["condition_fc"] = init_linear(gen, cfg.num_conditions, cfg.hidden_dim)
    params["fc_mu"] = init_linear(gen, combined, cfg.latent_dim)
    params["fc_logvar_hidden"] = init_linear(gen, combined, combined)
    params["fc_logvar"] = init_linear(gen, combined, cfg.latent_dim)
    # logvar bias 0.35: the starting logvar sits in the reference's -2 region
    params["fc_logvar"]["bias"] = torch.full_like(params["fc_logvar"]["bias"], 0.35)
    return params


def dropout_masks(gen: torch.Generator, cfg: ModelConfig, batch: int,
                  length: int) -> list:
    """Keep-masks ``[B, L, out_dim]`` for the ``num_layers - 1`` inter-layer
    dropouts, drawn from ``gen`` (on the device where they are used)."""
    out_dim = cfg.hidden_dim * (2 if cfg.bidirectional else 1)
    return [torch.rand((batch, length, out_dim), generator=gen, device=gen.device)
            >= cfg.dropout for _ in range(cfg.num_layers - 1)]


def encoder_apply(params: dict, cfg: ModelConfig, x: torch.Tensor,
                  conditions: torch.Tensor,
                  keep_masks: Optional[Sequence[torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [B, L] int`` tokens, ``conditions [B, C]`` -> ``(mu, logvar)``.

    ``keep_masks``: one boolean keep-mask per inter-layer dropout (see
    :func:`dropout_masks`), used only when ``cfg.apply_dropout``; None for
    eval.
    """
    if cfg.use_pallas:
        from mlx_vae_tpu_torch.ops.fused_encoder import encoder_stack, fused_encoder_supported
        if fused_encoder_supported(cfg) and stack_fits_l2(cfg):
            return _heads(params, cfg, encoder_stack(params, cfg, x), conditions)
        from mlx_vae_tpu_torch.ops.fused_seq_lstm import lstm_sequence_fused as seq
    elif cfg.custom_vjp or cfg.hidden_dim >= 768:
        seq = lstm_sequence_cv
    else:
        seq = lstm_sequence
    B = x.shape[0]
    dev = x.device
    h0 = torch.zeros((B, cfg.hidden_dim), dtype=torch.float32, device=dev)
    c0 = torch.zeros_like(h0)
    output = embedding(params["embedding"], x, cfg.dtype).float()
    for i in range(cfg.num_layers):
        fwd = seq(params[f"lstm_layer_{i}"], output, h0, c0, cfg.dtype)[0]
        if cfg.bidirectional:
            bwd = seq(params[f"lstm_layer_{i}_rev"], output.flip(1), h0, c0,
                      cfg.dtype)[0].flip(1)
            output = torch.cat([fwd, bwd], dim=-1)
        else:
            output = fwd
        if cfg.apply_dropout and keep_masks is not None and cfg.dropout > 0 \
                and i < cfg.num_layers - 1:
            output = torch.where(keep_masks[i], output / (1.0 - cfg.dropout),
                                 torch.zeros_like(output))
    return _heads(params, cfg, output[:, -1, :].float(), conditions)


def _heads(params: dict, cfg: ModelConfig, final_hidden: torch.Tensor,
           conditions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Condition projection + bounded mu/logvar heads."""
    dtype = cfg.dtype
    condition_repr = linear(params["condition_fc"], conditions, dtype)
    combined = torch.cat([final_hidden, condition_repr], dim=1)
    mu_raw = linear(params["fc_mu"], combined, dtype)
    logvar_hidden = torch.tanh(linear(params["fc_logvar_hidden"], combined, dtype))
    logvar_raw = linear(params["fc_logvar"], logvar_hidden, dtype)
    mu = torch.tanh(mu_raw / 2.0) * 2.0
    logvar = torch.tanh(logvar_raw / 2.0) - 1.0
    return mu, logvar


def reparameterize(eps: torch.Tensor, mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """``z = mu + exp(0.5 * logvar) * eps``; ``eps ~ N(0, I)`` of ``mu``'s
    shape comes from the caller."""
    return mu + eps * torch.exp(0.5 * logvar)
