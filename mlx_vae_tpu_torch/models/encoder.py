"""Conditional sequence encoder (counterpart of ``mlx_vae_tpu/models/encoder.py``).

Token embedding -> ``num_layers`` stacked LSTMs -> last-step pooling ->
condition projection concatenated with the pooled state -> ``fc_mu`` and the
two-layer ``fc_logvar`` heads, bounded as ``mu = 2 tanh(mu_raw / 2)`` in
[-2, 2] and ``logvar = tanh(logvar_raw / 2) - 1`` in [-2, 0].

Routes (:func:`encoder_route`, the JAX package's ``encoder_apply``), chosen
from the config before any launch by asking the kernels' predicates:

* ``"fused"``: ``cfg.use_pallas``, the whole-stack encoder
  (``ops/fused_encoder.py``) takes the configuration and its weights fit in
  L2 (``ops/train_common.py:stack_fits_l2``): the whole stack in one kernel
  pair.
* Otherwise layer by layer (both directions with ``bidirectional``,
  inter-layer dropout from the caller's keep-masks with ``apply_dropout``):
  ``"seq"``, with ``use_pallas`` where the sequence kernels take every
  layer's input width (``ops/fused_seq_lstm.py:fused_seq_supported``), each
  layer is ``lstm_sequence_fused``; else ``"cv"``,
  ``ops/lstm.py:lstm_sequence_cv`` at ``custom_vjp`` or H >= 768, and
  ``"scan"``, ``ops/lstm.py:lstm_sequence``, below (both with the gate
  kernel pair under ``use_pallas``).

The kernels launch on CUDA tensors and their plain versions run on CPU
tensors; a kernel that fails to build or launch raises. Randomness comes
from the caller: :func:`reparameterize` takes ``eps`` and dropout takes
keep-masks or a ``torch.Generator``.

Under a tensor-parallel ``mesh`` (the GSPMD route of the JAX package, whose
``use_pallas`` is off) the encoder runs the scan layer by layer with the
vocab-parallel embedding, column-parallel gates and split biases gathered
at use (``models/layers.py``, ``ops/lstm.py``).
"""

from __future__ import annotations

import functools
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


def layer_input_widths(cfg: ModelConfig) -> list:
    """Each LSTM layer's input width: the embedding, then the layer below's
    output (both directions' with ``bidirectional``)."""
    out_dim = cfg.hidden_dim * (2 if cfg.bidirectional else 1)
    return [cfg.embedding_dim] + [out_dim] * (cfg.num_layers - 1)


def encoder_route(cfg: ModelConfig) -> str:
    """The encoder's route (the module docstring's list): ``"fused"``,
    ``"seq"``, ``"cv"`` or ``"scan"``. The same on every device."""
    if cfg.use_pallas:
        from mlx_vae_tpu_torch.ops.fused_encoder import fused_encoder_supported
        from mlx_vae_tpu_torch.ops.fused_seq_lstm import fused_seq_supported
        if fused_encoder_supported(cfg) and stack_fits_l2(cfg):
            return "fused"
        if all(fused_seq_supported(i, cfg.hidden_dim, cfg.dtype)
               for i in layer_input_widths(cfg)):
            return "seq"
    return "cv" if cfg.custom_vjp or cfg.hidden_dim >= 768 else "scan"


def encoder_apply(params: dict, cfg: ModelConfig, x: torch.Tensor,
                  conditions: torch.Tensor,
                  keep_masks: Optional[Sequence[torch.Tensor]] = None, mesh=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [B, L] int`` tokens, ``conditions [B, C]`` -> ``(mu, logvar)``.

    ``keep_masks``: one boolean keep-mask per inter-layer dropout (see
    :func:`dropout_masks`), used only when ``cfg.apply_dropout``; None for
    eval. ``mesh``: the tensor-parallel mesh whose model group splits
    ``params`` (None: one device).
    """
    route = "scan" if mesh is not None else encoder_route(cfg)
    if route == "fused":
        from mlx_vae_tpu_torch.ops.fused_encoder import encoder_stack
        return _heads(params, cfg, encoder_stack(params, cfg, x), conditions)
    if route == "seq":
        from mlx_vae_tpu_torch.ops.fused_seq_lstm import lstm_sequence_fused as seq
    elif route == "cv":
        seq = functools.partial(lstm_sequence_cv, use_pallas=cfg.use_pallas)
    else:
        seq = functools.partial(lstm_sequence, mesh=mesh, use_pallas=cfg.use_pallas)
    B = x.shape[0]
    dev = x.device
    h0 = torch.zeros((B, cfg.hidden_dim), dtype=torch.float32, device=dev)
    c0 = torch.zeros_like(h0)
    output = embedding(params["embedding"], x, cfg.dtype, mesh=mesh,
                       num_embeddings=cfg.vocab_size).float()
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
    return _heads(params, cfg, output[:, -1, :].float(), conditions, mesh)


def _heads(params: dict, cfg: ModelConfig, final_hidden: torch.Tensor,
           conditions: torch.Tensor, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Condition projection + bounded mu/logvar heads."""
    dtype = cfg.dtype
    condition_repr = linear(params["condition_fc"], conditions, dtype, mesh)
    combined = torch.cat([final_hidden, condition_repr], dim=1)
    mu_raw = linear(params["fc_mu"], combined, dtype, mesh)
    logvar_hidden = torch.tanh(linear(params["fc_logvar_hidden"], combined, dtype, mesh))
    logvar_raw = linear(params["fc_logvar"], logvar_hidden, dtype, mesh)
    mu = torch.tanh(mu_raw / 2.0) * 2.0
    logvar = torch.tanh(logvar_raw / 2.0) - 1.0
    return mu, logvar


def reparameterize(eps: torch.Tensor, mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """``z = mu + exp(0.5 * logvar) * eps``; ``eps ~ N(0, I)`` of ``mu``'s
    shape comes from the caller."""
    return mu + eps * torch.exp(0.5 * logvar)
