"""The single training objective (counterpart of
``mlx_vae_tpu/losses/complete.py``)::

    total = recon + beta*kl + collapse_penalty + lambda_prop*prop + mi_penalty
    mi_penalty = lambda_mi * max(0, target_mi - MI)

The JAX version splits its key into the reparameterization noise, the
teacher-forcing flips and the dropout key; here those come in as ``eps
[B, latent]``, ``tf_mask [L]`` and ``keep_masks`` (the encoder's dropout
keep-masks, used only when training with ``cfg.apply_dropout``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.losses.info import mutual_information, posterior_collapse
from mlx_vae_tpu_torch.losses.kl import kl_divergence
from mlx_vae_tpu_torch.losses.prop import property_prediction_loss
from mlx_vae_tpu_torch.losses.recon import reconstruction_loss
from mlx_vae_tpu_torch.models.decoder import decoder_apply, hidden_init_row, train_decoder_route
from mlx_vae_tpu_torch.models.encoder import encoder_apply, reparameterize
from mlx_vae_tpu_torch.models.predictor import predictor_apply


def complete_vae_loss(
    encoder_params: dict,
    decoder_params: dict,
    predictor_params: Optional[dict],
    cfg: ModelConfig,
    x: torch.Tensor,
    conditions: torch.Tensor,
    eps: torch.Tensor,
    tf_mask: torch.Tensor,
    keep_masks: Optional[Sequence[torch.Tensor]] = None,
    beta=0.4,
    lambda_prop: float = 0.1,
    lambda_collapse: float = 0.01,
    free_bits: float = 0.5,
    lambda_mi: float = 0.0,
    target_mi: float = 4.85,
    training: bool = True,
) -> dict:
    use_dropout = training and cfg.apply_dropout
    mu, logvar = encoder_apply(encoder_params, cfg, x, conditions,
                               keep_masks=keep_masks if use_dropout else None)
    z = reparameterize(eps, mu, logvar)

    recon_loss = None
    if train_decoder_route(cfg, x.device) == "fused":
        # fused decoder + CE: logits never reach device memory
        from mlx_vae_tpu_torch.ops.fused_train_decoder import decoder_train_ce
        cond_f = conditions.float()
        h_init = hidden_init_row(decoder_params, cfg, z, cond_f)
        ce = decoder_train_ce(decoder_params, cfg, h_init, cond_f, x, tf_mask)
        recon_loss = ce.sum() / (x.shape[0] * x.shape[1])
    if recon_loss is None:
        logits = decoder_apply(decoder_params, cfg, z, conditions, target_seq=x,
                               tf_mask=tf_mask)
        recon_loss = reconstruction_loss(logits, x, reduction="mean")
    kl_loss = kl_divergence(mu, logvar, reduction="mean", free_bits=free_bits)
    collapse_penalty = posterior_collapse(mu, logvar, target_mi=target_mi,
                                          weight=lambda_collapse)
    mi = mutual_information(mu, logvar)
    mi_penalty = lambda_mi * (target_mi - mi).clamp_min(0.0)

    if predictor_params is not None:
        pred_properties = predictor_apply(predictor_params, cfg, z)
        prop_loss = property_prediction_loss(pred_properties, conditions, reduction="mean")
    else:
        prop_loss = torch.zeros((), dtype=torch.float32, device=x.device)

    total_loss = (recon_loss + beta * kl_loss + collapse_penalty
                  + lambda_prop * prop_loss + mi_penalty)
    return {
        "total_loss": total_loss,
        "recon_loss": recon_loss,
        "kl_loss": kl_loss,
        "weighted_kl": beta * kl_loss,
        "collapse_penalty": collapse_penalty,
        "prop_loss": prop_loss,
        "weighted_prop_loss": lambda_prop * prop_loss,
        "mutual_info": mi,
        "mi_penalty": mi_penalty,
        "mu": mu,
        "logvar": logvar,
        "z": z,
    }
