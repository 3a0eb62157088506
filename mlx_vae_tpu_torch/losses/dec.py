"""Stage-wise decoder-only loss (counterpart of ``mlx_vae_tpu/losses/dec.py``)."""

from __future__ import annotations

from mlx_vae_tpu_torch.losses.recon import reconstruction_loss
from mlx_vae_tpu_torch.models.decoder import decoder_apply


def decoder_loss(params, cfg, z, conditions, target_seq, tf_mask):
    """Reconstruction CE of decoding ``z`` against ``target_seq`` with the
    teacher-forcing flips ``tf_mask [L]``."""
    logits = decoder_apply(params, cfg, z, conditions, target_seq=target_seq,
                           tf_mask=tf_mask)
    return reconstruction_loss(logits, target_seq, reduction="mean")
