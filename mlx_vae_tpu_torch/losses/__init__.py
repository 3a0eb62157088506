"""Loss functions (counterpart of ``mlx_vae_tpu/losses``)."""

from mlx_vae_tpu_torch.losses.recon import reconstruction_loss
from mlx_vae_tpu_torch.losses.kl import kl_divergence
from mlx_vae_tpu_torch.losses.enc import encoder_loss
from mlx_vae_tpu_torch.losses.dec import decoder_loss
from mlx_vae_tpu_torch.losses.info import mutual_information, posterior_collapse
from mlx_vae_tpu_torch.losses.prop import property_prediction_loss
from mlx_vae_tpu_torch.losses.stable import check_loss_sanity, kl_divergence_stable
from mlx_vae_tpu_torch.losses.complete import complete_vae_loss

__all__ = [
    "reconstruction_loss",
    "kl_divergence",
    "encoder_loss",
    "decoder_loss",
    "mutual_information",
    "posterior_collapse",
    "property_prediction_loss",
    "check_loss_sanity",
    "kl_divergence_stable",
    "complete_vae_loss",
]
