"""Property prediction loss, MSE (counterpart of
``mlx_vae_tpu/losses/prop.py``, with the reference's call-site wiring
fixed there too: ``(predicted, target)``)."""

from __future__ import annotations

from typing import Optional

import torch


def property_prediction_loss(predicted_properties: torch.Tensor,
                             target_properties: torch.Tensor,
                             property_scales: Optional[torch.Tensor] = None,
                             reduction: str = "mean") -> torch.Tensor:
    mse = (predicted_properties.float() - target_properties.float()).square()
    if property_scales is not None:
        mse = mse / (property_scales.square() + 1e-8)
    if reduction == "mean":
        return mse.mean()
    if reduction == "sum":
        return mse.sum()
    return mse
