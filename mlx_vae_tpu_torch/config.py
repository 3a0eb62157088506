"""Model configuration (counterpart of ``mlx_vae_tpu/config.py``).

Same fields and defaults as the JAX ``ModelConfig``, so a config built from
checkpoint shapes means the same model in both packages. ``dtype`` maps
``compute_dtype`` to a torch dtype (the JAX property returns a ``jnp``
dtype). ``TrainConfig`` waits for the training slice.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


@dataclass(frozen=True)
class ModelConfig:
    """Static model hyperparameters (see ``mlx_vae_tpu.config.ModelConfig``
    for what each field means; the TPU-only knobs are kept so both configs
    compare field for field)."""

    vocab_size: int = 80
    embedding_dim: int = 128
    hidden_dim: int = 256
    latent_dim: int = 128
    num_conditions: int = 1
    num_layers: int = 2
    dropout: float = 0.2

    # Token conventions. start_token 0 is NOT the dataset's START=1
    # (data/prepare.py); generation parity with the JAX package depends on
    # keeping that quirk.
    pad_token: int = 0
    start_token: int = 0
    end_token: int = 2

    bidirectional: bool = False
    apply_dropout: bool = False

    compute_dtype: str = "float32"  # matmul input dtype; f32 accumulation
    use_pallas: bool = False
    scan_unroll: int = 1
    remat: bool = True
    embed_onehot: bool = True
    custom_vjp: bool = False
    # Every timestep runs from zero LSTM state (the reference decoder's
    # quirk). Only the plain scan sampler honours it; the fused kernel
    # raises for it.
    reference_zero_state: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
