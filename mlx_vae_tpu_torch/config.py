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
    # quirk). The teacher-forced decode then takes the scan (with
    # use_pallas, through the fused gate kernels); sampling honours it in
    # the plain scan sampler.
    reference_zero_state: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (see ``mlx_vae_tpu.config.TrainConfig`` for
    what each field means and where its default comes from; the TPU-only
    knobs are kept so both configs compare field for field)."""

    epochs: int = 30
    batch_size: int = 32
    learning_rate: float = 2e-4
    beta_start: float = 0.0
    beta_end: float = 0.05
    beta_warmup_epochs: int = 20
    lambda_prop: float = 0.1
    lambda_collapse: float = 0.001
    free_bits: float = 1.0
    lambda_mi: float = 0.01
    grad_clip: float = 1.0
    checkpoint_dir: str = "./checkpoints"
    checkpoint_freq: int = 10

    target_mi: float = 4.85
    seed: int = 67
    # Teacher-forcing schedule max(tf_floor, tf_start - tf_decay * progress).
    tf_start: float = 0.9
    tf_decay: float = 0.4
    tf_floor: float = 0.5
    true_loss_batches: int = 20
    component_sample_every: int = 25
    explosion_max: float = 2000.0
    explosion_min: float = -10.0

    # Adam without bias correction by default (the MLX reference's rule).
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    adam_bias_correction: bool = False

    data_parallel: bool = False
    model_parallel: int = 1
    steps_per_dispatch: int = 1
    async_checkpoint: bool = True
    host_data: bool = False

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

    def compute_beta(self, epoch: int) -> float:
        """Linear KL-weight anneal over ``beta_warmup_epochs``."""
        if epoch < self.beta_warmup_epochs:
            return float(
                self.beta_start
                + (self.beta_end - self.beta_start) * (epoch / self.beta_warmup_epochs)
            )
        return float(self.beta_end)

    def compute_teacher_forcing_ratio(self, epoch: int, total_epochs: int) -> float:
        """Teacher forcing decays from ``tf_start`` to ``tf_floor`` over all
        epochs."""
        progress = epoch / total_epochs
        return float(max(self.tf_floor, self.tf_start - self.tf_decay * progress))
