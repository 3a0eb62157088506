"""mlx_vae_tpu_torch — the PyTorch + CUDA port of ``mlx_vae_tpu``.

A second package beside the JAX one. It imports ``torch`` and never ``jax``
or ``mlx_vae_tpu``: the GPU machine the port runs on has no JAX, and
importing any ``mlx_vae_tpu`` module imports it. Module names and layout
mirror ``mlx_vae_tpu`` so each counterpart is easy to find; parameter trees
are the same nested dicts of the ``.npz`` checkpoint contract, so numpy
trees move between the two packages unchanged.

This slice ports the generation-serving path (``cli/serve.py``,
``cli/generate.py``) and its one kernel, the fused sampler
(``ops/fused_decoder.py`` + ``csrc/fused_generate.cu``).
"""

from mlx_vae_tpu_torch.config import ModelConfig

__all__ = ["ModelConfig"]
