"""mlx_vae_tpu_torch — the PyTorch + CUDA port of ``mlx_vae_tpu``.

A second package beside the JAX one. It imports ``torch`` and never ``jax``
or ``mlx_vae_tpu``: the GPU machine the port runs on has no JAX, and
importing any ``mlx_vae_tpu`` module imports it. Module names and layout
mirror ``mlx_vae_tpu`` so each counterpart is easy to find; parameter trees
are the same nested dicts of the ``.npz`` checkpoint contract, so numpy
trees move between the two packages unchanged.

Every part of the JAX package has its counterpart here: training
(``cli/train.py``, ``train/``), evaluation and design (``cli/encode.py``,
``cli/interpolate.py``, ``cli/optimize.py``), generation and serving
(``cli/generate.py``, ``cli/serve.py``), multi-device runs (``parallel/``),
the diagnostics and the curve-parity study. Each Pallas kernel of the JAX
package is a hand-written CUDA kernel for the H100 (``csrc/``, bound in
``ops/``) with a plain PyTorch twin that CPU tensors run.
"""

from mlx_vae_tpu_torch.config import ModelConfig, TrainConfig
from mlx_vae_tpu_torch.version import __version__

__all__ = ["__version__", "ModelConfig", "TrainConfig"]
