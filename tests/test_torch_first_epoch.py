"""The first epoch of the port's training against the JAX package's, each
with its own init and its own noise, as ``cli.train`` runs them.

The quality-parity study trains the ``examples/README.md`` run on the card,
and whether its ``checkpoint_best.npz`` is epoch 0 turns on epoch 0's
val_loss (beta 0, teacher forcing 0.9). ``tests/test_torch_trainer.py``
holds the two trainers equal given the same params and the same noise; this
file holds what that leaves open, the draws themselves:

* The init: for each seed, ``ARCVAE`` of either package, seeded as its CLI
  seeds it (``jax.random.PRNGKey(seed)``; ``torch.Generator().manual_seed
  (seed)``), gives the same leaves with the same shapes, and each leaf's
  values, pooled over ``INIT_SEEDS``, pass a two-sample Kolmogorov-Smirnov
  test against the JAX leaf's at ``P_MIN``.
* The first epoch: each trainer, from its own init and seed, trains one
  epoch of a 30-epoch schedule (beta warm-up 20 epochs, so beta 0 and
  teacher forcing 0.9; bf16 matmul inputs, ``steps_per_dispatch`` 8, as the
  record's run; the scan routes, as the JAX fused kernels run only in
  interpret mode here) on one synthetic corpus at a reduced model (V=80,
  E=16, H=32, latent 8, 2 layers; 2,000 molecules of at most 32 tokens,
  B=64: 25 steps). The learning rate is 3e-3, the tiny model's rate in the
  other tests: at the record's 5e-4 this model barely moves in 25 steps, so
  epoch 0 would hold the init and little of the training. Over ``SEEDS``
  the two packages' mean epoch-0 val_loss and train_loss agree within
  ``N_SE`` standard errors of their difference (Welch). The batch order is
  the same in both by construction (``np.random.default_rng(seed)``); the
  init and the noise are each package's own, so the seeds do not pair.

``python -m pytest tests/test_torch_first_epoch.py -s`` prints both
packages' per-seed values.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from mlx_vae_tpu.config import ModelConfig as JaxConfig
from mlx_vae_tpu.config import TrainConfig as JaxTrainConfig
from mlx_vae_tpu.data.split import load_and_split as jax_load_and_split
from mlx_vae_tpu.models import ARCVAE as JaxARCVAE
from mlx_vae_tpu.train.trainer import ARCVAETrainer as JaxTrainer
from mlx_vae_tpu_torch.config import ModelConfig, TrainConfig
from mlx_vae_tpu_torch.data.prepare import make_synthetic_dataset
from mlx_vae_tpu_torch.data.split import load_and_split
from mlx_vae_tpu_torch.models.vae import ARCVAE
from mlx_vae_tpu_torch.train.trainer import ARCVAETrainer

MODEL = dict(vocab_size=80, embedding_dim=16, hidden_dim=32, latent_dim=8, num_conditions=1,
             num_layers=2, compute_dtype="bfloat16")
SCHEDULE = dict(epochs=30, batch_size=64, learning_rate=3e-3, beta_warmup_epochs=20,
                steps_per_dispatch=8)
MOLECULES, MAX_LENGTH = 2000, 32
SEEDS = range(67, 75)
INIT_SEEDS = range(67, 71)
N_SE = 3.0
P_MIN = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test runner's parallel workers would
    otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield "/".join(map(str, prefix)), np.asarray(tree)


@pytest.mark.parametrize("with_predictor", [False, True])
def test_init_statistics_match_jax_leaf_by_leaf(with_predictor):
    jcfg, cfg = JaxConfig(**MODEL), ModelConfig(**MODEL)
    init = jax.jit(lambda k: JaxARCVAE(jcfg, k, with_predictor=with_predictor).params)
    jax_draws = [dict(_leaves(init(jax.random.PRNGKey(s)))) for s in INIT_SEEDS]
    port_draws = [dict(_leaves(ARCVAE(cfg, torch.Generator().manual_seed(s), device="cpu",
                                      with_predictor=with_predictor).params))
                  for s in INIT_SEEDS]
    assert {k: v.shape for k, v in port_draws[0].items()} == \
        {k: v.shape for k, v in jax_draws[0].items()}
    for path in jax_draws[0]:
        j = np.concatenate([d[path].ravel() for d in jax_draws])
        p = np.concatenate([d[path].ravel() for d in port_draws])
        pval = stats.ks_2samp(p, j).pvalue
        assert pval >= P_MIN, f"{path}: KS p = {pval:.2e} over {j.size} values"


@pytest.fixture(scope="module")
def first_epochs(tmp_path_factory):
    """Epoch 0's metrics of either package over ``SEEDS``: ``{pkg: [dict]}``."""
    tmp = tmp_path_factory.mktemp("first_epoch")
    data = str(tmp / "syn.json")
    make_synthetic_dataset(n=MOLECULES, vocab_size=MODEL["vocab_size"], max_length=MAX_LENGTH,
                           path=data)
    out = {"jax": [], "port": []}
    train, val, _, _ = jax_load_and_split(data)
    jcfg = JaxConfig(**MODEL)
    jtcfg = JaxTrainConfig(**SCHEDULE, checkpoint_dir=str(tmp / "jax"))
    for s in SEEDS:
        params = JaxARCVAE(jcfg, jax.random.PRNGKey(s)).params
        tr = JaxTrainer(jax.tree_util.tree_map(jnp.asarray, params), jcfg, jtcfg, train, seed=s)
        out["jax"].append(tr.train_epoch(0, SCHEDULE["epochs"], val_dataset=val))
    train, val, _, _ = load_and_split(data)
    cfg = ModelConfig(**MODEL)
    tcfg = TrainConfig(**SCHEDULE, checkpoint_dir=str(tmp / "port"))
    for s in SEEDS:
        vae = ARCVAE(cfg, torch.Generator().manual_seed(s), device="cpu")
        tr = ARCVAETrainer(vae.params, cfg, tcfg, train, seed=s)
        out["port"].append(tr.train_epoch(0, SCHEDULE["epochs"], val_dataset=val))
    return out


@pytest.mark.parametrize("key", ["val_loss", "train_loss"])
def test_first_epoch_matches_jax_over_seeds(first_epochs, key):
    j = np.array([m[key] for m in first_epochs["jax"]])
    p = np.array([m[key] for m in first_epochs["port"]])
    assert np.isfinite(j).all() and np.isfinite(p).all()
    assert all(m["beta"] == 0.0 for m in first_epochs["port"] + first_epochs["jax"])
    se = math.sqrt(j.var(ddof=1) / j.size + p.var(ddof=1) / p.size)
    z = (p.mean() - j.mean()) / se
    print(f"\nepoch-0 {key} over seeds {list(SEEDS)}: JAX {np.round(j, 4).tolist()} "
          f"(mean {j.mean():.4f}, sd {j.std(ddof=1):.4f}); port {np.round(p, 4).tolist()} "
          f"(mean {p.mean():.4f}, sd {p.std(ddof=1):.4f}); difference {z:+.2f} SE")
    assert abs(z) <= N_SE, f"epoch-0 {key}: port mean {p.mean()} vs JAX {j.mean()}, {z:.2f} SE"
