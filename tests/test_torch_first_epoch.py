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
* The first step's noise: each trainer, seeded as its CLI seeds it, draws
  its first ``eps`` apart from its init's values: over ``INIT_SEEDS``, no
  leaf of at least ``MIN_VALUES`` values has leading values whose
  correlation with the noise's exceeds ``MAX_CORR`` (largest measured: JAX
  0.105, the port 0.109). A port trainer whose CPU generator took the
  init's seed replays the init as its first steps' noise (its first ``eps``
  is the encoder embedding's leading values, correlation 1.0).
* The first epoch at full width (``slow``): the ``examples/README.md`` run,
  V=80, E=128, H=256, latent 128, 2 layers, bf16, K=8, B=1024, lr 5e-4,
  on the quality-parity study's 45,000-molecule corpus (35 steps), seeds
  ``FULL_SEEDS``, every core on it, held to the same ``N_SE`` (~25 min
  on 8 CPU cores). Run it with ``--runslow -k full_width -s``.

``python -m pytest tests/test_torch_first_epoch.py -s`` prints both
packages' per-seed values.
"""

import math
import os

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
from mlx_vae_tpu_torch.utils.tree import params_to_numpy

MODEL = dict(vocab_size=80, embedding_dim=16, hidden_dim=32, latent_dim=8, num_conditions=1,
             num_layers=2, compute_dtype="bfloat16")
SCHEDULE = dict(epochs=30, batch_size=64, learning_rate=3e-3, beta_warmup_epochs=20,
                steps_per_dispatch=8)
MOLECULES, MAX_LENGTH = 2000, 32
SEEDS = range(67, 75)
INIT_SEEDS = range(67, 71)
N_SE = 3.0
P_MIN = 1e-3
# the examples/README.md run: its model and schedule (bf16, K=8) and the
# quality-parity study's corpus (studies/quality_parity.py:make_corpus)
FULL_MODEL = dict(MODEL, embedding_dim=128, hidden_dim=256, latent_dim=128)
FULL_SCHEDULE = dict(SCHEDULE, batch_size=1024, learning_rate=5e-4)
FULL_MOLECULES, FULL_MAX_LENGTH = 45000, 64
FULL_SEEDS = range(67, 71)
MIN_VALUES, MAX_CORR = 256, 0.3


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


def _first_step_eps(pkg, seed, data, tmp):
    """The init's leaves and the first train step's ``eps [B, latent]`` of
    ``pkg``'s trainer on the corpus ``data``, both seeded ``seed`` as its
    CLI seeds them."""
    B, latent = SCHEDULE["batch_size"], MODEL["latent_dim"]
    if pkg == "jax":
        jcfg = JaxConfig(**MODEL)
        params = JaxARCVAE(jcfg, jax.random.PRNGKey(seed)).params
        tr = JaxTrainer(params, jcfg, JaxTrainConfig(**SCHEDULE, checkpoint_dir=str(tmp / "j")),
                        jax_load_and_split(data)[0], seed=seed)
        # the first dispatch's key; the step splits it (k_rep, k_tf, k_drop)
        # and reparameterize draws eps from k_rep
        k_rep = jax.random.split(tr._next_key(), 3)[0]
        return dict(_leaves(params)), np.asarray(jax.random.normal(k_rep, (B, latent)))
    cfg = ModelConfig(**MODEL)
    vae = ARCVAE(cfg, torch.Generator().manual_seed(seed), device="cpu")
    tr = ARCVAETrainer(vae.params, cfg, TrainConfig(**SCHEDULE, checkpoint_dir=str(tmp / "p")),
                       load_and_split(data)[0], seed=seed)
    eps = tr._next_noise(B, MAX_LENGTH, 0.9)["eps"]
    return dict(_leaves(params_to_numpy(vae.params))), eps.numpy()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_first_step_noise_is_apart_from_the_init(pkg, tmp_path):
    """The first step's reparameterization noise shares no draws with the
    init: for every leaf of at least ``MIN_VALUES`` values, the Pearson
    correlation of its leading values with the noise's is within
    ``MAX_CORR``, in the JAX trainer and in the port's."""
    data = str(tmp_path / "syn.json")
    make_synthetic_dataset(n=200, vocab_size=MODEL["vocab_size"], max_length=MAX_LENGTH,
                           path=data)
    worst = (0.0, None)
    for seed in INIT_SEEDS:
        leaves, eps = _first_step_eps(pkg, seed, data, tmp_path)
        eps = eps.ravel().astype(np.float64)
        for path, leaf in leaves.items():
            leaf = leaf.ravel().astype(np.float64)
            n = min(leaf.size, eps.size)
            if n < MIN_VALUES or leaf[:n].std() == 0:
                continue
            r = abs(np.corrcoef(eps[:n], leaf[:n])[0, 1])
            worst = max(worst, (r, f"seed {seed} {path}"), key=lambda w: w[0])
    print(f"\n{pkg}: largest |corr| of the first eps with an init leaf {worst[0]:.4f} "
          f"({worst[1]})")
    assert worst[0] <= MAX_CORR, f"{pkg}: the first eps repeats the init ({worst})"


def _epoch0(tmp, model, schedule, molecules, max_length, seeds):
    """Epoch 0's metrics of either package over ``seeds``, each from its own
    init and seed as its CLI seeds them: ``{pkg: [dict]}``."""
    data = str(tmp / "syn.json")
    make_synthetic_dataset(n=molecules, vocab_size=model["vocab_size"], max_length=max_length,
                           path=data)
    out = {"jax": [], "port": []}
    train, val, _, _ = jax_load_and_split(data)
    jcfg = JaxConfig(**model)
    jtcfg = JaxTrainConfig(**schedule, checkpoint_dir=str(tmp / "jax"))
    for s in seeds:
        params = JaxARCVAE(jcfg, jax.random.PRNGKey(s)).params
        tr = JaxTrainer(jax.tree_util.tree_map(jnp.asarray, params), jcfg, jtcfg, train, seed=s)
        out["jax"].append(tr.train_epoch(0, schedule["epochs"], val_dataset=val))
    train, val, _, _ = load_and_split(data)
    cfg = ModelConfig(**model)
    tcfg = TrainConfig(**schedule, checkpoint_dir=str(tmp / "port"))
    for s in seeds:
        vae = ARCVAE(cfg, torch.Generator().manual_seed(s), device="cpu")
        tr = ARCVAETrainer(vae.params, cfg, tcfg, train, seed=s)
        out["port"].append(tr.train_epoch(0, schedule["epochs"], val_dataset=val))
    return out


def _welch(epochs, key, seeds):
    """The port's mean of ``key`` against JAX's, in standard errors of the
    difference (Welch); prints both packages' per-seed values."""
    j = np.array([m[key] for m in epochs["jax"]])
    p = np.array([m[key] for m in epochs["port"]])
    assert np.isfinite(j).all() and np.isfinite(p).all()
    assert all(m["beta"] == 0.0 for m in epochs["port"] + epochs["jax"])
    se = math.sqrt(j.var(ddof=1) / j.size + p.var(ddof=1) / p.size)
    z = (p.mean() - j.mean()) / se
    print(f"\nepoch-0 {key} over seeds {list(seeds)}: JAX {np.round(j, 4).tolist()} "
          f"(mean {j.mean():.4f}, sd {j.std(ddof=1):.4f}); port {np.round(p, 4).tolist()} "
          f"(mean {p.mean():.4f}, sd {p.std(ddof=1):.4f}); difference {z:+.2f} SE")
    for name in ("val_kl", "mutual_info"):
        print(f"  {name}: JAX {[round(m[name], 2) for m in epochs['jax']]}; "
              f"port {[round(m[name], 2) for m in epochs['port']]}")
    return z, p.mean(), j.mean()


@pytest.fixture(scope="module")
def first_epochs(tmp_path_factory):
    return _epoch0(tmp_path_factory.mktemp("first_epoch"), MODEL, SCHEDULE, MOLECULES,
                   MAX_LENGTH, SEEDS)


@pytest.fixture(scope="module")
def full_width_epochs(tmp_path_factory):
    """The ``examples/README.md`` run's epoch 0, every core on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        return _epoch0(tmp_path_factory.mktemp("full_width"), FULL_MODEL, FULL_SCHEDULE,
                       FULL_MOLECULES, FULL_MAX_LENGTH, FULL_SEEDS)
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("key", ["val_loss", "train_loss"])
def test_first_epoch_matches_jax_over_seeds(first_epochs, key):
    z, p, j = _welch(first_epochs, key, SEEDS)
    assert abs(z) <= N_SE, f"epoch-0 {key}: port mean {p} vs JAX {j}, {z:.2f} SE"


@pytest.mark.slow
@pytest.mark.parametrize("key", ["val_loss", "train_loss"])
def test_first_epoch_full_width_matches_jax_over_seeds(full_width_epochs, key):
    z, p, j = _welch(full_width_epochs, key, FULL_SEEDS)
    assert abs(z) <= N_SE, f"epoch-0 {key}: port mean {p} vs JAX {j}, {z:.2f} SE"
