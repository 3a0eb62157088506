"""Port ``ARCVAETrainer`` vs the JAX ``ARCVAETrainer`` over whole epochs.

Both trainers start from the same numpy params and seed and train on the
same split (``load_and_split`` of one synthetic corpus, V=24, L=12). The
batch order is the same by construction (``np.random.default_rng(seed)``
drives ``to_index_batches`` in both). The device noise is shared: the
port's :meth:`ARCVAETrainer._next_noise` is overridden to draw from the JAX
trainer's key stream exactly as the JAX trainer consumes it (per dispatch
``key, k = split(key)``; per step ``k_rep, k_tf, _ = split(k, 3)``; inside a
K-chunk the scan's own ``key, k = split(key)`` per step; train steps, then
the true-loss batches, then validation).

Over 2 epochs every history series and the final params agree in float32
for ``use_pallas`` on (the fused kernels' plain versions on CPU tensors)
and off, with and without the predictor, at K = 1 and 4 (learning rate
1e-3). Tolerances are those of ``test_torch_train_step.py``: 1e-5
relative on the history values, 1e-5 absolute on the params; the worst
errors measured over the four cases are 8.0e-7 relative and 3.1e-6
absolute (the frameworks sum in different orders).

The rest mirrors ``tests/test_trainer.py`` on the port alone: determinism,
the host feed against the device feed, the async checkpoint (bytes, the
snapshot against the next in-place step, failures, no tmp files), the
latent stats of a small dataset, the history schema and the plot.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_vae_tpu.config import ModelConfig as JaxConfig
from mlx_vae_tpu.config import TrainConfig as JaxTrainConfig
from mlx_vae_tpu.data.prepare import make_synthetic_dataset
from mlx_vae_tpu.data.split import load_and_split as jax_load_and_split
from mlx_vae_tpu.models import ARCVAE as JaxARCVAE
from mlx_vae_tpu.train.trainer import ARCVAETrainer as JaxTrainer
from mlx_vae_tpu_torch.config import ModelConfig, TrainConfig
from mlx_vae_tpu_torch.data.dataset import MoleculeDataset
from mlx_vae_tpu_torch.data.split import load_and_split
from mlx_vae_tpu_torch.models.vae import ARCVAE
from mlx_vae_tpu_torch.train import checkpoint as ckpt_io
from mlx_vae_tpu_torch.train import trainer as ttrainer
from mlx_vae_tpu_torch.train.history import HISTORY_KEYS
from mlx_vae_tpu_torch.train.trainer import ARCVAETrainer, multi_device_refusal
from mlx_vae_tpu_torch.utils.tree import params_from_numpy, params_to_numpy, tree_leaves

MODEL = dict(vocab_size=24, embedding_dim=16, hidden_dim=32, latent_dim=8,
             num_conditions=1, num_layers=2)
EPOCHS, SEED, LR = 2, 5, 1e-3
RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are tiny, and the test runner's
    parallel workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """220 molecules -> 176 train (5 batches of 32 and one of 16), 22 val."""
    tmp = tmp_path_factory.mktemp("corpus")
    path = tmp / "syn.json"
    make_synthetic_dataset(n=220, vocab_size=24, max_length=12, path=str(path))
    return tmp, str(path)


def _noise_from(k, batch, length, tf_ratio):
    k_rep, k_tf, _ = jax.random.split(k, 3)
    return {"eps": torch.from_numpy(np.array(
                jax.random.normal(k_rep, (batch, MODEL["latent_dim"])))),
            "tf_mask": torch.from_numpy(np.array(
                jax.random.uniform(k_tf, (length,)) < jnp.float32(tf_ratio)))}


class KeyedTrainer(ARCVAETrainer):
    """The port's trainer with its noise drawn from the JAX trainer's key
    stream (see the module docstring)."""

    def __init__(self, *a, seed=SEED, **kw):
        super().__init__(*a, seed=seed, **kw)
        self._jkey = jax.random.PRNGKey(seed)

    def _next_noise(self, batch, length, tf_ratio, steps=None):
        self._jkey, k = jax.random.split(self._jkey)
        if steps is None:
            return _noise_from(k, batch, length, tf_ratio)
        out = []
        for _ in range(steps):
            k, sk = jax.random.split(k)
            out.append(_noise_from(sk, batch, length, tf_ratio))
        return out


def _params(with_predictor, seed=3):
    vae = JaxARCVAE(JaxConfig(**MODEL), jax.random.PRNGKey(seed),
                    with_predictor=with_predictor)
    return jax.tree_util.tree_map(np.array, vae.params)


def _run_jax(corpus, npp, use_pallas, K, name):
    tmp, path = corpus
    train, val, _, _ = jax_load_and_split(path)
    mcfg = JaxConfig(**MODEL, use_pallas=use_pallas)
    tcfg = JaxTrainConfig(epochs=EPOCHS, batch_size=32, learning_rate=LR,
                          steps_per_dispatch=K, checkpoint_dir=str(tmp / f"j{name}"),
                          seed=SEED)
    tr = JaxTrainer(jax.tree_util.tree_map(jnp.array, npp), mcfg, tcfg, train)
    hist = [tr.train_epoch(e, EPOCHS, val_dataset=val) for e in range(EPOCHS)]
    return hist, jax.tree_util.tree_map(np.asarray, tr.params)


def _port(corpus, npp, name, cls=KeyedTrainer, use_pallas=False, K=1, **tcfg_kw):
    tmp, path = corpus
    train, val, _, _ = load_and_split(path)
    mcfg = ModelConfig(**MODEL, use_pallas=use_pallas)
    tcfg = TrainConfig(**{**dict(epochs=EPOCHS, batch_size=32, learning_rate=LR,
                                 steps_per_dispatch=K, checkpoint_dir=str(tmp / f"t{name}"),
                                 seed=SEED), **tcfg_kw})
    return cls(params_from_numpy(npp), mcfg, tcfg, train), val


def _run_port(corpus, npp, **kw):
    tr, val = _port(corpus, npp, **kw)
    hist = [tr.train_epoch(e, EPOCHS, val_dataset=val) for e in range(EPOCHS)]
    return hist, tr


# (use_pallas, with_predictor, K): each option both ways across the four
CASES = [(True, True, 1), (False, False, 1), (True, False, 4), (False, True, 4)]


@pytest.mark.parametrize("use_pallas,with_predictor,K", CASES)
def test_two_epochs_match_jax(corpus, use_pallas, with_predictor, K):
    npp = _params(with_predictor)
    name = f"{int(use_pallas)}{int(with_predictor)}{K}"
    jhist, jparams = _run_jax(corpus, npp, use_pallas, K, name)
    thist, tr = _run_port(corpus, npp, name=name, use_pallas=use_pallas, K=K)
    for e, (jm, tm) in enumerate(zip(jhist, thist)):
        assert set(jm) == set(tm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=RTOL, atol=1e-7,
                                       err_msg=f"epoch {e}: {k}")
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(params_to_numpy(tr.params)),
            jax.tree_util.tree_leaves_with_path(jparams)):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, err_msg=f"params {path}")
    if with_predictor:
        assert thist[0]["train_prop"] > 0.0


def test_batch_order_matches_jax(corpus):
    """The shuffled index batches of consecutive epochs are the JAX
    trainer's, batch for batch."""
    tmp, path = corpus
    jtrain = jax_load_and_split(path)[0]
    train = load_and_split(path)[0]
    jrng, trng = np.random.default_rng(SEED), np.random.default_rng(SEED)
    for _ in range(3):
        jb = list(jtrain.to_index_batches(32, shuffle=True, rng=jrng))
        tb = list(train.to_index_batches(32, shuffle=True, rng=trng))
        assert len(jb) == len(tb) == 6
        for a, b in zip(jb, tb):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("K", [1, 2])
def test_same_seed_reproduces_bitwise(corpus, K):
    npp = _params(False)
    runs = [[(m["train_loss"], m["val_loss"]) for m in
             _run_port(corpus, npp, name=f"det{K}{r}", cls=ARCVAETrainer, K=K)[0]]
            for r in range(2)]
    assert runs[0] == runs[1]


@pytest.mark.parametrize("K", [1, 4])
def test_host_feed_matches_device_feed(corpus, K):
    """``host_data`` (prefetched host batches) and the device-resident
    corpus (index batches) give bit-equal histories and params."""
    npp = _params(True)
    out = {}
    for host in (False, True):
        hist, tr = _run_port(corpus, npp, name=f"hd{K}{int(host)}", cls=ARCVAETrainer,
                             K=K, host_data=host)
        assert tr._device_data is (not host)
        out[host] = (hist, params_to_numpy(tr.params))
    assert out[False][0] == out[True][0]
    for a, b in zip(jax.tree_util.tree_leaves(out[False][1]),
                    jax.tree_util.tree_leaves(out[True][1])):
        np.testing.assert_array_equal(a, b)


def test_partial_chunk_note_once(corpus, capsys):
    """K=4: an epoch of whole chunks prints no note; epochs that end on an
    incomplete chunk run it as single steps and print the note once."""
    tr, _ = _port(corpus, _params(False), name="note", cls=ARCVAETrainer, K=4,
                  batch_size=44)  # 176 rows: 4 full batches, no partial
    tr.train_epoch(0, 2)
    tr.train_epoch(1, 2)
    assert capsys.readouterr().out.count("trailing partial chunk") == 0
    tr, _ = _port(corpus, _params(False), name="note2", cls=ARCVAETrainer, K=4,
                  batch_size=88)  # 2 full batches: an incomplete chunk
    tr.train_epoch(0, 2)
    tr.train_epoch(1, 2)
    assert capsys.readouterr().out.count("trailing partial chunk") == 1


def test_true_loss_batches_zero_reports_neutral_zero(corpus):
    tr, val = _port(corpus, _params(False), name="tl0", cls=ARCVAETrainer,
                    true_loss_batches=0, epochs=1)
    m = tr.train_epoch(0, 1, val_dataset=val)
    assert m["train_loss"] == 0.0 and np.isfinite(m["val_loss"])


def test_loss_decreases(corpus):
    hist, _ = _run_port(corpus, _params(False), name="dec", cls=ARCVAETrainer)
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    assert all(np.isfinite(v) for m in hist for v in m.values())


def test_explosion_guard_skips_the_batch(corpus, capsys, monkeypatch):
    """A loss over ``explosion_max`` is reported and left out of the pass's
    mean; the update has been applied all the same."""
    tr, _ = _port(corpus, _params(False), name="boom", cls=ARCVAETrainer,
                  explosion_max=0.0)
    before = np.array(tr.params["decoder"]["fc_out"]["weight"].detach())
    out = tr._train_epoch_batches(0.0, 0.9)
    assert out["loss"] == 0.0
    assert capsys.readouterr().out.count("Loss explosion detected") == 6
    assert not np.array_equal(tr.params["decoder"]["fc_out"]["weight"].detach().numpy(),
                              before)


def test_latent_stats_small_dataset(corpus):
    """Fewer than 64 rows: one batch of the whole dataset."""
    rng = np.random.default_rng(0)
    small = MoleculeDataset([list(rng.integers(1, 24, 10)) for _ in range(7)],
                            rng.normal(size=(7, 1)), max_length=12)
    tmp, _ = corpus
    tr = ARCVAETrainer(params_from_numpy(_params(False)), ModelConfig(**MODEL),
                       TrainConfig(checkpoint_dir=str(tmp / "small")), small)
    stats = tr._get_latent_stats()
    assert np.isfinite(stats["mutual_info"])
    assert -2.0 <= stats["mu_min"] <= stats["mu_max"] <= 2.0


def test_checkpoint_roundtrip_bit_exact(corpus):
    tr, _ = _port(corpus, _params(True), name="rt", cls=ARCVAETrainer, epochs=1,
                  true_loss_batches=2)
    tr.train_epoch(0, 1)
    tr.history["epoch"].append(0)
    tr.save_checkpoint(epoch=0, is_best=True, best_val_loss=1.23)
    tr.join_saves()
    raw = np.load(tr.checkpoint_dir / "checkpoint_best.npz", allow_pickle=True)
    for k in ("epoch", "encoder_weights", "decoder_weights", "encoder_optimizer_state",
              "decoder_optimizer_state", "predictor_weights", "history", "best_val_loss"):
        assert k in raw, k
    tr2, _ = _port(corpus, _params(True, seed=99), name="rt2", cls=ARCVAETrainer)
    assert tr2.load_checkpoint(tr.checkpoint_dir / "checkpoint_best.npz") == 0
    for a, b in zip(tree_leaves(tr.params), tree_leaves(tr2.params)):
        assert torch.equal(a.detach(), b)
    for a, b in zip(tree_leaves(tr.opt_states), tree_leaves(tr2.opt_states)):
        assert torch.equal(a, b)
    assert tr2.history["epoch"] == [0]


class TestAsyncCheckpoint:
    def _trainer(self, corpus, name, **kw):
        tr, _ = _port(corpus, _params(False, seed=7), name=name, cls=ARCVAETrainer,
                      epochs=1, **kw)
        return tr, tr.checkpoint_dir

    def test_async_matches_sync_bytes(self, corpus):
        tr_a, dir_a = self._trainer(corpus, "ck_async", async_checkpoint=True)
        tr_s, dir_s = self._trainer(corpus, "ck_sync", async_checkpoint=False)
        for tr in (tr_a, tr_s):
            tr.history["epoch"].append(0)
            tr.save_checkpoint(epoch=0, is_best=True, best_val_loss=2.5)
            tr.join_saves()
        a = (dir_a / "checkpoint_epoch_000.npz").read_bytes()
        assert a == (dir_s / "checkpoint_epoch_000.npz").read_bytes()
        assert a == (dir_a / "checkpoint_best.npz").read_bytes()

    def test_snapshot_immune_to_history_mutation(self, corpus):
        tr, d = self._trainer(corpus, "ck_snap")
        tr.history["epoch"].append(0)
        tr.save_checkpoint(epoch=0)
        tr.history["epoch"].append(999)
        tr.join_saves()
        raw = np.load(d / "checkpoint_epoch_000.npz", allow_pickle=True)
        assert raw["history"].item()["epoch"] == [0]

    def test_failed_save_raises_at_join(self, corpus, monkeypatch):
        tr, _ = self._trainer(corpus, "ck_fail")

        def boom(*a, **kw):
            raise OSError("disk full")

        monkeypatch.setattr(ckpt_io, "write_checkpoint", boom)
        tr.save_checkpoint(epoch=0)
        with pytest.raises(RuntimeError, match="async checkpoint save"):
            tr.join_saves()
        tr.join_saves()  # the error is cleared once surfaced

    def test_atomic_write_leaves_no_tmp(self, corpus):
        tr, d = self._trainer(corpus, "ck_tmpclean")
        tr.save_checkpoint(epoch=0, is_best=True)
        tr.join_saves()
        assert [p.name for p in d.iterdir() if ".tmp." in p.name] == []

    def test_save_survives_next_in_place_step(self, corpus, monkeypatch):
        """The steps update params and Adam states in place, so an async
        save must write the values at save time, not those of the steps
        that run while it is in flight."""
        tr, d = self._trainer(corpus, "ck_inplace", learning_rate=3e-3,
                              true_loss_batches=2)
        tr.train_epoch(0, 2)
        # a copy: on the CPU the numpy view of a live leaf moves with it
        at_save = np.array(tr.params["decoder"]["fc_out"]["weight"].detach())
        step_at_save = int(tr.opt_states["decoder"]["step"])
        real = ckpt_io.build_checkpoint_host

        def slow_build(*a, **kw):  # hold the host copy open across the epoch
            time.sleep(0.5)
            return real(*a, **kw)

        monkeypatch.setattr(ckpt_io, "build_checkpoint_host", slow_build)
        tr.save_checkpoint(0, is_best=True)
        tr.train_epoch(1, 2)  # rewrites the live leaves in place
        tr.join_saves()
        loaded = ckpt_io.load_checkpoint(d / "checkpoint_best.npz")
        np.testing.assert_array_equal(loaded["params"]["decoder"]["fc_out"]["weight"],
                                      at_save)
        assert int(loaded["opt_states"]["decoder"]["step"]) == step_at_save
        after = tr.params["decoder"]["fc_out"]["weight"].detach().numpy()
        assert not np.array_equal(after, at_save)


def test_history_json_schema(corpus):
    tr, _ = _port(corpus, _params(False), name="hist", cls=ARCVAETrainer)
    tr.save_history(str(tr.checkpoint_dir))
    with open(tr.checkpoint_dir / "training_history.json") as f:
        assert set(json.load(f)) == set(HISTORY_KEYS)


def test_plot_written_or_skipped(corpus, monkeypatch, capsys):
    tr, _ = _port(corpus, _params(False), name="plot", cls=ARCVAETrainer)
    for i in range(2):
        tr.history["epoch"].append(i)
        for k in tr.history:
            if k != "epoch":
                tr.history[k].append(float(i))
    out = tr.checkpoint_dir / "hist.png"
    tr.plot_history(save_path=str(out))
    assert out.exists() and out.stat().st_size > 1000
    # without matplotlib the plot is skipped with a note
    import builtins
    real_import = builtins.__import__

    def no_mpl(name, *a, **kw):
        if name.startswith("matplotlib"):
            raise ImportError(name)
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    out2 = tr.checkpoint_dir / "hist2.png"
    tr.plot_history(save_path=str(out2))
    assert not out2.exists()
    assert "matplotlib not available" in capsys.readouterr().out


@pytest.mark.parametrize("tp,dp,n,refused", [
    (1, False, 1, False), (1, True, 1, False), (1, True, 2, True), (2, False, 4, True)])
def test_multi_device_refusal(tp, dp, n, refused):
    msg = multi_device_refusal(TrainConfig(model_parallel=tp, data_parallel=dp), n)
    assert (msg is not None) is refused
    if refused:
        assert "not yet ported (multi-device slice)" in msg


def test_trainer_refuses_model_parallel(corpus):
    with pytest.raises(NotImplementedError, match="multi-device slice"):
        _port(corpus, _params(False), name="mp", cls=ARCVAETrainer, model_parallel=2)


def test_readback_lags_the_dispatch(corpus, monkeypatch):
    """The pass reads a step's metrics only after LAG later steps were
    dispatched (and the rest at its end)."""
    order = []
    real_get = ttrainer._Readback.get
    real_step = ttrainer.train_step_gather

    def get(self):
        order.append("read")
        return real_get(self)

    def step(*a, **kw):
        order.append("step")
        return real_step(*a, **kw)

    monkeypatch.setattr(ttrainer._Readback, "get", get)
    monkeypatch.setattr(ttrainer, "train_step_gather", step)
    tr, _ = _port(corpus, _params(False), name="lag", cls=ARCVAETrainer)
    tr._train_epoch_batches(0.0, 0.9)
    assert order == ["step"] * (ttrainer.LAG + 1) + ["read", "step"] + ["read"] * ttrainer.LAG + ["read"]


@pytest.mark.parametrize("with_predictor", [False, True])
def test_arcvae_facade_layout_matches_jax(with_predictor):
    """The facade's params have the JAX facade's keys, shapes and init
    scales (the draws differ: a torch.Generator against threefry), and its
    forward and sampler run."""
    cfg = ModelConfig(**MODEL)
    vae = ARCVAE(cfg, torch.Generator().manual_seed(0), with_predictor=with_predictor,
                 device="cpu")
    port = jax.tree_util.tree_leaves_with_path(params_to_numpy(vae.params))
    ref = jax.tree_util.tree_leaves_with_path(_params(with_predictor))
    assert [p for p, _ in port] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(port, ref):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32, path
        if a.size >= 64:  # the largest draw of a big leaf sits near its scale
            assert 0.8 < np.abs(a).max() / np.abs(b).max() < 1.25, path
    np.testing.assert_array_equal(vae.params["encoder"]["fc_logvar"]["bias"].numpy(),
                                  np.full(MODEL["latent_dim"], 0.35, np.float32))
    x = torch.randint(1, 24, (4, 12))
    logits, mu, logvar, z = vae(x, torch.zeros(4, 1), torch.randn(4, 8),
                                torch.ones(12, dtype=torch.bool))
    assert logits.shape == (4, 12, 24) and z.shape == mu.shape == logvar.shape == (4, 8)
    toks = vae.generate(4, np.zeros((4, 1)), torch.Generator().manual_seed(1), max_length=7)
    assert toks.shape == (4, 7)
    with pytest.raises(ValueError, match="batch_size"):
        vae.generate(3, np.zeros((4, 1)), torch.Generator(), max_length=7)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
def test_arcvae_facade_defaults_to_the_card():
    """Without ``device`` the facade goes to the card, and without CUDA it
    raises instead of moving to the CPU."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ARCVAE(ModelConfig(**MODEL), torch.Generator().manual_seed(0))
