"""The port's multi-device training, evaluation and generation against the
JAX package on the CPU.

Ranks are processes started by ``parallel/launch.py:spawn`` (gloo, 2 or 4
ranks, each group with its own timeout); their workers live in the JAX-free
``tests/torch_parallel_workers.py``. The JAX side runs here, on the 8-device
CPU mesh of ``tests/conftest.py``:

* ``param_pspec`` equals JAX's on every leaf of the default and scaled
  trees, with the predictor;
* the data-parallel steps (plain, gather-fed, K=4, eval; the shard_map
  semantics) on 2 ranks against ``make_shmap_*`` on a 2-device mesh, each
  shard's noise drawn from ``fold_in(key, i)`` as JAX draws it;
* tensor parallelism at (1, 2) and (2, 2) against JAX's single-device
  ``train_step`` on the global batch and noise (the GSPMD semantics);
* a checkpoint written under tensor parallelism, read by JAX's loader;
* the trainer, the generate and encode CLIs with ``--data_parallel``, and
  the dry run.

Tolerances (float32, as ``tests/test_torch_train_step.py``): loss scalars
1e-5 relative, ``grad_norm`` 1e-4 relative, params after Adam 1e-5
absolute; the params of every rank are bitwise equal.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlx_vae_tpu.config import ModelConfig as JaxConfig
from mlx_vae_tpu.config import TrainConfig as JaxTrainConfig
from mlx_vae_tpu.models import ARCVAE
from mlx_vae_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mlx_vae_tpu.parallel.mesh import param_pspec as jax_param_pspec
from mlx_vae_tpu.train import steps as jsteps
from mlx_vae_tpu.train.optim import adam_init as jadam_init
from mlx_vae_tpu_torch.parallel.launch import RankFailed, spawn
from mlx_vae_tpu_torch.parallel.mesh import param_pspec

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_workers as workers  # noqa: E402

SCALARS = ("total_loss", "recon_loss", "kl_loss", "weighted_kl", "collapse_penalty",
           "prop_loss", "weighted_prop_loss", "mutual_info", "mi_penalty")
MODEL = dict(vocab_size=24, embedding_dim=16, hidden_dim=32, latent_dim=8,
             num_conditions=1, num_layers=2)
B, L = 8, 10
TIMEOUT = 120


def _params(seed=7, with_predictor=True, **model):
    cfg = JaxConfig(**{**MODEL, **model})
    vae = ARCVAE(cfg, jax.random.PRNGKey(seed), with_predictor=with_predictor)
    return cfg, jax.tree_util.tree_map(np.array, vae.params)


def _names(path):
    return tuple(p.key for p in path)


@pytest.mark.parametrize("model", [MODEL, dict(vocab_size=128, embedding_dim=128,
                                               hidden_dim=1024, latent_dim=512,
                                               num_conditions=3, num_layers=4)])
def test_param_pspec_equals_jax(model):
    cfg = JaxConfig(**model)
    shapes = jax.eval_shape(lambda k: ARCVAE(cfg, k, with_predictor=True).params,
                            jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_leaves_with_path(shapes)
    assert len(leaves) > 20
    for path, _ in leaves:
        want = jax_param_pspec(path)
        got = param_pspec(_names(path))
        assert (got == "model") == (len(want) > 0 and want[0] == "model"), path


def _jax_noise(key, rows, tf):
    k_rep, k_tf, _ = jax.random.split(key, 3)
    return {"eps": np.array(jax.random.normal(k_rep, (rows, MODEL["latent_dim"]))),
            "tf_mask": np.array(jax.random.uniform(k_tf, (L,)) < tf)}


def _batches(n, seed=100):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, MODEL["vocab_size"], (B, L)).astype(np.int32),
             rng.standard_normal((B, 1)).astype(np.float32)) for _ in range(n)]


def _assert_metrics(tm, jm, what):
    for k in SCALARS:
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=f"{what}: {k}")
    if "grad_norm" in jm:
        np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]), rtol=1e-4,
                                   err_msg=f"{what}: grad_norm")


def _assert_params(tp, jp, what):
    want = dict(jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, jp)))
    got = dict(jax.tree_util.tree_leaves_with_path(tp))
    assert set(map(str, got)) == set(map(str, want)), what
    for path, a in got.items():
        np.testing.assert_allclose(a, want[path], rtol=0, atol=1e-5, err_msg=f"{what}: {path}")


def _assert_replicated(results):
    """Every rank's (gathered) params and Adam moments are bitwise equal."""
    first = jax.tree_util.tree_leaves(results[0]["params"]) + \
        jax.tree_util.tree_leaves(results[0]["opt"])
    for r in results[1:]:
        other = jax.tree_util.tree_leaves(r["params"]) + jax.tree_util.tree_leaves(r["opt"])
        assert all(np.array_equal(a, b) for a, b in zip(first, other))


def _jtree(npp):
    return jax.tree_util.tree_map(jnp.array, npp)


HYP = dict(grad_clip=1.0, learning_rate=1e-3, lambda_mi=0.5)


def _dp_case(mode, cfg, npp, n=2, steps=3):
    """The port case and the JAX reference of one data-parallel mode on
    ``n`` shards."""
    jt = JaxTrainConfig(**HYP)
    mesh = jax_make_mesh(jax.devices()[:n])
    jp = _jtree(npp)
    jo = {k: jadam_init(p) for k, p in jp.items()}
    beta, tf = 0.05, 0.8
    rng = np.random.default_rng(5)
    corpus = 4 * B
    toks = rng.integers(1, MODEL["vocab_size"], (corpus, L)).astype(np.int32)
    props = rng.standard_normal((corpus, 1)).astype(np.float32)
    idx = np.stack([rng.permutation(corpus)[:B] for _ in range(steps)]).astype(np.int32)
    key = jax.random.PRNGKey(40)
    rows = B // n
    jm = []
    if mode == "multi":
        # one key for the K steps: per shard fold_in, then one split a step
        noise = []
        for i in range(n):
            k_i, per = jax.random.fold_in(key, i), []
            for _ in range(steps):
                k_i, k = jax.random.split(k_i)
                per.append(_jax_noise(k, rows, tf))
            noise.append(per)
        step = jsteps.make_shmap_multi_train_step_gather(mesh, cfg, jt)
        jp, jo, m = step(jp, jo, jnp.asarray(toks), jnp.asarray(props), jnp.asarray(idx),
                         key, jnp.float32(beta), jnp.float32(tf))
        jm = [{k2: v[j] for k2, v in m.items()} for j in range(steps)]
    else:
        keys = [jax.random.PRNGKey(40 + s) for s in range(steps)]
        noise = [[_jax_noise(jax.random.fold_in(k, i), rows, tf if "eval" not in mode else 0.0)
                  for k in keys] for i in range(n)]
        if mode == "train":
            step = jsteps.make_shmap_train_step(mesh, cfg, jt)
            for s in range(steps):
                x, c = toks[idx[s]], props[idx[s]]
                jp, jo, m = step(jp, jo, jnp.asarray(x), jnp.asarray(c), keys[s],
                                 jnp.float32(beta), jnp.float32(tf))
                jm.append(m)
        elif mode == "gather":
            step = jsteps.make_shmap_train_step_gather(mesh, cfg, jt)
            for s in range(steps):
                jp, jo, m = step(jp, jo, jnp.asarray(toks), jnp.asarray(props),
                                 jnp.asarray(idx[s]), keys[s], jnp.float32(beta),
                                 jnp.float32(tf))
                jm.append(m)
        elif mode == "eval_gather":
            step = jsteps.make_shmap_eval_step_gather(mesh, cfg, jt)
            jm.append(step(jp, jnp.asarray(toks), jnp.asarray(props), jnp.asarray(idx[0]),
                           keys[0], jnp.float32(beta), jnp.float32(0.0)))
        else:
            step = jsteps.make_shmap_eval_step(mesh, cfg, jt)
            jm.append(step(jp, jnp.asarray(toks[idx[0]]), jnp.asarray(props[idx[0]]), keys[0],
                           jnp.float32(beta), jnp.float32(0.0)))
    case = {"mode": mode, "model": MODEL, "train": HYP, "params": npp, "noise": noise,
            "beta": beta, "tf": tf if "eval" not in mode else 0.0, "tokens": toks,
            "props": props, "idx": idx,
            "batches": [(toks[i], props[i]) for i in idx]}
    return case, jp, jm


DP_MODES = ("train", "gather", "multi", "eval", "eval_gather")


def _tp_case(data, model, num_conditions):
    """The port case and the JAX reference of 3 tensor-parallel steps on a
    (data, model) mesh: JAX's single-device ``train_step`` over the global
    batch, whose noise each data rank cuts to its rows."""
    cfg, npp = _params(num_conditions=num_conditions)
    jt = JaxTrainConfig(**HYP)
    jp = _jtree(npp)
    jo = {k: jadam_init(p) for k, p in jp.items()}
    beta, tf = 0.05, 0.8
    rng = np.random.default_rng(11)
    batches = [(rng.integers(1, MODEL["vocab_size"], (B, L)).astype(np.int32),
                rng.standard_normal((B, num_conditions)).astype(np.float32)) for _ in range(3)]
    rows = B // data
    noise = [[] for _ in range(data)]
    jm = []
    for s, (x, c) in enumerate(batches):
        key = jax.random.PRNGKey(60 + s)
        g = _jax_noise(key, B, tf)
        for d in range(data):
            noise[d].append({"eps": g["eps"][d * rows:(d + 1) * rows], "tf_mask": g["tf_mask"]})
        jp, jo, m = jsteps.train_step(jp, jo, cfg, jt, jnp.asarray(x), jnp.asarray(c), key,
                                      jnp.float32(beta), jnp.float32(tf))
        jm.append(m)
    case = {"mode": "train", "model": {**MODEL, "num_conditions": num_conditions},
            "train": HYP, "params": npp, "noise": noise, "beta": beta, "tf": tf,
            "batches": batches, "tp": model, "ranks": list(range(data * model))}
    return case, jp, jm


@pytest.fixture(scope="module")
def two_ranks():
    """Every 2-rank case (the data-parallel modes and tensor parallelism at
    (1, 2)) in one group of 2 ranks; returns ``{name: (results, jax
    params, jax metrics)}``."""
    cfg, npp = _params()
    named = {m: _dp_case(m, cfg, npp, steps=4 if m == "multi" else 3) for m in DP_MODES}
    named["tp_1x2"] = _tp_case(1, 2, 1)
    names = list(named)
    results = spawn(workers.cases, 2, "cpu", args=([named[n][0] for n in names],),
                    timeout=TIMEOUT)
    return {n: ([r[i] for r in results], named[n][1], named[n][2])
            for i, n in enumerate(names)}


@pytest.fixture(scope="module")
def four_ranks():
    """Tensor parallelism at (2, 2) in one group of 4 ranks."""
    case, jp, jm = _tp_case(2, 2, 2)
    results = spawn(workers.cases, 4, "cpu", args=([case],), timeout=TIMEOUT)
    return {"tp_2x2": ([r[0] for r in results], jp, jm)}


def _check(results, jp, jm, what, train=True):
    for r in results:
        assert len(r["metrics"]) == len(jm)
        for s, (tm, m) in enumerate(zip(r["metrics"], jm)):
            _assert_metrics(tm, m, f"{what} step {s}")
            for k in ("mu_abs_max", "logvar_min", "logvar_max"):
                np.testing.assert_allclose(tm[k], float(m[k]), rtol=1e-5, err_msg=k)
    _assert_replicated(results)
    if train:
        _assert_params(results[0]["params"], jp, f"{what}: params after Adam")


@pytest.mark.parametrize("mode", DP_MODES)
def test_dp_steps_match_shard_map(two_ranks, mode):
    """The shard_map semantics: per-rank rows and noise, gradients and
    metrics reduced over the data group; params bitwise replicated."""
    results, jp, jm = two_ranks[mode]
    _check(results, jp, jm, mode, train="eval" not in mode)


@pytest.mark.parametrize("data,model", [(1, 2), (2, 2)])
def test_tensor_parallel_matches_single_device(two_ranks, four_ranks, data, model):
    """GSPMD semantics: the (data, model) mesh's steps equal JAX's
    single-device ``train_step`` over the global batch and noise; at data=2
    this holds only if the gathered rows' backward is scaled by the data
    size (the mutual information is a function of the global batch). At
    (2, 2) the predictor's 2-wide head is split too."""
    results, jp, jm = {**two_ranks, **four_ranks}[f"tp_{data}x{model}"]
    assert [r["mesh"][:2] for r in results] == [(data, model)] * (data * model)
    _check(results, jp, jm, f"tp {data}x{model}")


# ------------------------------------------------------------------ the CLIs

TINY = ["--vocab_size", "24", "--embedding_dim", "16", "--hidden_dim", "32",
        "--latent_dim", "8", "--num_layers", "2", "--batch_size", "32",
        "--learning_rate", "3e-3", "--device", "cpu", "--epochs", "2",
        "--checkpoint_freq", "1"]


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """Two groups of 2 ranks: one runs ``cli.train --data_parallel`` fed
    from the device and from the host, then ``cli.train --model_parallel
    2``; the other ``cli.generate --data_parallel`` (greedy) and
    ``cli.encode --data_parallel``. The same one-rank runs go here, in this
    process. The corpus splits 88 / 11 / 11: two train batches of 32 and
    one of 24, and a validation split smaller than one batch."""
    from mlx_vae_tpu.data.prepare import make_synthetic_dataset
    from mlx_vae_tpu_torch.cli import encode as tencode
    from mlx_vae_tpu_torch.cli import generate as tgenerate
    from mlx_vae_tpu_torch.cli import train as ttrain

    d = tmp_path_factory.mktemp("pcli")
    data = str(d / "d.json")
    make_synthetic_dataset(n=110, vocab_size=24, max_length=12, path=data)

    def train(name, *extra):
        return ("train", ["--data", data, *TINY, "--checkpoint_dir", str(d / name), *extra])

    ck = str(d / "one" / "checkpoint_epoch_001.npz")
    gen = ["--checkpoint", ck, "--device", "cpu", "--num_molecules", "20", "--batch_size",
           "8", "--max_length", "10", "--greedy"]
    enc = ["--checkpoint", ck, "--data", data, "--device", "cpu", "--batch_size", "8"]
    trains = [train("dp_dev", "--data_parallel"),
              train("dp_host", "--data_parallel", "--host_data"),
              train("tp", "--model_parallel", "2")]
    decodes = [("generate", gen + ["--output", str(d / "g2.npz"), "--data_parallel"]),
               ("encode", enc + ["--output", str(d / "e2.npz"), "--report", str(d / "r2.json"),
                                 "--data_parallel"]),
               # under the group without --data_parallel: each rank runs the
               # whole job, and rank 0 alone writes
               ("generate", gen + ["--output", str(d / "g3.npz")]),
               ("encode", enc + ["--output", str(d / "e3.npz"), "--report", str(d / "r3.json"),
                                 "--no_reconstruct"])]
    ttrain.main(train("one")[1])  # the one-rank run (and the checkpoint decoded below)
    spawn(workers.cli_runs, 2, "cpu", args=(trains,), timeout=TIMEOUT)
    results = spawn(workers.cli_runs, 2, "cpu", args=(decodes,), timeout=TIMEOUT)
    tgenerate.main(gen + ["--output", str(d / "g1.npz")])
    one_enc = tencode.main(enc + ["--output", str(d / "e1.npz"), "--report", str(d / "r1.json")])
    return d, results, one_enc


def _hist(path):
    import json
    return json.loads((path / "training_history.json").read_text())


def test_dp_trainer_device_feed_equals_host_feed(cli):
    """Two epochs of --data_parallel on 2 ranks: the device-resident corpus
    and the host feed give the same history and checkpoint bit for bit (the
    trailing partial batch is dropped by both); the validation split is
    smaller than one batch, so every val metric is the +inf sentinel."""
    from mlx_vae_tpu_torch.train.checkpoint import load_checkpoint

    d = cli[0]
    dev, host = _hist(d / "dp_dev"), _hist(d / "dp_host")
    assert dev == host
    assert dev["epoch"] == [0, 1] and all(np.isfinite(dev["train_loss"]))
    assert dev["val_loss"] == [float("inf")] * 2 and dev["val_kl"] == [float("inf")] * 2
    a = load_checkpoint(d / "dp_dev" / "checkpoint_epoch_001.npz")
    b = load_checkpoint(d / "dp_host" / "checkpoint_epoch_001.npz")
    for x, y in zip(jax.tree_util.tree_leaves(a["params"]), jax.tree_util.tree_leaves(b["params"])):
        np.testing.assert_array_equal(x, y)
    # two full batches an epoch: the 24-row tail cannot split over 2 ranks
    assert int(a["opt_states"]["encoder"]["step"]) == 4


def test_tp_trainer_runs_partial_batches_and_equals_one_rank(cli):
    """--model_parallel 2 alone: a (1, 2) mesh, partial batches run, and the
    run equals the one-rank run from the same seed; its checkpoint (full
    arrays, written by rank 0) is read by JAX's loader key for key."""
    from mlx_vae_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint

    d = cli[0]
    tp, one = _hist(d / "tp"), _hist(d / "one")
    for k in ("train_loss", "train_recon", "train_kl", "val_loss", "mutual_info"):
        np.testing.assert_allclose(tp[k], one[k], rtol=1e-4, err_msg=k)
    a = jax_load_checkpoint(d / "tp" / "checkpoint_epoch_001.npz")
    b = jax_load_checkpoint(d / "one" / "checkpoint_epoch_001.npz")
    pa = dict(jax.tree_util.tree_leaves_with_path(a["params"]))
    pb = dict(jax.tree_util.tree_leaves_with_path(b["params"]))
    assert pa.keys() == pb.keys()
    for k, v in pa.items():
        assert v.shape == pb[k].shape, k
        np.testing.assert_allclose(v, pb[k], rtol=0, atol=1e-4, err_msg=str(k))
    assert int(a["opt_states"]["decoder"]["step"]) == 6  # 3 batches an epoch


def test_generate_data_parallel_greedy_equals_one_rank(cli):
    d = cli[0]
    two, one = np.load(d / "g2.npz")["tokens"], np.load(d / "g1.npz")["tokens"]
    assert two.shape == (20, 10)
    np.testing.assert_array_equal(two, one)


def test_encode_data_parallel_equals_one_rank(cli):
    d, results, one = cli
    for r in results:  # every rank holds the gathered arrays
        for k in ("mu", "logvar", "next_tokens", "decoded"):
            np.testing.assert_array_equal(r[1][0][k], one[k], err_msg=k)
    saved = np.load(d / "e2.npz")
    np.testing.assert_array_equal(saved["mu"], one["mu"])


def test_rank0_alone_writes_the_cli_outputs(cli):
    """generate and encode, with and without --data_parallel under a group
    of two: rank 0 writes every output, rank 1 none (no two ranks write one
    path); without --data_parallel each rank ran the whole job."""
    d, results, one = cli
    assert [saved for _, saved in results[0]] == [
        [str(d / "g2.npz")], [str(d / "e2.npz")], [str(d / "g3.npz")], [str(d / "e3.npz")]]
    assert all(saved == [] for _, saved in results[1])
    np.testing.assert_array_equal(np.load(d / "g3.npz")["tokens"],
                                  np.load(d / "g1.npz")["tokens"])
    np.testing.assert_array_equal(results[1][3][0]["mu"], one["mu"])


# ------------------------------------------------------------- the launcher

def test_spawn_raises_a_ranks_error_and_kills_the_rest():
    with pytest.raises(RankFailed, match="rank 1 of 2 failed(.|\n)*rank 1 refuses"):
        spawn(workers.fail_on_rank1, 2, "cpu", timeout=TIMEOUT)


def test_spawn_times_out_instead_of_hanging():
    with pytest.raises(TimeoutError, match="did not finish within 2"):
        spawn(workers.sleep_forever, 2, "cpu", timeout=2)


def test_dryrun_four_ranks(capfd):
    """The dry run at N=4 on gloo ranks: a (2, 2) tensor-parallel step, the
    data-parallel gather step, eval and generation, then the scaled width."""
    from mlx_vae_tpu_torch.parallel.dryrun import dryrun

    results = dryrun(4, "cpu", timeout=TIMEOUT)
    line = results[0]["line"]
    assert line.startswith("dryrun_multichip(4): mesh={'data': 2, 'model': 2}")
    assert "gen=(8, 12)" in line and "gen=(4, 8)" in line and line.endswith("OK")
    assert capfd.readouterr().out.strip().splitlines()[-1] == line
    # the CPU runs the kernels' plain versions: no wrapper counts a launch
    assert all(n == 0 for r in results for tier in r["launches"].values()
               for part in tier.values() for n in part.values())


def test_dryrun_on_the_card_refuses_without_one():
    """The dry run defaults to the card and never falls back to the CPU
    quietly: without CUDA it exits with an error before any rank starts."""
    from unittest import mock

    import torch

    from mlx_vae_tpu_torch.parallel.dryrun import main

    with mock.patch.object(torch.cuda, "is_available", return_value=False), \
            pytest.raises(SystemExit, match="CUDA is not available"):
        main(["2"])
