"""The port's ELBO curve-parity study (``mlx_vae_tpu_torch/studies/
elbo_compare.py``) against the JAX study (``benchmarks/elbo_compare.py``,
imported by path).

* ``analyze`` is a whole copy: on the recorded runs of both committed JAX
  results files it gives the stored ``analysis`` exactly (``==`` after the
  JSON round trip the files went through).
* Curve parity at a tiny size: the port's ``run`` and the JAX ``run`` train
  one seed from the same numpy params (the JAX ``ARCVAE`` init of the seed)
  with the JAX trainer's device noise (the port trainer's ``_next_noise``
  draws from the JAX key stream, as ``tests/test_torch_trainer.py``'s
  ``KeyedTrainer`` does): V=40, E=32, H=64, latent 16, 2 layers, f32, 300
  synthetic molecules, batch 32, 3 epochs of a 3-epoch schedule, both modes.
  Every curve key agrees per epoch within ``test_two_epochs_match_jax``'s
  tolerances: 1e-5 relative, 1e-7 absolute.
* ``compare_to_reference`` on hand-built curves: an equal port curve holds
  parity, a shifted one fails criterion (a); a reference whose config
  differs is refused; the Welch interval and the t quantile agree with
  scipy.
* The CLI on the CPU end to end (default model, a 300-molecule corpus, 2
  epochs): a fresh run, a ``--merge_from`` run that trains only the new
  seed, a ``--reanalyze`` that reproduces the analysis; no output path under
  ``benchmarks/`` is accepted.
"""

import ast
import importlib.util
import json
import math
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from mlx_vae_tpu.config import ModelConfig as JaxConfig
from mlx_vae_tpu.config import TrainConfig as JaxTrainConfig
from mlx_vae_tpu.data.prepare import make_synthetic_dataset
from mlx_vae_tpu.data.split import load_and_split as jax_load_and_split
from mlx_vae_tpu.models import ARCVAE as JaxARCVAE
from mlx_vae_tpu_torch.data.split import load_and_split
from mlx_vae_tpu_torch.studies import elbo_compare as ec
from mlx_vae_tpu_torch.train.trainer import ARCVAETrainer
from mlx_vae_tpu_torch.utils.tree import params_from_numpy

ROOT = Path(__file__).resolve().parent.parent
JAX_STUDY = ROOT / "benchmarks" / "elbo_compare.py"
RECORDED = ["elbo_compare.json", "elbo_compare_chem.json"]
MODEL = dict(vocab_size=40, embedding_dim=32, hidden_dim=64, latent_dim=16,
             num_conditions=1, num_layers=2)
EPOCHS, BATCH, SEED = 3, 32, 67
RTOL, ATOL = 1e-5, 1e-7
CURVE_KEYS = ("elbo", "train_loss", "val_loss", "recon", "kl", "mutual_info")
MODES = ("fixed_decoder", "reference_zero_state")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test runner's parallel workers would
    otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_study():
    spec = importlib.util.spec_from_file_location("jax_elbo_compare", JAX_STUDY)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """300 molecules -> 240 train (7 batches of 32 and one of 16), 30 val."""
    path = tmp_path_factory.mktemp("corpus") / "syn.json"
    make_synthetic_dataset(n=300, vocab_size=40, max_length=24, path=str(path))
    return str(path)


# ----------------------------------------------------------------- analyze


@pytest.mark.parametrize("name", RECORDED)
def test_analyze_reproduces_recorded_analysis(name):
    rec = json.loads((ROOT / "benchmarks" / name).read_text())
    curves = {m: {int(s): c for s, c in by.items()} for m, by in rec["runs"].items()}
    epochs = rec["config"]["epochs"]
    got = json.loads(json.dumps(ec.analyze(curves, epochs, epochs // 2)))
    assert got == rec["analysis"]


@pytest.mark.parametrize("fn", ["_rel_gap", "_per_epoch_mean", "analyze"])
def test_analysis_functions_are_whole_copies(fn):
    def source(path):
        text = path.read_text()
        node = next(n for n in ast.parse(text).body
                    if isinstance(n, ast.FunctionDef) and n.name == fn)
        return ast.get_source_segment(text, node)

    assert source(Path(ec.__file__)) == source(JAX_STUDY)


# ------------------------------------------------------------- curve parity


def _noise_from(k, batch, length, tf_ratio):
    k_rep, k_tf, _ = jax.random.split(k, 3)
    return {"eps": torch.from_numpy(np.array(
                jax.random.normal(k_rep, (batch, MODEL["latent_dim"])))),
            "tf_mask": torch.from_numpy(np.array(
                jax.random.uniform(k_tf, (length,)) < jnp.float32(tf_ratio)))}


class KeyedTrainer(ARCVAETrainer):
    """The port's trainer with its noise drawn from the JAX trainer's key
    stream (one step a dispatch: per dispatch ``key, k = split(key)``, per
    step ``k_rep, k_tf, _ = split(k, 3)``)."""

    def __init__(self, *a, seed, **kw):
        super().__init__(*a, seed=seed, **kw)
        self._jkey = jax.random.PRNGKey(seed)

    def _next_noise(self, batch, length, tf_ratio, steps=None):
        assert steps is None
        self._jkey, k = jax.random.split(self._jkey)
        return _noise_from(k, batch, length, tf_ratio)


@pytest.mark.parametrize("mode", MODES)
def test_curve_matches_jax(jax_study, corpus, mode, tmp_path, monkeypatch):
    jcfg = JaxConfig(**MODEL, reference_zero_state=mode == "reference_zero_state")
    jtcfg = JaxTrainConfig(epochs=EPOCHS, batch_size=BATCH, learning_rate=5e-4,
                           beta_warmup_epochs=EPOCHS, checkpoint_dir=str(tmp_path / "j"),
                           true_loss_batches=10, seed=SEED)
    jtrain, jval, _, _ = jax_load_and_split(corpus)
    want = jax_study.run(mode, SEED, jcfg, jtcfg, jtrain, jval, EPOCHS)

    # the JAX run's init, handed to the port's run in place of its own draw
    npp = jax.tree_util.tree_map(np.array, JaxARCVAE(jcfg, jax.random.PRNGKey(SEED)).params)
    monkeypatch.setattr(ec, "ARCVAE", lambda cfg, gen, device: types.SimpleNamespace(
        params=params_from_numpy(npp, device)))
    monkeypatch.setattr(ec, "ARCVAETrainer", KeyedTrainer)
    mcfg = ec.mode_configs(False, compute_dtype="float32", **MODEL)[mode]
    assert mcfg.reference_zero_state == jcfg.reference_zero_state
    tcfg = ec.train_config(EPOCHS, BATCH, SEED, str(tmp_path / "t"))
    train, val, _, _ = load_and_split(corpus)
    got = ec.run(mode, SEED, mcfg, tcfg, train, val, EPOCHS, device="cpu")

    assert [c["epoch"] for c in got] == [c["epoch"] for c in want] == list(range(EPOCHS))
    for g, w in zip(got, want):
        assert g["seconds"] > 0 and 0 < g["train_pass_s"] <= g["seconds"]
        for k in CURVE_KEYS:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{mode} epoch {g['epoch']}: {k}")


def test_run_stop_ends_early(corpus, tmp_path, monkeypatch):
    """``stop`` trains the first epochs of the whole schedule: epoch 1 of a
    3-epoch run is epoch 1 of the full run, beta and teacher forcing
    included."""
    mcfg = ec.mode_configs(False, compute_dtype="float32", **MODEL)["fixed_decoder"]
    train, val, _, _ = load_and_split(corpus)
    full = ec.run("fixed_decoder", SEED, mcfg, ec.train_config(EPOCHS, BATCH, SEED,
                  str(tmp_path / "a")), train, val, EPOCHS, device="cpu")
    part = ec.run("fixed_decoder", SEED, mcfg, ec.train_config(EPOCHS, BATCH, SEED,
                  str(tmp_path / "b")), train, val, EPOCHS, device="cpu", stop=2)
    assert len(part) == 2
    for g, w in zip(part, full):
        assert all(g[k] == w[k] for k in CURVE_KEYS)


# ------------------------------------------------------ compare_to_reference

REF_CONFIG = {"epochs": 6, "molecules": 1000, "batch_size": 32, "max_length": 80,
              "drug_like": False}


def _curves(seeds, scale=1.0, spread=0.01):
    """``{mode: {seed: [epoch dicts]}}``: a falling ELBO curve per mode, each
    seed's own wiggle of relative size ``spread``, times ``scale``."""
    rng = np.random.default_rng(0)
    out = {}
    for i, mode in enumerate(MODES):
        out[mode] = {}
        for s in seeds:
            wiggle = 1 + spread * rng.standard_normal(REF_CONFIG["epochs"])
            out[mode][s] = [{"epoch": e,
                             "elbo": float(scale * (5.0 - 0.3 * e + 0.1 * i) * wiggle[e])}
                            for e in range(REF_CONFIG["epochs"])]
    return out


def _reference(seeds=range(67, 75)):
    curves = _curves(seeds)
    e = REF_CONFIG["epochs"]
    return json.loads(json.dumps({
        "runs": {m: {str(s): c for s, c in by.items()} for m, by in curves.items()},
        "analysis": ec.analyze(curves, e, e // 2),
        "config": {**REF_CONFIG, "seeds": list(seeds)}}))


def test_equal_curves_hold_parity():
    ref = _reference()
    port = {m: {int(s): c for s, c in by.items()} for m, by in ref["runs"].items()}
    out = ec.compare_to_reference(port, ref, REF_CONFIG)
    for mode in MODES:
        r = out["modes"][mode]
        assert r["post_warmup"]["mean_curve_gap"]["mean"] == 0.0
        assert r["time_averaged_post_warmup_elbo"]["welch"]["diff"] == 0.0
        assert r["a_gap_within_noise"] and r["b_welch_ci_contains_zero"] and r["parity"]
    assert out["port_seeds"] == out["reference_seeds"] == list(range(67, 75))
    assert out["warmup_epochs_excluded"] == 3


def test_shifted_curves_fail_criterion_a():
    """Port seeds drawn as the JAX ones but the curves 5% higher: the
    seed-mean gap (~5%) is far over 1.25x the ~1% noise floor."""
    ref = _reference()
    port = _curves(range(1, 5), scale=1.05)
    out = ec.compare_to_reference(port, ref, REF_CONFIG)
    for mode in MODES:
        r = out["modes"][mode]
        noise = r["post_warmup"]["jax_noise_floor"]["mean"]
        assert 0.0 < noise < 0.02
        assert r["post_warmup"]["mean_curve_gap"]["mean"] > ec.NOISE_FACTOR * noise
        assert r["a_gap_within_noise"] is False and r["parity"] is False
        w = r["time_averaged_post_warmup_elbo"]["welch"]
        assert w["rel_ci95"][0] > 0.0  # the shift is also far outside the CI
        b = r["time_averaged_post_warmup_elbo"]["bootstrap"]["rel_ci95"]
        assert 0.0 < b[0] <= b[1]


def test_one_port_seed_leaves_parity_undecided():
    out = ec.compare_to_reference(_curves([67]), _reference(), REF_CONFIG)
    for r in out["modes"].values():
        assert r["time_averaged_post_warmup_elbo"]["welch"] is None
        assert r["parity"] is None


@pytest.mark.parametrize("key,value", [("epochs", 5), ("molecules", 999), ("batch_size", 64),
                                       ("max_length", 64), ("drug_like", True)])
def test_mismatched_reference_config_refused(key, value):
    ref = _reference()
    with pytest.raises(ValueError, match=key):
        ec.compare_to_reference(_curves([67, 68]), ref, {**REF_CONFIG, key: value})


def test_reference_without_recorded_keys_uses_their_defaults():
    """Files written before ``max_length`` / ``drug_like`` were recorded
    used 80 and the synthetic corpus."""
    ref = _reference()
    for k in ("max_length", "drug_like"):
        del ref["config"][k]
    ec.check_reference_config(ref, REF_CONFIG)
    with pytest.raises(ValueError, match="max_length"):
        ec.check_reference_config(ref, {**REF_CONFIG, "max_length": 64})


@pytest.mark.parametrize("df", [1.0, 2.5, 4.0, 14.3, 30.0, 120.0])
def test_t_quantile_matches_scipy(df):
    assert ec.t_quantile(df) == pytest.approx(scipy.stats.t.ppf(0.975, df), rel=1e-9)


def test_welch_matches_scipy():
    rng = np.random.default_rng(3)
    a, b = list(rng.normal(4.3, 0.05, 6)), list(rng.normal(4.25, 0.1, 16))
    w = ec.welch(a, b)
    ci = scipy.stats.ttest_ind(a, b, equal_var=False).confidence_interval(0.95)
    assert w["ci95"] == pytest.approx([ci.low, ci.high], rel=1e-9)
    assert w["rel_ci95"] == pytest.approx([ci.low / np.mean(b), ci.high / np.mean(b)],
                                          rel=1e-9)
    assert w["ci_contains_zero"] == (ci.low <= 0 <= ci.high)


# ---------------------------------------------------------------------- CLI


@pytest.mark.parametrize("argv", [
    ["--output", "benchmarks/elbo_compare_port.json"],
    ["--reanalyze", "benchmarks/elbo_compare.json"],
    ["--drug_like", "--reanalyze", "benchmarks/elbo_compare_chem.json"],
])
def test_output_under_benchmarks_refused(argv, monkeypatch):
    monkeypatch.chdir(ROOT)
    before = {p.name: p.read_bytes() for p in (ROOT / "benchmarks").glob("elbo_compare*")}
    with pytest.raises(SystemExit, match="benchmarks/"):
        ec.main(argv + ["--device", "cpu"])
    after = {p.name: p.read_bytes() for p in (ROOT / "benchmarks").glob("elbo_compare*")}
    assert after == before


def test_cli_refuses_mismatched_reference_before_training(tmp_path):
    out = tmp_path / "out.json"
    with pytest.raises(SystemExit, match="reference config mismatch: epochs"):
        ec.main(["--epochs", "2", "--molecules", "300", "--device", "cpu",
                 "--output", str(out)])
    assert not out.exists()


def test_cli_runs_merges_and_reanalyzes_on_cpu(tmp_path, capsys):
    """The default model on the plain route at a tiny corpus: seed 67, then
    seed 68 merged in (67's curves carried over untrained), then a
    reanalysis that reproduces the analysis and the comparison."""
    cfg = {"epochs": 2, "molecules": 300, "batch_size": 256, "max_length": 80,
           "drug_like": False}
    ref = tmp_path / "ref.json"
    seeds = range(67, 71)
    curves = {m: {s: [{"epoch": e, "elbo": 4.0 + 0.01 * (s - 67) - 0.1 * e}
                      for e in range(2)] for s in seeds} for m in MODES}
    ref.write_text(json.dumps({
        "runs": {m: {str(s): c for s, c in by.items()} for m, by in curves.items()},
        "analysis": ec.analyze(curves, 2, 1), "config": {**cfg, "seeds": list(seeds)}}))
    out = tmp_path / "study.json"
    common = ["--epochs", "2", "--molecules", "300", "--device", "cpu",
              "--reference", str(ref), "--output", str(out)]
    assert ec.main(common + ["--seeds", "67"]) == 0
    first = json.loads(out.read_text())
    assert first["config"]["seeds"] == [67] and first["config"]["device"] == "cpu"
    assert first["config"]["chunks"][0]["use_pallas"] is False
    for mode in MODES:
        (curve,) = first["runs"][mode].values()
        assert [c["epoch"] for c in curve] == [0, 1]
        assert all(math.isfinite(c[k]) for c in curve for k in CURVE_KEYS)
        assert first["reference_comparison"]["modes"][mode]["parity"] is None

    assert ec.main(common + ["--seeds", "68", "--merge_from", str(out)]) == 0
    text = capsys.readouterr().out
    assert "merging 1 prior seeds [67]; training [68]" in text
    assert "[fixed_decoder s67]" not in text.split("merging")[-1]
    merged = json.loads(out.read_text())
    assert merged["config"]["seeds"] == [67, 68]
    assert [c["seeds"] for c in merged["config"]["chunks"]] == [[67], [68]]
    for mode in MODES:
        assert merged["runs"][mode]["67"] == first["runs"][mode]["67"]
        assert isinstance(merged["reference_comparison"]["modes"][mode]["parity"], bool)

    again = tmp_path / "again.json"
    assert ec.main(["--reanalyze", str(out), "--reference", str(ref),
                    "--output", str(again)]) == 0
    re = json.loads(again.read_text())
    assert re["analysis"] == merged["analysis"]
    assert re["reference_comparison"] == merged["reference_comparison"]
    assert re["config"] == merged["config"]


def test_cut_short_study_keeps_finished_runs_and_merges(tmp_path, monkeypatch, capsys):
    """Each finished run is written at once (``partial``); a run that dies
    loses only itself, and ``--merge_from`` of the partial file trains only
    the (mode, seed) runs it lacks. ``run`` is replaced by a stub that
    returns a made-up curve (or dies)."""
    cfg = {**REF_CONFIG, "molecules": 300}
    ref = tmp_path / "ref.json"
    ref.write_text(json.dumps({**_reference(), "config": {**cfg, "seeds": list(range(67, 75))}}))
    out = tmp_path / "study.json"
    common = ["--epochs", str(cfg["epochs"]), "--molecules", "300", "--batch_size", "32",
              "--device", "cpu", "--reference", str(ref), "--output", str(out)]
    calls = []

    def stub(mode, seed, mcfg, tcfg, train, val, epochs, device="cuda", stop=None):
        calls.append((mode, seed))
        if die_at is not None and len(calls) == die_at:
            raise KeyboardInterrupt("cut short")
        return _curves([seed])[mode][seed]

    monkeypatch.setattr(ec, "run", stub)
    die_at = 4  # fixed 67, fixed 68, zero-state 67 finish; zero-state 68 dies
    with pytest.raises(KeyboardInterrupt):
        ec.main(common + ["--seeds", "67,68"])
    part = json.loads(out.read_text())
    assert part["config"]["partial"] is True and "analysis" not in part
    assert {m: sorted(by) for m, by in part["runs"].items()} == {
        "fixed_decoder": ["67", "68"], "reference_zero_state": ["67"]}
    assert part["config"]["chunks"][0]["seeds"] == [67, 68]
    with pytest.raises(SystemExit, match="cut-short"):
        ec.main(["--reanalyze", str(out), "--reference", str(ref)])

    calls.clear()
    die_at = None
    assert ec.main(common + ["--seeds", "68", "--merge_from", str(out)]) == 0
    assert calls == [("reference_zero_state", 68)]
    assert "completing the partial runs" in capsys.readouterr().out
    done = json.loads(out.read_text())
    assert "partial" not in done["config"] and done["config"]["seeds"] == [67, 68]
    assert [c["seeds"] for c in done["config"]["chunks"]] == [[67, 68], [68]]
    assert done["runs"]["fixed_decoder"] == part["runs"]["fixed_decoder"]
    assert done["analysis"]["seeds"] == [67, 68]
