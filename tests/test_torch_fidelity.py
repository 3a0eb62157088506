"""The port's quality studies (``mlx_vae_tpu_torch/studies/
conditioning_fidelity.py``, ``latent_opt_fidelity.py``, ``quality_parity.py``)
against the JAX scripts (``benchmarks/conditioning_fidelity.py``,
``benchmarks/latent_opt_fidelity.py``, loaded by path and run on the CPU with
their outputs under ``tmp_path``).

* The corpus: the port's 45,000-molecule synthetic corpus JSON is byte-equal
  to the JAX package's (seed 0; the JAX one is built in a subprocess beside
  the port's). A JAX-written ``.npz`` of seeded JAX params loads in the port.
* End to end, tiny model (V=80, E=16, H=32, latent 8, 2 layers, the JAX init
  with the decoder scaled by 3 so rows differ), 512 rows, L=32, T=0.8: the
  two conditioning scripts' rows have the same keys, and at each target the
  achieved means agree within 4 standard errors (the packages draw z and the
  sampling noise from different generators); the same for both arms of the
  latent-opt pair, whose surrogate prediction after 300 Adam steps agrees
  within 0.5 TPSA (the card gate's own tolerance). The conditioning pair
  again on a checkpoint the port trained for 3 epochs on the CPU, where
  each package's achieved mean rises with the target (40 / 60 / 80) by more
  than 4 standard errors a step.
* Scoring: the ``--chem`` and multi-property modes score the same rows (a
  corpus from the port's ``chem/corpus.py``, each package's sampler replaced
  by one that returns them) exactly as the JAX scripts do.
* The gates on inline fixtures, the ``benchmarks/`` refusal, ``--device
  cuda`` without a card, and ``quality_parity`` end to end on the CPU (1
  seed, 1 epoch, 512 molecules: both checkpoints, both studies on the best
  and the final checkpoints, the f32 and scan reruns), then ``--merge_from``
  (a second seed's record stubbed) and ``--reanalyze``.
"""

import copy
import hashlib
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mlx_vae_tpu.config import ModelConfig as JaxConfig
from mlx_vae_tpu.models.vae import ARCVAE as JaxARCVAE
from mlx_vae_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from mlx_vae_tpu.train.optim import adam_init as jax_adam_init
from mlx_vae_tpu_torch.chem.corpus import generate_smiles
from mlx_vae_tpu_torch.data.prepare import make_synthetic_dataset, prepare_from_smiles
from mlx_vae_tpu_torch.data.split import load_and_split
from mlx_vae_tpu_torch.studies import conditioning_fidelity as cf
from mlx_vae_tpu_torch.studies import latent_opt_fidelity as lof
from mlx_vae_tpu_torch.studies import quality_parity as qp
from mlx_vae_tpu_torch.train.checkpoint import load_checkpoint

ROOT = Path(__file__).resolve().parent.parent
SHAPE = dict(vocab_size=80, embedding_dim=16, hidden_dim=32, latent_dim=8, num_layers=2)
ROWS, L = 512, 32
N_SE = 4.0
SURROGATE_TOL = 0.5
CHEM_ROWS = 48


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test runner's parallel workers would
    otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_scripts():
    return {n: _script(n) for n in ("conditioning_fidelity", "latent_opt_fidelity")}


def _run_jax(mod, argv, monkeypatch, out):
    monkeypatch.setattr(sys, "argv", [mod.__file__] + argv + ["--output", str(out)])
    mod.main()
    return json.loads(Path(out).read_text())


def _jax_params(num_conditions):
    """The JAX init of the tiny model with a predictor head (one compiled
    program), the decoder scaled by 3."""
    cfg = JaxConfig(num_conditions=num_conditions, **SHAPE)
    params = dict(jax.jit(lambda k: JaxARCVAE(cfg, k, with_predictor=True).params)(
        jax.random.PRNGKey(7)))
    params["decoder"] = jax.tree_util.tree_map(lambda a: 3.0 * a, params["decoder"])
    return params


def _jax_checkpoint(path, params):
    jax_save_checkpoint(path, 0, params, {k: jax_adam_init(v) for k, v in params.items()}, {})
    return str(path)


# the two packages' 45,000-molecule corpora, built in two subprocesses at once
CORPUS = {"jax": ("import sys, jax; jax.config.update('jax_platforms', 'cpu'); "
                  "from mlx_vae_tpu.data.prepare import make_synthetic_dataset; "
                  "make_synthetic_dataset(n=45000, vocab_size=80, max_length=64, "
                  "path=sys.argv[1])"),
          "port": ("import sys; from mlx_vae_tpu_torch.studies.quality_parity import "
                   "make_corpus; print(make_corpus(45000, sys.argv[1]))")}


@pytest.fixture
def corpora(tmp_path):
    d = tmp_path
    procs = {k: (d / f"{k}.json", subprocess.Popen(
        [sys.executable, "-c", code, str(d / f"{k}.json")], cwd=ROOT, stdout=subprocess.PIPE,
        text=True, env={**os.environ, "JAX_PLATFORMS": "cpu"})) for k, code in CORPUS.items()}
    yield procs
    for _, p in procs.values():
        p.kill()
        p.communicate()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 400-molecule synthetic corpus, JAX-written checkpoints of the tiny
    model with and without a predictor, and a 60-molecule chemistry corpus
    with its checkpoints (1 and 3 conditions)."""
    d = tmp_path_factory.mktemp("fidelity")
    data = d / "syn.json"
    make_synthetic_dataset(n=400, vocab_size=80, max_length=L, path=str(data))
    chem = d / "chem.json"
    prepare_from_smiles(generate_smiles(60, seed=0), max_length=64, path=str(chem))
    params = _jax_params(1)
    plain = {k: v for k, v in params.items() if k != "predictor"}
    return {"data": str(data), "chem": str(chem), "params": params,
            "ck": _jax_checkpoint(d / "ck.npz", plain),
            "ck_pred": _jax_checkpoint(d / "ck_pred.npz", params),
            "ck3": _jax_checkpoint(d / "ck3.npz", _jax_params(3))}


# ------------------------------------------------------------------ checkpoint


def test_jax_checkpoint_loads_in_the_studies(files):
    _, params, mcfg = cf.load_model(files["ck"], torch.device("cpu"), "bfloat16", "fused", 1,
                                    dict(SHAPE))
    assert {k: getattr(mcfg, k) for k in SHAPE} == SHAPE and mcfg.use_pallas
    flat = load_checkpoint(files["ck"])["params"]["decoder"]
    want = np.asarray(files["params"]["decoder"]["fc_out"]["weight"])
    np.testing.assert_array_equal(flat["fc_out"]["weight"], want)
    np.testing.assert_array_equal(params["decoder"]["fc_out"]["weight"].numpy(), want)
    with pytest.raises(SystemExit, match="contradicts the checkpoint"):
        cf.load_model(files["ck"], torch.device("cpu"), "bfloat16", "fused", 1,
                      {"hidden_dim": 64})


# ------------------------------------------------------------- end to end


def _keys(x):
    if isinstance(x, dict):
        return {k: _keys(v) for k, v in x.items()}
    return type(x).__name__ if isinstance(x, str) else "number"


def _within(port, jax_, n, what):
    se = math.sqrt(port["achieved_std"] ** 2 / n + jax_["achieved_std"] ** 2 / n)
    diff = abs(port["achieved_mean"] - jax_["achieved_mean"])
    assert diff <= N_SE * se, f"{what}: |{port['achieved_mean']} - {jax_['achieved_mean']}| " \
                              f"> {N_SE} x {se}"


def _size(data):
    return ["--data", data, "--batch_size", str(ROWS), "--max_length", str(L)]


def test_conditioning_against_jax(files, jax_scripts, tmp_path, monkeypatch):
    shape = [f"--{k}={v}" for k, v in SHAPE.items()]
    want = _run_jax(jax_scripts["conditioning_fidelity"],
                    ["--checkpoint", files["ck"], *_size(files["data"]), *shape], monkeypatch,
                    tmp_path / "jax.json")
    got = cf.main(["--checkpoint", files["ck"], *_size(files["data"]), *shape, "--device",
                   "cpu", "--output", str(tmp_path / "port.json")])
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert got["route"] == {"sampler": "fused", "kernel": "plain version (CPU)",
                            "compute_dtype": "bfloat16"}
    assert got["tokens_device"] == ["cpu"]
    assert [_keys(r) for r in got["results"]] == [_keys(r) for r in want]
    for p, j in zip(got["results"], want):
        assert p["target"] == j["target"]
        _within(p, j, ROWS, f"target {p['target']}")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A checkpoint of the tiny model trained by the port's CLI on the CPU
    until its generation follows the condition: 1,500 molecules of at most
    32 tokens, 3 epochs at B=64, lr 3e-3, beta warmed up over 2 epochs; the
    last epoch's checkpoint."""
    from mlx_vae_tpu_torch.cli import train as cli_train
    from mlx_vae_tpu_torch.train.trainer import ARCVAETrainer

    d = tmp_path_factory.mktemp("trained")
    data = d / "syn.json"
    make_synthetic_dataset(n=1500, vocab_size=80, max_length=L, path=str(data))
    plot = ARCVAETrainer.plot_history
    ARCVAETrainer.plot_history = lambda self, save_path: None  # not what is held here
    try:
        cli_train.main(["--data", str(data), "--epochs", "3", "--batch_size", "64",
                        "--learning_rate", "3e-3", "--beta_warmup_epochs", "2",
                        "--checkpoint_dir", str(d / "ck"), "--checkpoint_freq", "3",
                        "--device", "cpu", *[f"--{k}={v}" for k, v in SHAPE.items()]])
    finally:
        ARCVAETrainer.plot_history = plot
    return {"data": str(data), "ck": str(d / "ck" / "checkpoint_epoch_002.npz")}


def _rising(results, n):
    """Each target's achieved mean above the last one's by more than
    ``N_SE`` standard errors of their difference."""
    for lo, hi in zip(results, results[1:]):
        se = math.sqrt(lo["achieved_std"] ** 2 / n + hi["achieved_std"] ** 2 / n)
        assert hi["achieved_mean"] - lo["achieved_mean"] > N_SE * se, (lo, hi)


def test_conditioning_on_a_trained_checkpoint_against_jax(trained, jax_scripts, tmp_path,
                                                          monkeypatch):
    """On a model that has learned the condition, a mis-scaled or flipped
    condition would show: the achieved means rise with the target in both
    packages, and agree target by target."""
    argv = ["--checkpoint", trained["ck"], *_size(trained["data"]), "--targets", "40", "60",
            "80", *[f"--{k}={v}" for k, v in SHAPE.items()]]
    want = _run_jax(jax_scripts["conditioning_fidelity"], argv, monkeypatch,
                    tmp_path / "jax.json")
    got = cf.main(argv + ["--device", "cpu", "--output", str(tmp_path / "port.json")])
    assert [_keys(r) for r in got["results"]] == [_keys(r) for r in want]
    _rising(want, ROWS)
    _rising(got["results"], ROWS)
    for p, j in zip(got["results"], want):
        assert p["target"] == j["target"]
        _within(p, j, ROWS, f"trained, target {p['target']}")


def test_conditioning_reruns_f32_and_scan(files, tmp_path):
    """The two reruns that tell the sampler from training: split-TF32's
    plain f32 twin and the scan sampler (``use_pallas`` off)."""
    base = ["--checkpoint", files["ck"], *_size(files["data"]), "--device", "cpu",
            "--targets", "90"]
    runs = {name: cf.main(base + extra + ["--output", str(tmp_path / f"{name}.json")])
            for name, extra in (("bf16", []), ("f32", ["--compute_dtype", "float32"]),
                                ("scan", ["--sampler", "scan"]))}
    assert runs["f32"]["route"]["compute_dtype"] == "float32"
    assert runs["scan"]["route"] == {"sampler": "scan", "kernel": None,
                                     "compute_dtype": "bfloat16"}
    for name in ("f32", "scan"):
        _within(runs[name]["results"][0], runs["bf16"]["results"][0], ROWS, name)


def test_latent_opt_against_jax(files, jax_scripts, tmp_path, monkeypatch):
    want = _run_jax(jax_scripts["latent_opt_fidelity"],
                    ["--checkpoint", files["ck_pred"], *_size(files["data"])], monkeypatch,
                    tmp_path / "jax.json")
    got = lof.main(["--checkpoint", files["ck_pred"], *_size(files["data"]), "--device", "cpu",
                    "--output", str(tmp_path / "port.json")])
    assert got["latent_device"] == ["cpu"] and got["tokens_device"] == ["cpu"]
    assert [_keys(r) for r in got["results"]] == [_keys(r) for r in want]
    for p, j in zip(got["results"], want):
        for arm in ("conditional", "optimized"):
            _within(p[arm], j[arm], ROWS, f"target {p['target']} {arm}")
        pa, ja = p["optimized"]["surrogate_pred_after"], j["optimized"]["surrogate_pred_after"]
        assert abs(pa - ja) <= SURROGATE_TOL, (p["target"], pa, ja)


def test_latent_opt_refuses_a_checkpoint_without_predictor(files, tmp_path):
    with pytest.raises(SystemExit, match="checkpoint has no predictor head — re-train with "
                                         "--use_property_predictor"):
        lof.main(["--checkpoint", files["ck"], "--data", files["data"], "--device", "cpu",
                  "--output", str(tmp_path / "x.json")])


# ---------------------------------------------------------------- scoring


def _fixed_rows(files):
    rows = load_and_split(files["chem"])[0].molecules[:CHEM_ROWS]
    assert rows.shape[0] == CHEM_ROWS
    return rows


@pytest.mark.parametrize("study,properties", [
    ("conditioning_fidelity", "tpsa"),
    ("conditioning_fidelity", "tpsa,logp,mw"),
    ("latent_opt_fidelity", "tpsa"),
])
def test_chem_scoring_equals_jax(study, properties, files, jax_scripts, tmp_path, monkeypatch):
    """Each package's sampler returns the same corpus rows; the scores of
    every mode must then be the JAX script's exactly (the surrogate's
    prediction within the gate's tolerance)."""
    import mlx_vae_tpu.models.sampling as jax_sampling
    import mlx_vae_tpu_torch.cli.generate as port_generate

    rows = _fixed_rows(files)
    monkeypatch.setattr(jax_sampling, "generate_with_temperature", lambda *a, **k: rows)
    monkeypatch.setattr(port_generate, "make_generate_fn",
                        lambda *a, **k: lambda z, cond, g: torch.from_numpy(rows))
    multi = "," in properties
    ck = files["ck3"] if multi else files["ck_pred" if study.startswith("latent") else "ck"]
    argv = ["--checkpoint", ck, "--data", files["chem"], "--batch_size", str(CHEM_ROWS),
            "--chem", "--targets", "40", "80"]
    if study.startswith("conditioning"):
        argv += ["--properties", properties, f"--num_layers={SHAPE['num_layers']}",
                 f"--latent_dim={SHAPE['latent_dim']}", f"--hidden_dim={SHAPE['hidden_dim']}",
                 f"--embedding_dim={SHAPE['embedding_dim']}", f"--vocab_size={SHAPE['vocab_size']}"]
        port = cf
    else:
        argv += ["--opt_steps", "20"]
        port = lof
    want = _run_jax(jax_scripts[study], argv, monkeypatch, tmp_path / "jax.json")
    got = port.main(argv + ["--device", "cpu", "--output", str(tmp_path / "port.json")])["results"]
    if study.startswith("latent"):  # the descent is held in test_latent_opt_against_jax
        for p, j in zip(got, want):
            p["optimized"].pop("surrogate_pred_after")
            j["optimized"].pop("surrogate_pred_after")
    assert got == want
    assert got[0].get("backend") == "vendored-ertl"
    if multi:
        assert set(got[0]["held_properties"]) == {"logp", "mw"}


# -------------------------------------------------------- gates and the study


def _record_seed(val_loss=None):
    """A seed whose every figure is the JAX record's own."""
    cond = json.loads((ROOT / qp.RECORDS["conditioning"]).read_text())
    lopt = json.loads((ROOT / qp.RECORDS["latent_opt"]).read_text())
    hist = json.loads((ROOT / qp.RECORDS["history"]).read_text())
    recon = json.loads((ROOT / qp.RECORDS["reconstruction"]).read_text())["results"]
    bulk = json.loads((ROOT / qp.RECORDS["bulk"]).read_text())
    if val_loss is not None:
        hist = {**hist, "val_loss": hist["val_loss"][:-1] + [val_loss]}
    return {"train": {"plain": {"history": hist}}, "conditioning": {"results": cond},
            "latent_opt": {"results": lopt}, "reconstruction": dict(recon),
            "bulk": {"validity": bulk["stochastic_T0.8"]["validity"]},
            "greedy": {"validity": bulk["greedy"]["validity"]}}


def _mae_up(s, f):
    for r in s["conditioning"]["results"]:
        r["mae"] *= f


def _flip(s):
    rs = s["conditioning"]["results"]
    rs[0]["achieved_mean"], rs[1]["achieved_mean"] = rs[1]["achieved_mean"], rs[0]["achieved_mean"]


def _surrogate_off(s):
    s["latent_opt"]["results"][1]["optimized"]["surrogate_pred_after"] += 0.6


def _opt_mae_up(s):
    s["latent_opt"]["results"][2]["optimized"]["mae"] *= 1.3


def _val(s, v):
    s["train"]["plain"]["history"]["val_loss"][-1] = v


def _validity(s, v):
    s["bulk"]["validity"] = v


def _units(s, n):
    s["reconstruction"]["active_units"] = n


@pytest.mark.parametrize("edit,gate,passes", [
    (None, None, True),
    (lambda s: _mae_up(s, 1.2), "conditioning_mae", True),
    (lambda s: _mae_up(s, 1.3), "conditioning_mae", False),
    (_flip, "conditioning_monotone", False),
    (_surrogate_off, "latent_opt_surrogate", False),
    (_opt_mae_up, "latent_opt_mae", False),
    (lambda s: _val(s, 3.47), "history_val_loss", True),
    (lambda s: _val(s, 3.45), "history_val_loss", False),
    (lambda s: _val(s, 4.91), "history_val_loss", False),
    (lambda s: _validity(s, 0.864), "bulk_validity", True),
    (lambda s: _validity(s, 0.862), "bulk_validity", False),
])
def test_gates(edit, gate, passes):
    seeds = {str(s): _record_seed() for s in (67, 68, 69)}
    if edit is not None:
        for s in seeds.values():
            edit(s)
    comp = qp.compare(seeds, copy.deepcopy(qp.RECORD_CONFIG))
    assert comp["enough_seeds"] and comp["config_is_record"]
    if gate is not None:
        assert comp["gates"][gate]["pass"] is passes
    assert comp["all_gates_pass"] is passes
    assert comp["reconstruction"]["collapse_verdict_same"]
    assert comp["gates"]["history_val_loss"]["span"] == pytest.approx([3.4559, 4.9082], abs=1e-3)


def test_gates_need_three_seeds_and_compare_collapse():
    seeds = {"67": _record_seed(), "68": _record_seed()}
    _units(seeds["68"], 64)
    comp = qp.compare(seeds, copy.deepcopy(qp.RECORD_CONFIG))
    assert not comp["enough_seeds"] and not comp["all_gates_pass"]
    assert all(g["pass"] for g in comp["gates"].values())
    assert comp["reconstruction"]["collapsed_record"]
    assert comp["reconstruction"]["collapsed_port_per_seed"] == {"67": True, "68": False}
    assert not comp["reconstruction"]["collapse_verdict_same"]


@pytest.mark.parametrize("module,argv", [
    (cf, ["--checkpoint", "x.npz", "--data", "d.json"]),
    (lof, ["--checkpoint", "x.npz", "--data", "d.json"]),
    (qp, []),
])
def test_output_under_benchmarks_refused(module, argv):
    with pytest.raises(SystemExit, match="benchmarks"):
        module.main(argv + ["--device", "cpu", "--output",
                            str(ROOT / "benchmarks" / "port.json")])
    assert not (ROOT / "benchmarks" / "port.json").exists()


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the refusal where no card is")
@pytest.mark.parametrize("module,key", [(cf, "ck"), (lof, "ck_pred"), (qp, None)])
def test_cuda_without_a_card_raises(module, key, files, tmp_path):
    argv = [] if key is None else ["--checkpoint", files[key], "--data", files["data"]]
    with pytest.raises(SystemExit, match="CUDA is not available"):
        module.main(argv + ["--device", "cuda", "--output", str(tmp_path / "o.json")])
    assert not (tmp_path / "o.json").exists()


QP_TINY = ["--device", "cpu", "--epochs", "1", "--molecules", "512", "--batch_size", "64",
           "--rows", "128", "--opt_steps", "20", "--bulk_molecules", "1024",
           "--bulk_batch_size", "512", "--greedy_rows", "128", "--embedding_dim", "16",
           "--hidden_dim", "32", "--latent_dim", "8"]


def test_quality_parity_cli_on_cpu(tmp_path, capsys, monkeypatch):
    from mlx_vae_tpu_torch.train.trainer import ARCVAETrainer

    monkeypatch.setattr(ARCVAETrainer, "plot_history", lambda self, save_path: None)
    out = tmp_path / "qp.json"
    doc = qp.main(QP_TINY + ["--seeds", "67", "--output", str(out)])
    s = doc["seeds"]["67"]
    assert json.loads(out.read_text()) == json.loads(json.dumps(doc))
    for tag in ("plain", "predictor"):
        t = s["train"][tag]
        # 409 training rows: 6 full batches of 64, fewer than K=8, dispatched
        # as one chunk when the partial batch arrives, which runs alone
        assert t["dispatches"] == {"1": 1, "6": 1} and t["steps_per_dispatch_taken"] == 6
        assert len(t["history"]) == 15 and t["history"]["epoch"] == [0]
        assert t["best_epoch"] == 0
    for ev in (s, s["final_checkpoint"]):
        assert ev["conditioning"]["route"]["sampler"] == "fused"
        assert [r["target"] for r in ev["latent_opt"]["results"]] == [50.0, 90.0, 130.0]
        assert ev["bulk"]["num_molecules"] == 1024 and 0.0 <= ev["bulk"]["validity"] <= 1.0
        assert set(qp.RECON_KEYS) <= set(ev["reconstruction"])
    # one epoch: the best and the final checkpoint are the same file's bytes
    assert s["final_checkpoint"]["conditioning"]["results"] == s["conditioning"]["results"]
    assert {k: d["route"]["compute_dtype"] + "/" + d["route"]["sampler"]
            for k, d in s["conditioning_reruns"].items()} == {"float32": "float32/fused",
                                                              "scan": "bfloat16/scan"}
    assert set(doc["conditioning_reruns"]) == {"bfloat16_fused", "float32", "scan"}
    for key, sel in (("reference_comparison", "best"),
                     ("reference_comparison_final_checkpoint", "final")):
        comp = doc[key]
        assert comp["checkpoint"] == sel and comp["seeds"] == [67] and not comp["enough_seeds"]
        assert not comp["config_is_record"] and not comp["all_gates_pass"]
        assert set(comp["gates"]) == set(qp.GATES)
        assert comp["best_epoch"] == {"record": 25,
                                      "port_per_seed": {"67": {"plain": 0, "predictor": 0}}}
    assert doc["config"]["corpus_sha256"] == hashlib.sha256(
        json.dumps(make_synthetic_dataset(n=512, vocab_size=80, max_length=64)).encode()
    ).hexdigest()

    # the merge: seed 68's record stands in as a copy of seed 67's (its run
    # was held above)
    monkeypatch.setattr(qp, "run_seed", lambda cfg, seed, *a: copy.deepcopy(s))
    merged = qp.main(QP_TINY + ["--seeds", "67,68", "--merge_from", str(out),
                                "--output", str(out)])
    assert "running [68]" in capsys.readouterr().out
    assert merged["seeds"]["68"] == merged["seeds"]["67"]
    assert merged["seeds"]["67"] == json.loads(json.dumps(s))
    assert merged["reference_comparison"]["seeds"] == [67, 68]
    assert [c["seeds"] for c in merged["config"]["chunks"]] == [[67], [68]]

    again = qp.main(["--reanalyze", str(out), "--output", str(tmp_path / "re.json")])
    assert again["reference_comparison"] == merged["reference_comparison"]
    with pytest.raises(SystemExit, match="config mismatch"):
        qp.main(QP_TINY[:-2] + ["--latent_dim", "16", "--merge_from", str(out),
                                "--output", str(tmp_path / "x.json")])


def test_synthetic_corpus_is_jax_byte_for_byte(corpora):
    """The study's corpus (``quality_parity.make_corpus``) against the JAX
    package's ``make_synthetic_dataset`` at 45,000 molecules, seed 0."""
    out = {k: p.communicate(timeout=300)[0] for k, (_, p) in corpora.items()}
    assert all(p.returncode == 0 for _, p in corpora.values())
    jax_bytes = corpora["jax"][0].read_bytes()
    assert corpora["port"][0].read_bytes() == jax_bytes
    assert out["port"].split()[-1] == hashlib.sha256(jax_bytes).hexdigest()
