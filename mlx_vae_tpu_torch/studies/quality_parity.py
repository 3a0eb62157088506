"""Quality parity of a port-trained model: the ``examples/`` run trained
with the port, its generation, latent descent, reconstruction and bulk
validity held against the JAX package's records.

For each seed (training seed, and the studies' ``--seed``):

(a) the 45,000-molecule synthetic corpus (``data/prepare.py:
    make_synthetic_dataset``, seed 0, made once a call) trains two
    checkpoints through ``cli/train.py:main`` with the flags of
    ``examples/README.md``'s run (30 epochs, B=1024, lr 5e-4, beta warm-up 20
    epochs, ``--steps_per_dispatch 8``, bf16, ``--use_pallas``): one plain,
    one with ``--use_property_predictor``. The trainer's dispatches
    (``ARCVAETrainer.dispatch_steps``) are read by their number of steps,
    so ``K`` is what it took;
(b) the plain run's ``training_history.json`` beside
    ``examples/training_history.json`` (the final value of each of its 15
    series);
(c) :mod:`.conditioning_fidelity` on the plain checkpoint (targets 50 / 90
    / 130, 2048 rows, T=0.8) against ``benchmarks/conditioning_fidelity.json``;
(d) :mod:`.latent_opt_fidelity` on the predictor checkpoint against
    ``benchmarks/latent_opt_fidelity.json``;
(e) ``cli.encode --split test --batch_size 1024 --compute_dtype bfloat16``
    against ``benchmarks/reconstruction_eval.json``;
(f) ``cli.generate``: 1,000,000 molecules at T=0.8, ``--target 90``,
    B=16384, against ``benchmarks/bulk_generation.json``'s validity, and
    8192 greedy rows.

Every checkpoint is the run's ``checkpoint_best.npz``, as in the records.
The records came from a TPU; only their quality figures are compared.

The gates (:data:`GATES`) are seed means over at least :data:`MIN_SEEDS`
seeds; they were fixed before the first run on the card. Conditioning: each
target's MAE at most :data:`MAE_FACTOR` x the record's, and in every seed
the achieved mean rising with the target. Latent descent: the surrogate's
prediction after the descent within :data:`SURROGATE_TOL` of the target in
every seed and target, and both arms' MAE at most :data:`MAE_FACTOR` x the
record's. History: the final ``val_loss`` inside the span of the JAX run's
two recorded endings (4.42 at K=8, 3.94 at K=1, ``examples/README.md``)
widened on each side by their gap. Bulk: validity at least the record's less
:data:`VALIDITY_SLACK`. Reconstruction is compared, not gated; its collapse
verdict (fewer than :data:`COLLAPSED_FRACTION` of the latent units active)
is compared with the record's.

Usage (one seed a call; each finished seed is written at once)::

    python -m mlx_vae_tpu_torch.studies.quality_parity --seeds 67 \\
        --merge_from mlx_vae_tpu_torch/studies/quality_parity_torch.json

``--reanalyze JSON`` recomputes the comparison from a results file. The
output never lands under ``benchmarks/``.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import tempfile
import time

import torch

from mlx_vae_tpu_torch.studies.elbo_compare import (REPO, STUDY_DIR, _write_json,
                                                    refuse_benchmarks_path, smi_line)

RECORDS = {
    "history": "examples/training_history.json",
    "conditioning": "benchmarks/conditioning_fidelity.json",
    "latent_opt": "benchmarks/latent_opt_fidelity.json",
    "reconstruction": "benchmarks/reconstruction_eval.json",
    "bulk": "benchmarks/bulk_generation.json",
}
# the gates, fixed before the first run on the card
MIN_SEEDS = 3
MAE_FACTOR = 1.25
SURROGATE_TOL = 0.5
VALIDITY_SLACK = 0.05
K1_FINAL_VAL = 3.94  # examples/README.md: the same run at K=1 ends at 3.93 / 3.94
COLLAPSED_FRACTION = 0.05
GATES = {"conditioning_mae": f"seed-mean MAE <= {MAE_FACTOR} x the record's, each target",
         "conditioning_monotone": "achieved mean rises with the target, every seed",
         "latent_opt_surrogate": f"|surrogate_pred_after - target| <= {SURROGATE_TOL}, every "
                                 "seed and target",
         "latent_opt_mae": f"seed-mean MAE of each arm <= {MAE_FACTOR} x the record's, each "
                           "target",
         "history_val_loss": "seed-mean final val_loss inside [min - gap, max + gap] of the "
                             f"record's final val_loss and {K1_FINAL_VAL} (K=1)",
         "bulk_validity": f"seed-mean validity >= the record's - {VALIDITY_SLACK}"}
RECON_KEYS = ("kl_total", "active_units", "active_fraction", "mutual_information",
              "next_token_accuracy", "token_accuracy", "exact_match")
# the run's config keys that a --merge_from file must share
CONFIG_KEYS = ("epochs", "molecules", "batch_size", "steps_per_dispatch", "rows", "targets",
               "temperature", "opt_steps", "bulk_molecules", "bulk_batch_size", "greedy_rows",
               "model")
# the examples/ run's shape and schedule; other configs run, but their
# comparison is marked as not the record's
RECORD_CONFIG = {"epochs": 30, "molecules": 45000, "batch_size": 1024, "steps_per_dispatch": 8,
                 "rows": 2048, "targets": [50.0, 90.0, 130.0], "temperature": 0.8,
                 "opt_steps": 300, "bulk_molecules": 1000000, "bulk_batch_size": 16384,
                 "greedy_rows": 8192,
                 "model": {"embedding_dim": 128, "hidden_dim": 256, "latent_dim": 128,
                           "num_layers": 2}}
MAX_LENGTH = 64
FINAL_NOTE = ("not the gated measurement: the same gates on each run's final-epoch "
              "checkpoint, added after the first run on the card, where checkpoint_best.npz "
              "was epoch 0 (the lowest val_loss under the annealed beta) while the record's "
              "is epoch 25 of 30")


def train_argv(cfg: dict, data: str, ck: str, seed: int, device: str, predictor: bool) -> list:
    """``cli.train`` flags of the ``examples/README.md`` run (the corpus made
    beforehand), at this config's schedule and widths."""
    argv = ["--data", data, "--epochs", str(cfg["epochs"]), "--batch_size",
            str(cfg["batch_size"]), "--learning_rate", "5e-4", "--beta_warmup_epochs", "20",
            "--checkpoint_dir", ck, "--checkpoint_freq", str(cfg["epochs"]),
            "--steps_per_dispatch", str(cfg["steps_per_dispatch"]), "--compute_dtype",
            "bfloat16", "--use_pallas", "--verbose", "--seed", str(seed), "--device", device]
    for k, v in cfg["model"].items():
        argv += [f"--{k}", str(v)]
    return argv + (["--use_property_predictor"] if predictor else [])


@contextlib.contextmanager
def logged(path: str):
    """The block's stdout and stderr go to ``path``."""
    with open(path, "a") as f, contextlib.redirect_stdout(f), contextlib.redirect_stderr(f):
        yield


def train(cfg: dict, data: str, ck: str, seed: int, device: str, predictor: bool,
          log: str) -> dict:
    """Train one checkpoint; returns its wall seconds, its trainer's dispatch
    counts by number of steps and its history."""
    from mlx_vae_tpu_torch.cli import train as cli_train

    t0 = time.perf_counter()
    with logged(log):
        trainer = cli_train.main(train_argv(cfg, data, ck, seed, device, predictor))
    wall = time.perf_counter() - t0
    counts = trainer.dispatch_steps
    with open(os.path.join(ck, "training_history.json")) as f:
        history = json.load(f)
    return {"wall_s": wall, "dispatches": {str(k): v for k, v in sorted(counts.items())},
            "steps_per_dispatch_taken": max(counts), "history": history}


def study_argv(cfg: dict, data: str, seed: int, device: str) -> list:
    """The flags both studies share."""
    return ["--data", data, "--targets", *map(str, cfg["targets"]), "--batch_size",
            str(cfg["rows"]), "--max_length", str(MAX_LENGTH), "--temperature",
            str(cfg["temperature"]), "--seed", str(seed), "--device", device]


def evaluate(cfg: dict, seed: int, data: str, work: str, device: str, cks: dict,
             log: str, tag: str) -> dict:
    """Steps (c)-(f) on the checkpoints ``cks`` (``plain``, ``predictor``):
    both studies, the encode report and the two generate runs."""
    from mlx_vae_tpu_torch.cli import encode as cli_encode
    from mlx_vae_tpu_torch.cli import generate as cli_generate
    from mlx_vae_tpu_torch.studies import conditioning_fidelity, latent_opt_fidelity

    out = {}
    study = study_argv(cfg, data, seed, device)
    with logged(log):
        out["conditioning"] = conditioning_fidelity.main(
            ["--checkpoint", cks["plain"], "--output", os.path.join(work, "cond.json"), *study])
        out["latent_opt"] = latent_opt_fidelity.main(
            ["--checkpoint", cks["predictor"], "--output", os.path.join(work, "lopt.json"),
             "--opt_steps", str(cfg["opt_steps"]), *study])
    for name in ("conditioning", "latent_opt"):
        out[name]["config"].pop("checkpoint")
        print(f"[seed {seed} {tag}] {name}: {json.dumps(out[name]['results'])}", flush=True)

    t0 = time.perf_counter()
    with logged(log):
        enc = cli_encode.main(["--checkpoint", cks["plain"], "--data", data, "--split", "test",
                               "--batch_size", "1024", "--compute_dtype", "bfloat16",
                               "--device", device, "--output", os.path.join(work, "lat.npz"),
                               "--report", os.path.join(work, "rep.json")])
    out["reconstruction"] = {**{k: v for k, v in enc["report"].items() if k != "kl_per_dim"},
                             "seconds": enc["seconds"], "notes": enc["notes"],
                             "wall_s": time.perf_counter() - t0}
    print(f"[seed {seed} {tag}] reconstruction: "
          f"{ {k: out['reconstruction'][k] for k in RECON_KEYS} }", flush=True)

    gen = ["--checkpoint", cks["plain"], "--data", data, "--max_length", str(MAX_LENGTH),
           "--device", device, "--target", "90"]
    runs = {"bulk": ["--num_molecules", str(cfg["bulk_molecules"]), "--batch_size",
                     str(cfg["bulk_batch_size"]), "--temperature", str(cfg["temperature"])],
            "greedy": ["--num_molecules", str(cfg["greedy_rows"]), "--batch_size",
                       str(cfg["greedy_rows"]), "--greedy"]}
    for name, extra in runs.items():
        t0 = time.perf_counter()
        with logged(log):
            meta = cli_generate.main(gen + extra + ["--output",
                                                    os.path.join(work, f"{name}.npz")])
        out[name] = {"num_molecules": int(extra[1]), **meta,
                     "wall_s": time.perf_counter() - t0}
        print(f"[seed {seed} {tag}] {name}: validity {meta['validity']:.4f}, "
              f"{meta['mols_per_sec']:,.0f} mols/s (generation), metrics on the host "
              f"{meta['metrics_s']:.2f}s", flush=True)
    return out


def sampler_reruns(cfg: dict, seed: int, data: str, work: str, device: str, ck: str,
                   log: str) -> dict:
    """Conditioning fidelity on ``ck`` again with the f32 sampler and with the
    scan sampler (``use_pallas`` off): what a sampler would change, training
    would not."""
    from mlx_vae_tpu_torch.studies import conditioning_fidelity

    out = {}
    for name, extra in (("float32", ["--compute_dtype", "float32"]),
                        ("scan", ["--sampler", "scan"])):
        with logged(log):
            out[name] = conditioning_fidelity.main(
                ["--checkpoint", ck, "--output", os.path.join(work, f"cond_{name}.json"),
                 *study_argv(cfg, data, seed, device), *extra])
        out[name]["config"].pop("checkpoint")
        print(f"[seed {seed}] conditioning rerun {name}: "
              f"{[round(r['mae'], 3) for r in out[name]['results']]}", flush=True)
    return out


def run_seed(cfg: dict, seed: int, data: str, work: str, device: str) -> dict:
    """Steps (a)-(f) for one seed in ``work``; returns the seed's record:
    the two trainings, (c)-(f) on their ``checkpoint_best.npz`` (the
    records' checkpoints; the gates), the same on their final-epoch
    checkpoints (``final_checkpoint``), and the best plain checkpoint's
    conditioning rerun with the f32 and the scan sampler
    (``conditioning_reruns``)."""
    from mlx_vae_tpu_torch.train.checkpoint import load_checkpoint

    t_seed = time.perf_counter()
    log = os.path.join(work, f"seed{seed}.log")
    out = {"train": {}}
    best, final = {}, {}
    for tag, predictor in (("plain", False), ("predictor", True)):
        ck = os.path.join(work, f"ck_{seed}_{tag}")
        t = out["train"][tag] = train(cfg, data, ck, seed, device, predictor, log)
        best[tag] = os.path.join(ck, "checkpoint_best.npz")
        final[tag] = os.path.join(ck, f"checkpoint_epoch_{cfg['epochs'] - 1:03d}.npz")
        t["best_epoch"] = load_checkpoint(best[tag])["epoch"]
        print(f"[seed {seed}] trained {tag}: {t['wall_s']:.1f}s, dispatches "
              f"{t['dispatches']}, final val_loss {t['history']['val_loss'][-1]:.4f}, best "
              f"epoch {t['best_epoch']}", flush=True)
    out.update(evaluate(cfg, seed, data, work, device, best, log, "best"))
    out["final_checkpoint"] = evaluate(cfg, seed, data, work, device, final, log, "final")
    out["conditioning_reruns"] = sampler_reruns(cfg, seed, data, work, device, best["plain"],
                                                log)
    out["wall_s"] = time.perf_counter() - t_seed
    return out


def _mean(xs):
    return sum(xs) / len(xs)


def _load(name: str):
    with open(REPO / RECORDS[name]) as f:
        return json.load(f)


def collapsed(report: dict, latent_dim: int) -> bool:
    return report["active_units"] < COLLAPSED_FRACTION * latent_dim


def compare(seeds: dict, cfg: dict, checkpoint: str = "best") -> dict:
    """Hold the per-seed results (``{seed: record}``) on ``checkpoint``
    (``best``: ``checkpoint_best.npz``, as the records; ``final``: the last
    epoch's) against the JAX records: every gate with its value, limit and
    pass, and the reconstruction side by side."""
    ss = sorted(seeds, key=int)
    runs = [seeds[s] if checkpoint == "best" else {**seeds[s], **seeds[s]["final_checkpoint"]}
            for s in ss]
    gates = {}

    cond_rec = {r["target"]: r for r in _load("conditioning")}
    mae = {}
    for t in cfg["targets"]:
        v = _mean([next(r for r in run["conditioning"]["results"] if r["target"] == t)["mae"]
                   for run in runs])
        rec = cond_rec[t]["mae"]
        mae[str(t)] = {"value": v, "record": rec, "limit": MAE_FACTOR * rec,
                       "pass": v <= MAE_FACTOR * rec}
    gates["conditioning_mae"] = {"per_target": mae,
                                 "pass": all(m["pass"] for m in mae.values())}
    mono = {}
    for s, run in zip(ss, runs):
        means = [r["achieved_mean"] for r in sorted(run["conditioning"]["results"],
                                                    key=lambda r: r["target"])]
        mono[s] = {"achieved_means": means,
                   "pass": all(a < b for a, b in zip(means, means[1:]))}
    gates["conditioning_monotone"] = {"per_seed": mono,
                                      "pass": all(m["pass"] for m in mono.values())}

    lo_rec = {r["target"]: r for r in _load("latent_opt")}
    errs = {s: {str(r["target"]): abs(r["optimized"]["surrogate_pred_after"] - r["target"])
                for r in run["latent_opt"]["results"]} for s, run in zip(ss, runs)}
    worst = max(e for by_t in errs.values() for e in by_t.values())
    gates["latent_opt_surrogate"] = {"per_seed": errs, "worst": worst, "limit": SURROGATE_TOL,
                                     "pass": worst <= SURROGATE_TOL}
    arms = {}
    for arm in ("conditional", "optimized"):
        arms[arm] = {}
        for t in cfg["targets"]:
            v = _mean([next(r for r in run["latent_opt"]["results"]
                            if r["target"] == t)[arm]["mae"] for run in runs])
            rec = lo_rec[t][arm]["mae"]
            arms[arm][str(t)] = {"value": v, "record": rec, "limit": MAE_FACTOR * rec,
                                 "pass": v <= MAE_FACTOR * rec}
    gates["latent_opt_mae"] = {"per_arm": arms, "pass": all(
        m["pass"] for by_t in arms.values() for m in by_t.values())}

    hist_rec = _load("history")
    endings = (hist_rec["val_loss"][-1], K1_FINAL_VAL)
    gap = abs(endings[0] - endings[1])
    span = [min(endings) - gap, max(endings) + gap]
    v = _mean([run["train"]["plain"]["history"]["val_loss"][-1] for run in runs])
    gates["history_val_loss"] = {"value": v, "record_endings": list(endings), "span": span,
                                 "pass": span[0] <= v <= span[1]}

    bulk_rec = _load("bulk")["stochastic_T0.8"]["validity"]
    v = _mean([run["bulk"]["validity"] for run in runs])
    gates["bulk_validity"] = {"value": v, "record": bulk_rec,
                              "limit": bulk_rec - VALIDITY_SLACK,
                              "pass": v >= bulk_rec - VALIDITY_SLACK}

    history = {k: {"port_seed_mean": _mean([run["train"]["plain"]["history"][k][-1]
                                            for run in runs]),
                   "record": rec[-1]}
               for k, rec in hist_rec.items() if isinstance(rec, list) and rec}
    recon_rec = _load("reconstruction")["results"]
    latent = cfg["model"]["latent_dim"]
    recon = {k: {"port_seed_mean": _mean([run["reconstruction"][k] for run in runs]),
                 "port_per_seed": {s: run["reconstruction"][k] for s, run in zip(ss, runs)},
                 "record": recon_rec[k]} for k in RECON_KEYS}
    verdicts = {s: collapsed(run["reconstruction"], latent) for s, run in zip(ss, runs)}
    recon_verdict = collapsed(recon_rec, RECORD_CONFIG["model"]["latent_dim"])
    hist_best = min(range(len(hist_rec["val_loss"])), key=hist_rec["val_loss"].__getitem__)
    return {
        "records": RECORDS,
        "checkpoint": checkpoint,
        "best_epoch": {"record": hist_best,
                       "port_per_seed": {s: {tag: t.get("best_epoch") for tag, t in
                                             run["train"].items()} for s, run in zip(ss, runs)}},
        "seeds": [int(s) for s in ss],
        "enough_seeds": len(ss) >= MIN_SEEDS,
        "config_is_record": {k: cfg[k] for k in RECORD_CONFIG} == RECORD_CONFIG,
        "criteria": GATES,
        "gates": gates,
        "all_gates_pass": len(ss) >= MIN_SEEDS and all(g["pass"] for g in gates.values()),
        "history_final": history,
        "reconstruction": {"values": recon, "collapsed_port_per_seed": verdicts,
                           "collapsed_record": recon_verdict,
                           "collapse_verdict_same": all(v == recon_verdict
                                                        for v in verdicts.values())},
        "greedy_validity": {"port_seed_mean": _mean([run["greedy"]["validity"]
                                                     for run in runs]),
                            "record": _load("bulk")["greedy"]["validity"]},
    }


def rerun_summary(seeds: dict, cfg: dict) -> dict:
    """Seed-mean conditioning MAE by target on the best plain checkpoint,
    for each sampler: the bf16 fused route, the f32 one, the scan."""
    runs = [seeds[s] for s in sorted(seeds, key=int)]
    docs = {"bfloat16_fused": [r["conditioning"] for r in runs],
            **{k: [r["conditioning_reruns"][k] for r in runs]
               for k in ("float32", "scan")}}
    return {name: {"route": ds[0]["route"],
                   "mae": {str(t): _mean([next(r for r in d["results"]
                                               if r["target"] == t)["mae"] for d in ds])
                           for t in cfg["targets"]}}
            for name, ds in docs.items()}


def make_corpus(molecules: int, path: str) -> str:
    """The synthetic corpus (V=80, L=64, seed 0) at ``path``; returns its
    SHA-256."""
    from mlx_vae_tpu_torch.data.prepare import make_synthetic_dataset

    make_synthetic_dataset(n=molecules, vocab_size=80, max_length=MAX_LENGTH, path=path)
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _print_comparison(comp: dict) -> None:
    print(f"\n{comp['checkpoint']} checkpoints against the JAX records "
          f"({len(comp['seeds'])} seeds; record config {comp['config_is_record']}; best "
          f"epochs {comp['best_epoch']}):")
    for name, g in comp["gates"].items():
        detail = {k: v for k, v in g.items() if k not in ("per_seed", "pass")}
        print(f"  {name}: {'PASS' if g['pass'] else 'FAIL'} {json.dumps(detail)}")
    print(f"  collapse verdict same as the record's: "
          f"{comp['reconstruction']['collapse_verdict_same']}")
    print(f"  all gates pass: {comp['all_gates_pass']}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="67,68,69",
                    help="comma-separated seeds (training and studies)")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--molecules", type=int, default=45000)
    ap.add_argument("--batch_size", type=int, default=1024)
    ap.add_argument("--rows", type=int, default=2048,
                    help="rows a target in the two studies")
    ap.add_argument("--opt_steps", type=int, default=300)
    ap.add_argument("--bulk_molecules", type=int, default=1000000)
    ap.add_argument("--bulk_batch_size", type=int, default=16384)
    ap.add_argument("--greedy_rows", type=int, default=8192)
    for k, v in RECORD_CONFIG["model"].items():
        ap.add_argument(f"--{k}", type=int, default=v)
    ap.add_argument("--device", default="cuda",
                    help="cuda[:N] (the kernels) or cpu (their plain versions)")
    ap.add_argument("--merge_from", default=None, metavar="JSON",
                    help="merge the seeds of an earlier results file (its config must "
                         "match); only the seeds it lacks run")
    ap.add_argument("--reanalyze", default=None, metavar="JSON",
                    help="recompute the comparison from a results file (no runs)")
    ap.add_argument("--output", default=None,
                    help="results JSON (default: mlx_vae_tpu_torch/studies/"
                         "quality_parity_torch.json, or the --reanalyze file); never "
                         "under benchmarks/")
    return ap


def main(argv=None) -> dict:
    """Run the study; returns the written document."""
    from mlx_vae_tpu_torch.cli.common import resolve_device

    args = build_parser().parse_args(argv)
    cfg = {k: getattr(args, k, RECORD_CONFIG[k]) for k in CONFIG_KEYS if k != "model"}
    cfg["model"] = {k: getattr(args, k) for k in RECORD_CONFIG["model"]}
    seeds, chunks = {}, []
    if args.reanalyze:
        with open(args.reanalyze) as f:
            prev = json.load(f)
        cfg, seeds, chunks = prev["config"], prev["seeds"], prev["config"]["chunks"]
        args.output = args.output or args.reanalyze
    args.output = args.output or str(STUDY_DIR / "quality_parity_torch.json")
    refuse_benchmarks_path(args.output)

    if not args.reanalyze:
        if args.merge_from:
            with open(args.merge_from) as f:
                prev = json.load(f)
            for k in CONFIG_KEYS:
                if prev["config"][k] != cfg[k]:
                    raise SystemExit(f"--merge_from config mismatch: {k}="
                                     f"{prev['config'][k]} vs {cfg[k]}")
            seeds, chunks = dict(prev["seeds"]), prev["config"]["chunks"]
        todo = [s for s in (int(x) for x in args.seeds.split(",")) if str(s) not in seeds]
        print(f"seeds done {sorted(seeds, key=int)}; running {todo}", flush=True)
        device = resolve_device(args.device)
        chunk = {"seeds": [], "device": str(device), "torch": torch.__version__,
                 "cuda": torch.version.cuda,
                 "gpu": torch.cuda.get_device_name(device) if device.type == "cuda" else None,
                 "nvidia_smi": smi_line() if device.type == "cuda" else None}
        with tempfile.TemporaryDirectory() as work:
            data = os.path.join(work, "corpus.json")
            t0 = time.perf_counter()
            cfg["corpus_sha256"] = make_corpus(args.molecules, data)
            chunk["corpus_s"] = time.perf_counter() - t0
            if args.merge_from and prev["config"]["corpus_sha256"] != cfg["corpus_sha256"]:
                raise SystemExit("--merge_from: the corpus differs from this call's")
            for s in todo:
                seeds[str(s)] = run_seed(cfg, s, data, work, args.device)
                chunk["seeds"].append(s)
                # each finished seed is on disk at once
                _write_json(args.output, {"seeds": seeds, "config": {
                    **cfg, "chunks": chunks + [chunk], "partial": True}})
        chunks = chunks + [chunk]
    cfg = {**cfg, "chunks": chunks}
    cfg.pop("partial", None)
    lines = {c["nvidia_smi"] for c in chunks}
    cfg["nvidia_smi"] = lines.pop() if len(lines) == 1 else None
    if not seeds:
        raise SystemExit("no seed has run")
    comp = compare(seeds, cfg)
    final = compare(seeds, cfg, "final")
    doc = {"seeds": seeds, "reference_comparison": comp,
           "reference_comparison_final_checkpoint": {"note": FINAL_NOTE, **final},
           "conditioning_reruns": rerun_summary(seeds, cfg), "config": cfg}
    _write_json(args.output, doc)
    _print_comparison(comp)
    _print_comparison(final)
    print(f"wrote {args.output}")
    return doc


if __name__ == "__main__":
    main()
