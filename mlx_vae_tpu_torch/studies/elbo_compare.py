"""ELBO curve-parity study: the port's curves against the JAX package's
recorded curves (counterpart of ``benchmarks/elbo_compare.py``).

As the JAX study, it trains the default model in bf16 in two decoder modes,
``fixed_decoder`` (the default state threading) and
``reference_zero_state`` (every decoder step from zero LSTM state), on one
deterministic corpus and one schedule, over ``--seeds`` seeds (each seed
varies the init, the teacher-forcing noise and the shuffle order), records
the per-epoch ELBO proxy (recon + beta * KL at TF=0, the "true loss") and the
other epoch metrics, and runs the JAX study's own :func:`analyze` (a whole
copy) on them.

It adds one thing the JAX study lacks: :func:`compare_to_reference` holds
the port's curves against the JAX study's recorded ones (``--reference``,
by default ``benchmarks/elbo_compare.json``, or ``_chem`` with
``--drug_like``; only ever read). The port draws its init and device noise
from ``torch.Generator`` and JAX from threefry, so one seed gives different
runs in the two packages: the comparison is unpaired, judged against the
JAX seeds' own spread. The port's cross-mode analysis stays paired (both of
its modes share a seed).

On the card the study takes the fused route (``use_pallas``), as the JAX
study took the Pallas kernels on the TPU; with ``--device cpu`` it runs the
plain route. Usage (the committed ``elbo_compare_torch.json``, seeds 67-69;
results can be built over several invocations with ``--seeds`` and
``--merge_from``, and each finished run is written at once)::

    python -m mlx_vae_tpu_torch.studies.elbo_compare --epochs 50 --molecules 45000 \\
        --seeds 67,68,69

The output never lands under a ``benchmarks/`` directory: the JAX study's
recorded results live there.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import random
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

from mlx_vae_tpu_torch.chem.corpus import generate_smiles
from mlx_vae_tpu_torch.cli.common import resolve_device
from mlx_vae_tpu_torch.config import ModelConfig, TrainConfig
from mlx_vae_tpu_torch.data.prepare import make_synthetic_dataset, prepare_from_smiles
from mlx_vae_tpu_torch.data.split import load_and_split
from mlx_vae_tpu_torch.models.vae import ARCVAE
from mlx_vae_tpu_torch.ops.build import compile_sources
from mlx_vae_tpu_torch.train.trainer import ARCVAETrainer

REPO = Path(__file__).resolve().parents[2]
STUDY_DIR = Path(__file__).resolve().parent
# the run's config keys a reference must share (max_length: the unmasked CE
# counts pad positions, so it sets the ELBO proxy's scale; files written
# before the key was recorded used the default 80)
CONFIG_KEYS = ("epochs", "molecules", "batch_size", "max_length", "drug_like")
# the kernels of the study's path on the card: the whole-stack encoder and
# training decoder, and the zero-state scan's gate pair
SOURCES = ("fused_encoder", "fused_train_decoder", "fused_lstm_gates")
NOISE_FACTOR = 1.25  # criterion (a): the JAX study's own cross-mode criterion
N_BOOT = 4000


def mode_configs(use_pallas: bool, **model) -> dict:
    """The study's two model configs (the JAX study's ``mcfgs``): bf16, the
    fused route where ``use_pallas``; ``model`` overrides any field."""
    base = {"compute_dtype": "bfloat16", "use_pallas": use_pallas, **model}
    return {"fixed_decoder": ModelConfig(**base),
            "reference_zero_state": ModelConfig(**{**base, "reference_zero_state": True})}


def train_config(epochs: int, batch_size: int, seed: int, checkpoint_dir: str) -> TrainConfig:
    """The JAX study's ``TrainConfig`` for one run."""
    return TrainConfig(epochs=epochs, batch_size=batch_size, learning_rate=5e-4,
                       beta_warmup_epochs=epochs, checkpoint_dir=checkpoint_dir,
                       true_loss_batches=10, seed=seed)


def build_corpus(molecules: int, drug_like: bool, max_length: int):
    """``(train, val)`` splits of the JAX study's corpus: the synthetic token
    corpus (V=80, padded to 64), or the drug-like SMILES corpus (seed 0,
    padded to ``max_length``)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "corpus.json")
        if drug_like:
            print(f"building {molecules}-molecule drug-like corpus "
                  f"(deterministic, seed 0)...", flush=True)
            prepare_from_smiles(generate_smiles(molecules, seed=0),
                                max_length=max_length, path=path)
        else:
            make_synthetic_dataset(n=molecules, vocab_size=80, max_length=64, path=path)
        train_ds, val_ds, _, _ = load_and_split(path)
    return train_ds, val_ds


def run(mode_name, seed, mcfg, tcfg, train_ds, val_ds, epochs, device="cuda",
        stop: Optional[int] = None):
    """Train one seed in one mode from ``ARCVAE`` params drawn from ``seed``;
    returns the curve, one dict per epoch: the JAX study's keys, plus the
    epoch's wall seconds and its training pass's (which ends on the last
    step's metrics, so the device is done). ``stop`` ends the run after
    that many epochs of the ``epochs``-epoch schedule."""
    vae = ARCVAE(mcfg, torch.Generator().manual_seed(seed), device=device)
    trainer = ARCVAETrainer(vae.params, mcfg, tcfg, train_ds, seed=seed)
    pass_s = []
    train_pass = trainer._train_epoch_batches

    def timed_pass(*a):
        t0 = time.perf_counter()
        out = train_pass(*a)
        pass_s.append(time.perf_counter() - t0)
        return out

    trainer._train_epoch_batches = timed_pass
    curve = []
    for epoch in range(epochs if stop is None else stop):
        t0 = time.perf_counter()
        m = trainer.train_epoch(epoch, epochs, val_dataset=val_ds)
        seconds = time.perf_counter() - t0
        elbo = m["train_recon"] + m["beta"] * m["train_kl"]
        curve.append({
            "epoch": epoch, "elbo": elbo,
            "train_loss": m["train_loss"], "val_loss": m["val_loss"],
            "recon": m["train_recon"], "kl": m["train_kl"],
            "mutual_info": m["mutual_info"],
            "seconds": seconds, "train_pass_s": pass_s[-1],
        })
        print(f"[{mode_name} s{seed}] epoch {epoch + 1}/{epochs}: "
              f"elbo={elbo:.4f} val={m['val_loss']:.4f} mi={m['mutual_info']:.3f} "
              f"({seconds:.2f}s)", flush=True)
    return curve


def _rel_gap(a, b):
    return abs(a - b) / max(abs(b), 1e-9)


def _per_epoch_mean(list_of_series):
    """Element-wise mean across runs: [[e0,e1,..],..] -> [mean_e0,..]."""
    return [sum(col) / len(col) for col in zip(*list_of_series)]


def analyze(curves, epochs, warm):
    """curves: {mode: {seed: [epoch dicts]}} -> gap/noise-floor summary."""
    elbos = {m: {s: [c["elbo"] for c in cur] for s, cur in by_seed.items()}
             for m, by_seed in curves.items()}
    modes = list(elbos)
    assert len(modes) == 2
    ma, mb = modes
    seeds = sorted(elbos[ma])

    # Seed-matched cross-mode gap: same seed drives both modes, so init/TF
    # noise is as correlated as it can be; per-epoch mean over seeds.
    cross_mode = [
        [_rel_gap(elbos[ma][s][e], elbos[mb][s][e]) for s in seeds]
        for e in range(epochs)
    ]
    cross_mode_mean = [sum(g) / len(g) for g in cross_mode]

    # Same-mode cross-seed noise floor: all seed pairs within one mode.
    # With a single seed there are no pairs — noise statistics are None
    # rather than a ZeroDivisionError after the training already ran.
    pairs = list(itertools.combinations(seeds, 2))
    if pairs:
        noise = {}
        for m in modes:
            per_epoch = [
                [_rel_gap(elbos[m][s][e], elbos[m][t][e]) for (s, t) in pairs]
                for e in range(epochs)
            ]
            noise[m] = [sum(g) / len(g) for g in per_epoch]
        noise_floor = [max(noise[ma][e], noise[mb][e])
                       for e in range(epochs)]
    else:
        noise = {m: None for m in modes}
        noise_floor = None

    # Epoch-wise gap between the seed-MEAN curves (averaging cancels
    # independent seed noise, exposing any systematic mode divergence).
    mean_a = _per_epoch_mean(list(elbos[ma].values()))
    mean_b = _per_epoch_mean(list(elbos[mb].values()))
    mean_curve_gap = [_rel_gap(a, b) for a, b in zip(mean_a, mean_b)]

    def post(xs):
        xs = xs[warm:]
        return {"mean": sum(xs) / len(xs), "max": max(xs)}

    # Noise-robust statistic: the per-epoch curves oscillate with seed
    # noise (the floor above); the TIME-AVERAGED post-warmup ELBO cancels
    # the oscillation, so its cross-mode gap isolates any systematic
    # mode difference.
    def tavg(series):
        return sum(series[warm:]) / len(series[warm:])

    tavg_runs = {m: {s: tavg(elbos[m][s]) for s in seeds} for m in modes}
    tavg_mode = {m: sum(v.values()) / len(v) for m, v in tavg_runs.items()}
    tavg_gap = _rel_gap(tavg_mode[ma], tavg_mode[mb])
    tavg_spread = {
        m: (max(v.values()) - min(v.values())) / abs(tavg_mode[m])
        for m, v in tavg_runs.items()
    }

    # Bootstrap CI on the headline statistic (VERDICT r3 weak #2: a 0.04%
    # margin at n=3 needed an uncertainty estimate). Resample seeds with
    # replacement, seed-matched across modes (both modes share a seed's
    # init/TF/shuffle noise), recompute the time-averaged cross-mode gap.
    boot = None
    if len(seeds) >= 3:
        import random as _random
        rb = _random.Random(0)
        gaps = []
        for _ in range(4000):
            pick = [seeds[rb.randrange(len(seeds))] for _ in seeds]
            va = sum(tavg_runs[ma][s] for s in pick) / len(pick)
            vb = sum(tavg_runs[mb][s] for s in pick) / len(pick)
            gaps.append(_rel_gap(va, vb))
        gaps.sort()
        boot = {
            "n_boot": len(gaps),
            "median": gaps[len(gaps) // 2],
            "ci95": [gaps[int(0.025 * len(gaps))],
                     gaps[int(0.975 * len(gaps)) - 1]],
            "p_gap_gt_1pct": sum(g > 0.01 for g in gaps) / len(gaps),
        }

    fin = {m: [elbos[m][s][-1] for s in seeds] for m in modes}

    def _mean(v):
        return sum(v) / len(v)

    def _stdev(v):
        if len(v) < 2:
            return None
        mu = _mean(v)
        return (sum((x - mu) ** 2 for x in v) / (len(v) - 1)) ** 0.5

    # Paired common-random-numbers analysis (VERDICT r4 next #2). Both
    # modes already run under the SAME seed (same PRNGKey init, same
    # shuffle/TF noise — run() above), so the per-seed SIGNED relative gap
    # d_s = (tavg_a[s] - tavg_b[s]) / tavg_b[s] is the CRN estimator of
    # the mode effect; its CI can cross zero (the |gap|-of-means bootstrap
    # cannot — folding makes any noise look like a positive gap).
    paired = None
    if len(seeds) >= 3:
        dd = [(tavg_runs[ma][s] - tavg_runs[mb][s]) / tavg_runs[mb][s]
              for s in seeds]
        n_s = len(dd)
        dm = _mean(dd)
        dsd = _stdev(dd)
        se = dsd / n_s ** 0.5
        # t critical values (two-sided 95%) for the df we ever see
        tcrit = {2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571, 6: 2.447,
                 7: 2.365, 8: 2.306, 9: 2.262, 10: 2.228, 11: 2.201,
                 12: 2.179, 13: 2.160, 14: 2.145, 15: 2.131,
                 16: 2.120}.get(n_s - 1, 1.96)
        fa, fb = [tavg_runs[ma][s] for s in seeds], \
                 [tavg_runs[mb][s] for s in seeds]
        sa, sb = _stdev(fa), _stdev(fb)
        mean_b = _mean(fb)
        r_pair = (sum((x - _mean(fa)) * (y - mean_b)
                      for x, y in zip(fa, fb))
                  / ((n_s - 1) * sa * sb)) if sa and sb else None
        import random as _random
        rb = _random.Random(1)
        bm = []
        for _ in range(4000):
            pick = [dd[rb.randrange(n_s)] for _ in range(n_s)]
            bm.append(_mean(pick))
        bm.sort()
        paired = {
            "per_seed_signed_gap": dict(zip(map(str, seeds), dd)),
            "mean_signed_gap": dm,
            "sd": dsd,
            "se": se,
            "t_ci95": [dm - tcrit * se, dm + tcrit * se],
            "bootstrap_ci95": [bm[int(0.025 * len(bm))],
                               bm[int(0.975 * len(bm)) - 1]],
            "within_pair_correlation": r_pair,
            "within_mode_rel_sd": {ma: sa / _mean(fa), mb: sb / mean_b},
            "ci_contains_zero": (dm - tcrit * se) <= 0 <= (dm + tcrit * se),
            # seeds needed for the t-CI half-width to shrink to (1% - |mean|),
            # i.e. to exclude a 1% effect if the point estimate held.
            "n_seeds_to_exclude_1pct": (
                None if abs(dm) >= 0.01 else
                max(3, int((1.96 * dsd / (0.01 - abs(dm))) ** 2 + 0.999))),
        }

    return {
        "paired": paired,
        "seeds": seeds,
        "warmup_epochs_excluded": warm,
        "cross_mode_gap_per_epoch": cross_mode_mean,
        "noise_floor_per_epoch": noise_floor,
        "same_mode_noise_per_epoch": noise,
        "mean_curve_gap_per_epoch": mean_curve_gap,
        "post_warmup": {
            "cross_mode": post(cross_mode_mean),
            "noise_floor": post(noise_floor) if noise_floor else None,
            "mean_curve_gap": post(mean_curve_gap),
            "final_cross_mode_gap": cross_mode_mean[-1],
            "final_mean_curve_gap": mean_curve_gap[-1],
        },
        "time_averaged_post_warmup_elbo": {
            "per_run": tavg_runs,
            "mode_means": tavg_mode,
            "cross_mode_gap": tavg_gap,
            "within_mode_seed_spread": tavg_spread,
            "bootstrap": boot,
        },
        "final_epoch": {
            "mode_means": {m: _mean(fin[m]) for m in modes},
            "mode_stdevs": {m: _stdev(fin[m]) for m in modes},
            "cross_mode_gap": _rel_gap(_mean(fin[ma]), _mean(fin[mb])),
        },
    }


def _betainc(a: float, b: float, x: float) -> float:
    """The regularized incomplete beta function I_x(a, b), by its continued
    fraction (modified Lentz)."""
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    if x > (a + 1.0) / (a + b + 2.0):
        return 1.0 - _betainc(b, a, 1.0 - x)
    front = math.exp(math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
                     + a * math.log(x) + b * math.log1p(-x)) / a
    tiny = 1e-300
    f, c, d = 1.0, 1.0, 0.0
    for i in range(400):
        m = i // 2
        if i == 0:
            num = 1.0
        elif i % 2 == 0:
            num = m * (b - m) * x / ((a + 2 * m - 1) * (a + 2 * m))
        else:
            num = -(a + m) * (a + b + m) * x / ((a + 2 * m) * (a + 2 * m + 1))
        d = 1.0 + num * d
        d = 1.0 / (d if abs(d) > tiny else tiny)
        c = 1.0 + num / c
        c = c if abs(c) > tiny else tiny
        f *= c * d
        if abs(1.0 - c * d) < 1e-15:
            break
    return front * (f - 1.0)


def t_quantile(df: float) -> float:
    """The 0.975 quantile of Student's t with ``df`` (real) degrees of
    freedom (a two-sided 95% interval's factor), by bisection on its upper
    tail."""
    def upper(t):
        return 0.5 * _betainc(df / 2.0, 0.5, df / (df + t * t))

    lo, hi = 0.0, 1.0
    while upper(hi) > 0.025:
        hi *= 2.0
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if upper(mid) > 0.025 else (lo, mid)
    return 0.5 * (lo + hi)


def _mean(v):
    return sum(v) / len(v)


def _var(v):
    mu = _mean(v)
    return sum((x - mu) ** 2 for x in v) / (len(v) - 1)


def welch(a: list, b: list) -> Optional[dict]:
    """Welch's unpaired 95% CI of ``mean(a) - mean(b)``, also relative to
    ``mean(b)`` (taken as fixed); None with fewer than 2 values a side."""
    if len(a) < 2 or len(b) < 2:
        return None
    ma, mb = _mean(a), _mean(b)
    sa, sb = _var(a) / len(a), _var(b) / len(b)
    se = math.sqrt(sa + sb)
    diff = ma - mb
    if se == 0.0:
        df, t = None, 0.0
    else:
        df = (sa + sb) ** 2 / (sa ** 2 / (len(a) - 1) + sb ** 2 / (len(b) - 1))
        t = t_quantile(df)
    lo, hi = diff - t * se, diff + t * se
    return {"diff": diff, "rel_diff": diff / mb, "se": se, "df": df, "t_crit": t,
            "ci95": [lo, hi], "rel_ci95": [lo / mb, hi / mb],
            "ci_contains_zero": lo <= 0.0 <= hi}


def unpaired_bootstrap(a: list, b: list) -> dict:
    """Percentile 95% CI of ``(mean(a) - mean(b)) / mean(b)``, resampling
    each side with replacement on its own (``random.Random(1)``)."""
    rb = random.Random(1)
    rel = []
    for _ in range(N_BOOT):
        va = _mean([a[rb.randrange(len(a))] for _ in a])
        vb = _mean([b[rb.randrange(len(b))] for _ in b])
        rel.append((va - vb) / vb)
    rel.sort()
    return {"n_boot": N_BOOT, "median_rel_diff": rel[N_BOOT // 2],
            "rel_ci95": [rel[int(0.025 * N_BOOT)], rel[int(0.975 * N_BOOT) - 1]]}


def check_reference_config(reference: dict, config: dict) -> None:
    """Raise ``ValueError`` unless the reference's corpus and schedule are
    the run's (:data:`CONFIG_KEYS`)."""
    have = {"max_length": 80, **reference["config"]}
    have["drug_like"] = bool(have.get("drug_like"))
    for k in CONFIG_KEYS:
        if have[k] != config[k]:
            raise ValueError(f"reference config mismatch: {k}={have[k]} in the reference, "
                             f"{config[k]} in this run")


def compare_to_reference(curves: dict, reference: dict, config: dict) -> dict:
    """Hold ``curves`` (``{mode: {seed: [epoch dicts]}}``, this run's) against
    ``reference`` (a JAX study results file, loaded), whose config must be
    ``config``'s (:func:`check_reference_config`). Per mode, unpaired:

    * the per-epoch relative gap between the port's seed-mean ELBO curve and
      the JAX seed-mean curve, and its post-warmup mean and max beside the
      JAX same-mode noise floor of the same epochs
      (``analysis.same_mode_noise_per_epoch[mode]``);
    * the time-averaged post-warmup ELBO per seed on both sides, with
      Welch's 95% CI and a seeded bootstrap CI of the relative difference.

    ``parity`` is true when (a) the gap's post-warmup mean is at most
    :data:`NOISE_FACTOR` x the noise floor's and (b) the Welch CI contains 0;
    None where (b) cannot be judged (fewer than 2 seeds on a side)."""
    check_reference_config(reference, config)
    epochs = config["epochs"]
    warm = epochs // 2
    ref_runs = reference["runs"]
    noise = reference["analysis"]["same_mode_noise_per_epoch"]

    def post(xs):
        xs = xs[warm:]
        return {"mean": sum(xs) / len(xs), "max": max(xs)}

    def tavg(curve):
        xs = [c["elbo"] for c in curve[warm:]]
        return sum(xs) / len(xs)

    modes = {}
    for mode, by_seed in curves.items():
        if mode not in ref_runs or not noise.get(mode):
            raise ValueError(f"reference has no curves or noise floor for mode {mode!r}")
        port_mean = _per_epoch_mean([[c["elbo"] for c in cur] for cur in by_seed.values()])
        jax_mean = _per_epoch_mean([[c["elbo"] for c in cur] for cur in ref_runs[mode].values()])
        gap = [_rel_gap(p, j) for p, j in zip(port_mean, jax_mean)]
        pw_gap, pw_noise = post(gap), post(noise[mode])
        port_t = {str(s): tavg(cur) for s, cur in by_seed.items()}
        jax_t = {str(s): tavg(cur) for s, cur in ref_runs[mode].items()}
        a, b = list(port_t.values()), list(jax_t.values())
        w = welch(a, b)
        within = pw_gap["mean"] <= NOISE_FACTOR * pw_noise["mean"]
        modes[mode] = {
            "port_mean_curve": port_mean,
            "jax_mean_curve": jax_mean,
            "mean_curve_gap_per_epoch": gap,
            "jax_noise_floor_per_epoch": noise[mode],
            "post_warmup": {"mean_curve_gap": pw_gap, "jax_noise_floor": pw_noise,
                            "gap_over_noise": pw_gap["mean"] / pw_noise["mean"]},
            "time_averaged_post_warmup_elbo": {
                "port": {"per_seed": port_t, "mean": _mean(a),
                         "sd": math.sqrt(_var(a)) if len(a) > 1 else None},
                "jax": {"per_seed": jax_t, "mean": _mean(b),
                        "sd": math.sqrt(_var(b)) if len(b) > 1 else None},
                "welch": w,
                "bootstrap": unpaired_bootstrap(a, b),
            },
            "a_gap_within_noise": within,
            "b_welch_ci_contains_zero": None if w is None else w["ci_contains_zero"],
            "parity": None if w is None else bool(within and w["ci_contains_zero"]),
        }
    return {
        "reference_seeds": sorted(int(s) for s in next(iter(ref_runs.values()))),
        "port_seeds": sorted(int(s) for s in next(iter(curves.values()))),
        "warmup_epochs_excluded": warm,
        "criterion": (f"parity per mode: (a) post-warmup mean of the seed-mean ELBO curve gap "
                      f"<= {NOISE_FACTOR} x the JAX same-mode noise floor's post-warmup mean, "
                      f"and (b) the Welch 95% CI of the time-averaged post-warmup ELBO "
                      f"difference contains 0 (unpaired: the packages draw different noise)"),
        "modes": modes,
    }


def refuse_benchmarks_path(path: str) -> None:
    """The study writes nothing under a ``benchmarks/`` directory, where the
    JAX study's recorded results live."""
    if "benchmarks" in Path(path).resolve().parent.parts:
        raise SystemExit(f"ERROR: --output {path} lies under benchmarks/, which holds the "
                         "JAX study's recorded results; write the port's results elsewhere")


def smi_line() -> Optional[str]:
    """The card's ``nvidia-smi`` name and power limit, or None."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout else None


def _write_json(path: str, obj: dict) -> None:
    """Replace ``path`` atomically: hours of curves must not be lost to a
    truncated write."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fo:
        json.dump(obj, fo, indent=2)
    os.replace(tmp, path)


def _print_comparison(comp: dict) -> None:
    print(f"\nagainst the JAX study's recorded curves ({len(comp['reference_seeds'])} seeds; "
          f"port {len(comp['port_seeds'])} seeds; unpaired):")
    for mode, r in comp["modes"].items():
        pw, ta = r["post_warmup"], r["time_averaged_post_warmup_elbo"]
        w = ta["welch"]
        ci = (f"[{100 * w['rel_ci95'][0]:+.2f}%, {100 * w['rel_ci95'][1]:+.2f}%]"
              if w else "n/a (1 seed)")
        b = ta["bootstrap"]["rel_ci95"]
        print(f"  {mode}: seed-mean gap post-warmup mean {100 * pw['mean_curve_gap']['mean']:.2f}% "
              f"max {100 * pw['mean_curve_gap']['max']:.2f}% vs JAX noise floor mean "
              f"{100 * pw['jax_noise_floor']['mean']:.2f}% (a: {r['a_gap_within_noise']}); "
              f"time-averaged ELBO port {ta['port']['mean']:.4f} vs JAX {ta['jax']['mean']:.4f}, "
              f"Welch CI {ci} (b: {r['b_welch_ci_contains_zero']}), bootstrap CI "
              f"[{100 * b[0]:+.2f}%, {100 * b[1]:+.2f}%]; parity {r['parity']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--molecules", type=int, default=20000)
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--seeds", default="67,68,69",
                    help="comma-separated seeds; each runs both modes")
    ap.add_argument("--drug_like", action="store_true",
                    help="train on the fragment-assembled drug-like corpus "
                         "(chem/corpus.py) instead of the synthetic token corpus")
    ap.add_argument("--max_length", type=int, default=80,
                    help="(--drug_like) sequence pad length")
    ap.add_argument("--merge_from", default=None, metavar="JSON",
                    help="merge runs from an existing results file, also a partial "
                         "one; only the (mode, seed) runs absent from it are trained "
                         "(config must match)")
    ap.add_argument("--output", default=None,
                    help="results JSON path (default: "
                         "mlx_vae_tpu_torch/studies/elbo_compare_torch.json, "
                         "or elbo_compare_chem_torch.json with --drug_like, for a "
                         "fresh run; the --reanalyze input file for a reanalysis); "
                         "never under benchmarks/")
    ap.add_argument("--reanalyze", default=None, metavar="JSON",
                    help="recompute analysis, comparison and plot from an existing "
                         "results file (no training)")
    ap.add_argument("--reference", default=None, metavar="JSON",
                    help="the JAX study's recorded results to hold the curves against "
                         "(default: benchmarks/elbo_compare.json, or "
                         "benchmarks/elbo_compare_chem.json with --drug_like); read only")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda[:N] or cpu); the fused route "
                         "runs on cuda")
    args = ap.parse_args(argv)

    prior, chunks = {}, []
    if args.reanalyze:
        with open(args.reanalyze) as f:
            prev = json.load(f)
        curves = {m: {int(s): c for s, c in by.items()} for m, by in prev["runs"].items()}
        pc = prev["config"]
        if pc.get("partial"):
            raise SystemExit(f"ERROR: {args.reanalyze} holds a cut-short study; complete it "
                             "with --merge_from")
        args.epochs, args.molecules = pc["epochs"], pc["molecules"]
        args.batch_size = pc["batch_size"]
        args.drug_like = bool(pc.get("drug_like", False))
        args.max_length = pc.get("max_length", 80)
        seeds = pc["seeds"]
        chunks = pc.get("chunks", [])
        if args.output is None:
            args.output = args.reanalyze
    else:
        if args.output is None:
            args.output = str(STUDY_DIR / ("elbo_compare_chem_torch.json" if args.drug_like
                                           else "elbo_compare_torch.json"))
        seeds = [int(s) for s in args.seeds.split(",")]
    refuse_benchmarks_path(args.output)

    config = {"epochs": args.epochs, "molecules": args.molecules,
              "batch_size": args.batch_size, "seeds": seeds,
              "drug_like": bool(args.drug_like), "max_length": args.max_length}
    if args.reference is None:
        args.reference = str(REPO / "benchmarks" / ("elbo_compare_chem.json" if args.drug_like
                                                     else "elbo_compare.json"))
    with open(args.reference) as f:
        reference = json.load(f)
    try:
        check_reference_config(reference, config)
    except ValueError as e:
        raise SystemExit(f"ERROR: --reference {args.reference}: {e}")

    if not args.reanalyze:
        if args.merge_from:
            with open(args.merge_from) as f:
                prev = json.load(f)
            pc = prev["config"]
            for k, have, want in (("epochs", pc["epochs"], args.epochs),
                                  ("molecules", pc["molecules"], args.molecules),
                                  ("batch_size", pc["batch_size"], args.batch_size),
                                  ("max_length", pc.get("max_length", 80), args.max_length)):
                if have != want:
                    raise SystemExit(f"--merge_from config mismatch: {k}={have} vs --{k} {want}")
            if bool(pc.get("drug_like")) != args.drug_like:
                raise SystemExit("--merge_from corpus type mismatch")
            prior = {m: {int(s): c for s, c in by.items()} for m, by in prev["runs"].items()}
            chunks = pc.get("chunks", [])
            done = sorted(set().union(*prior.values()))
            seeds = sorted(set(seeds) | set(done))
            print(f"merging {len(done)} prior seeds {done}; training "
                  f"{sorted(set(seeds) - set(done))}"
                  + ("; completing the partial runs" if pc.get("partial") else ""))
        config["seeds"] = seeds

        device = resolve_device(args.device)
        if device.type == "cuda":
            compile_sources(SOURCES)  # one nvcc per source, all at once
        train_ds, val_ds = build_corpus(args.molecules, args.drug_like, args.max_length)
        mcfgs = mode_configs(use_pallas=device.type == "cuda")
        curves = {m: dict(prior.get(m, {})) for m in mcfgs}
        chunk = {"seeds": [], "device": str(device), "torch": torch.__version__,
                 "cuda": torch.version.cuda, "use_pallas": device.type == "cuda",
                 "gpu": torch.cuda.get_device_name(device) if device.type == "cuda" else None,
                 "nvidia_smi": smi_line() if device.type == "cuda" else None, "wall_s": 0.0}
        t_start = time.perf_counter()
        for mode, mcfg in mcfgs.items():
            for seed in seeds:
                if seed in curves[mode]:
                    continue
                with tempfile.TemporaryDirectory() as ck:
                    tcfg = train_config(args.epochs, args.batch_size, seed, ck)
                    curves[mode][seed] = run(mode, seed, mcfg, tcfg, train_ds, val_ds,
                                             args.epochs, device=device)
                if seed not in chunk["seeds"]:
                    chunk["seeds"].append(seed)
                chunk["wall_s"] = time.perf_counter() - t_start
                # every finished run is on disk at once: a run cut short
                # loses only itself, and --merge_from of this partial file
                # trains only the (mode, seed) pairs it lacks
                _write_json(args.output, {
                    "runs": {m: {str(s): c for s, c in by.items()} for m, by in curves.items()},
                    "config": {**config, "chunks": chunks + [chunk], "partial": True}})
        chunks = chunks + [chunk]
    config["chunks"] = chunks
    devices = {(c["device"], c["torch"], c["nvidia_smi"]) for c in chunks}
    if len(devices) == 1:
        config["device"], config["torch"], config["nvidia_smi"] = devices.pop()

    warm = args.epochs // 2
    analysis = analyze(curves, args.epochs, warm)
    comparison = compare_to_reference(curves, reference, config)
    out = {
        "runs": {m: {str(s): c for s, c in by_seed.items()} for m, by_seed in curves.items()},
        "analysis": analysis,
        "reference_comparison": {"reference": os.path.relpath(args.reference, REPO),
                                 **comparison},
        "config": config,
    }
    _write_json(args.output, out)

    pw = analysis["post_warmup"]
    print(f"\npost-warmup (epochs {warm}-{args.epochs}):")
    print(f"  cross-mode gap   mean {100 * pw['cross_mode']['mean']:.2f}%  "
          f"max {100 * pw['cross_mode']['max']:.2f}%  "
          f"final {100 * pw['final_cross_mode_gap']:.2f}%")
    if pw["noise_floor"]:
        print(f"  noise floor      mean {100 * pw['noise_floor']['mean']:.2f}%"
              f"  max {100 * pw['noise_floor']['max']:.2f}%")
    print(f"  seed-mean curves mean {100 * pw['mean_curve_gap']['mean']:.2f}%  "
          f"max {100 * pw['mean_curve_gap']['max']:.2f}%  "
          f"final {100 * pw['final_mean_curve_gap']:.2f}%")
    if pw["noise_floor"]:
        within = pw["cross_mode"]["mean"] <= pw["noise_floor"]["mean"] * NOISE_FACTOR
        print(f"  cross-mode within 1.25x noise floor: {within}")
    ta = analysis["time_averaged_post_warmup_elbo"]
    print(f"  time-averaged ELBO: cross-mode gap "
          f"{100 * ta['cross_mode_gap']:.2f}%  within-mode seed spread "
          + "  ".join(f"{m}={100 * v:.2f}%"
                      for m, v in ta["within_mode_seed_spread"].items()))
    if ta.get("bootstrap"):
        b = ta["bootstrap"]
        print(f"  bootstrap ({b['n_boot']} resamples over "
              f"{len(analysis['seeds'])} seeds): median "
              f"{100 * b['median']:.2f}%  95% CI "
              f"[{100 * b['ci95'][0]:.2f}%, {100 * b['ci95'][1]:.2f}%]  "
              f"P(gap>1%)={b['p_gap_gt_1pct']:.3f}")
    if analysis.get("paired"):
        p = analysis["paired"]
        print(f"  paired (CRN, signed): mean {100 * p['mean_signed_gap']:+.2f}%"
              f"  t-CI95 [{100 * p['t_ci95'][0]:+.2f}%, "
              f"{100 * p['t_ci95'][1]:+.2f}%]  contains 0: "
              f"{p['ci_contains_zero']}  pair-corr "
              f"{p['within_pair_correlation']:.2f}")
    fe = analysis["final_epoch"]
    print(f"  final epoch: mean gap {100 * fe['cross_mode_gap']:.2f}%  "
          f"stdevs " + "  ".join(
              f"{m}={v:.3f}" if v is not None else f"{m}=n/a (1 seed)"
              for m, v in fe["mode_stdevs"].items()))
    _print_comparison(comparison)
    print(f"wrote {args.output}")

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        ep = list(range(args.epochs))
        figure, axes = plt.subplots(1, 2, figsize=(11, 4))
        for mode, style in (("fixed_decoder", "-"), ("reference_zero_state", "--")):
            r = comparison["modes"][mode]
            axes[0].plot(ep, r["port_mean_curve"], style, label=f"port {mode} (seed mean)")
            axes[0].plot(ep, r["jax_mean_curve"], style, c="gray", lw=1,
                         label=f"JAX {mode} (seed mean)")
            axes[1].plot(ep, [100 * g for g in r["mean_curve_gap_per_epoch"]], style,
                         label=f"{mode}: port vs JAX seed-mean gap")
            axes[1].plot(ep, [100 * g for g in r["jax_noise_floor_per_epoch"]], style,
                         c="gray", lw=1, label=f"{mode}: JAX same-mode noise floor")
        axes[0].set_xlabel("epoch"); axes[0].set_ylabel("ELBO proxy (TF=0)")
        axes[0].set_title("seed-mean ELBO curves"); axes[0].legend(fontsize=7)
        axes[1].set_xlabel("epoch"); axes[1].set_ylabel("relative gap (%)")
        axes[1].set_title("port vs JAX gap and JAX noise floor"); axes[1].legend(fontsize=7)
        figure.tight_layout()
        png = str(Path(args.output).with_suffix(".png"))
        figure.savefig(png, dpi=120)
        plt.close(figure)
        print(f"wrote {png}")
    except Exception as e:  # plotting must never fail the run
        print(f"plot skipped: {e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
