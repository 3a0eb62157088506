"""Run one cell of the benchmark and print its result as the last line.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is the entry of ``BENCHMARK.json`` named ``--workload``: its
configuration (``portbench/configs/<config>.json``), its traffic mix
(``portbench/mixes/<traffic>.json``, whose ``kind`` names the driver
``portbench/traffic/<kind>.py``) and its limits
(``portbench/limits/<workload>.json``). With ``--trace 0`` the result
carries the cell's end-to-end metrics; with ``--trace 1`` its per-layer
metrics, each read by ``portbench/metrics/<name>.py`` from the run's
counts, spans and profiled stretch, and the trace's breakdown.

Without a CUDA card the run exits 2 and prints no result; it never falls
back to the CPU.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # the process's start, as near as Python sees it

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from portbench import harness  # noqa: E402

MODEL_KEYS = ("vocab_size", "embedding_dim", "hidden_dim", "latent_dim", "num_conditions",
              "num_layers", "dropout", "bidirectional", "apply_dropout", "compute_dtype",
              "use_pallas")


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout. The port
    builds its libraries into ``mlx_vae_tpu_torch/build/`` there itself."""
    base = harness.CHECKOUT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["USE_FLAX"] = "0"


def cell(name: str, bench: dict = None) -> SimpleNamespace:
    """The cell ``name``: its BENCHMARK.json entry, configuration, mix,
    limits, and the metrics it reports."""
    bench = bench or harness.load_json(harness.CHECKOUT / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return SimpleNamespace(
        name=name, entry=w,
        cfg=harness.load_json(harness.ROOT / "configs" / f"{w['config']}.json"),
        mix=harness.load_json(harness.ROOT / "mixes" / f"{w['traffic']}.json"),
        limits=harness.load_json(harness.ROOT / "limits" / f"{name}.json"),
        e2e=e2e, per_layer=per_layer)


def context(c: SimpleNamespace, seed: int, seconds: float, trace: bool, device,
            hooks: dict = None) -> SimpleNamespace:
    """What a traffic kind's ``run`` is given."""
    from mlx_vae_tpu_torch.config import ModelConfig

    def model_config(**over):
        return ModelConfig(**{**{k: c.cfg[k] for k in MODEL_KEYS}, **over})

    return SimpleNamespace(cfg=c.cfg, mix=c.mix, limits=c.limits, seed=seed, seconds=seconds,
                           trace=trace, device=device, spans=harness.Spans(),
                           hooks=hooks or {}, t_start=T_START, model_config=model_config)


def drive(c: SimpleNamespace, ctx: SimpleNamespace) -> dict:
    """Run the cell's traffic kind and build the result line."""
    kind = harness.load_module(harness.ROOT / "traffic" / f"{c.mix['kind']}.py")
    work = harness.load_module(harness.ROOT / "work" / f"{c.cfg['family']}.{c.mix['kind']}.py")
    peaks = harness.load_json(harness.ROOT / "peaks.json")
    out = kind.run(ctx)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"portbench: loaded in this process: {', '.join(found)}")
        raise SystemExit(3)
    if ctx.trace:
        r = SimpleNamespace(kind=c.mix["kind"], window=out["window"], trace=out["trace"],
                            work=work.per_unit(c.cfg, c.mix),
                            peak={"flops": peaks["flops"][c.cfg["compute_dtype"]],
                                  "bytes": peaks["bytes_per_s"]})
        metrics = {}
        for m in c.per_layer:
            v = harness.load_module(harness.ROOT / "metrics" / f"{m['name']}.py").read(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                   for m in c.e2e}
    # a check that reads no finite number (a malformed token, a NaN) fails
    # with a finite stand-in, so the line stays strict JSON
    checks = {k: {"value": v["value"] if math.isfinite(v["value"]) else 1e30,
                  "limit": v["limit"]} for k, v in out["checks"].items()}
    result = {"correct": all(v["value"] <= v["limit"] for v in checks.values())
              and out["failed"] == 0,
              "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
              "device": out["device"]}
    if ctx.trace:
        t = out["trace"]
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    result["checks"] = checks
    return result


def power_limit() -> str:
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
        return r.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {type(e).__name__}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_cache_dirs()
    c = cell(args.workload)
    import torch

    chips = c.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"portbench: {chips} CUDA card(s) needed, "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    result = drive(c, context(c, args.seed, args.seconds, bool(args.trace), dev))
    harness.log(f"portbench: {args.workload} seed {args.seed} on {power_limit()}")
    for name, v in result["checks"].items():
        harness.log(f"check {name} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
