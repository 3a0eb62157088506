"""What an async checkpoint save in flight costs the train pass, on one CUDA
card; prints ONE JSON line.

    python -m mlx_vae_tpu_torch.bench_save [--rounds N]

The train CLI's default model and feed (bf16, ``--use_pallas``, B=4096, a
20,523-molecule synthetic corpus split as the CLI splits it: four batches of
4096 and one of 34 rows a pass) on ``ARCVAETrainer``. After a warm-up pass
and a warm-up save it times the train pass (``_train_epoch_batches``, host
clock; it ends in its last readback) while a second thread, started just
before the pass, does one part of an async save:

* ``none``: no second thread;
* ``save``: ``save_checkpoint`` as the trainer runs it by default (snapshot,
  event, host copy on a side stream, npz write, copy to
  ``checkpoint_best``);
* ``copy``: the snapshot and its host copy on a side stream only
  (``build_checkpoint_host``);
* ``write``: the npz write and the copy to ``checkpoint_best`` only, of a
  host checkpoint built before the pass;
* ``python``: pure-Python work that holds the interpreter lock for as long
  as the last ``save`` thread ran, and nothing else.

The modes run in turns, forward then backward, for N rounds (default 5);
each gives its median train pass and the median time of the second thread's
work. The card's name and power limit go to stderr. Without CUDA the script
exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import torch

from mlx_vae_tpu_torch.config import ModelConfig, TrainConfig
from mlx_vae_tpu_torch.data.prepare import make_synthetic_dataset
from mlx_vae_tpu_torch.data.split import load_and_split
from mlx_vae_tpu_torch.models.vae import ARCVAE
from mlx_vae_tpu_torch.train import checkpoint as ckpt_io
from mlx_vae_tpu_torch.train.trainer import ARCVAETrainer

MODES = ("none", "save", "copy", "write", "python")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def spin(seconds: float) -> None:
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        sum(range(200))


def second_thread(tr: ARCVAETrainer, mode: str, spin_s: float, tmp: str):
    """Start ``mode``'s work beside the pass; returns a function that joins
    it and gives the seconds the work took."""
    box = {}

    def timed(fn):
        def work():
            t0 = time.perf_counter()
            fn()
            box["s"] = time.perf_counter() - t0
        return work

    if mode == "save":
        run_save = tr._run_save

        def run(work):
            timed(lambda: run_save(work))()

        tr._run_save = run
        tr.save_checkpoint(0, is_best=True)
        del tr._run_save

        def join():
            tr.join_saves()
            return box["s"]
        return join
    if mode == "copy":
        params, opt_states, event = tr._snapshot()
        history = {k: list(v) for k, v in tr.history.items()}

        def fn():
            event.synchronize()
            with torch.cuda.stream(torch.cuda.Stream(tr.device)):
                ckpt_io.build_checkpoint_host(0, params, opt_states, history)
    elif mode == "write":
        host = ckpt_io.build_checkpoint_host(0, tr.params, tr.opt_states, tr.history)

        def fn():
            ckpt_io.write_checkpoint(f"{tmp}/w.npz", host)
            shutil.copyfile(f"{tmp}/w.npz", f"{tmp}/w_best.npz")
    elif mode == "python":
        def fn():
            spin(spin_s)
    else:
        return lambda: 0.0
    t = threading.Thread(target=timed(fn))
    t.start()

    def join():
        t.join()
        return box["s"]
    return join


def bench_save(rounds: int) -> dict:
    mcfg = ModelConfig(compute_dtype="bfloat16", use_pallas=True)
    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_dataset(n=20523, vocab_size=mcfg.vocab_size, path=f"{tmp}/s.json")
        train_ds = load_and_split(f"{tmp}/s.json", seed=67)[0]
        tcfg = TrainConfig(batch_size=4096, checkpoint_dir=f"{tmp}/ck")
        vae = ARCVAE(mcfg, torch.Generator().manual_seed(tcfg.seed), device="cuda")
        tr = ARCVAETrainer(vae.params, mcfg, tcfg, train_ds)
        beta, tf = tr.compute_beta(0), tr.compute_teacher_forcing_ratio(0, 2)
        tr._train_epoch_batches(beta, tf)  # warm-up: builds, uploads, allocations
        tr.save_checkpoint(0, is_best=True)
        tr.join_saves()
        res = {m: {"pass_ms": [], "thread_ms": []} for m in MODES}
        spin_s = 0.0
        for r in range(rounds):
            for mode in MODES if r % 2 == 0 else MODES[::-1]:
                if mode == "python" and spin_s == 0.0:
                    continue  # the first round in reverse: no save measured yet
                join = second_thread(tr, mode, spin_s, tmp)
                t0 = time.perf_counter()
                tr._train_epoch_batches(beta, tf)
                dt = time.perf_counter() - t0
                s = join()
                if mode == "save":
                    spin_s = s
                res[mode]["pass_ms"].append(dt * 1e3)
                res[mode]["thread_ms"].append(s * 1e3)
                log(f"round {r} {mode}: train pass {dt * 1e3:.3f} ms, "
                    f"second thread {s * 1e3:.3f} ms")
    for m in res.values():
        m["pass_ms_median"] = statistics.median(m["pass_ms"])
        m["thread_ms_median"] = statistics.median(m["thread_ms"])
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("bench_save: CUDA is not available; this benchmark needs an NVIDIA GPU")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi.stdout.strip()}")
    with contextlib.redirect_stdout(sys.stderr):  # the trainer's save lines
        res = bench_save(args.rounds)
    for mode, m in res.items():
        log(f"{mode:>6}: train pass median {m['pass_ms_median']:.3f} ms, second thread "
            f"median {m['thread_ms_median']:.3f} ms")
    print(json.dumps({"batches_a_pass": 5, "batch": 4096, "modes": res,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
