"""Where a split-TF32 train launch spends its time, on one CUDA card; prints
ONE JSON line.

    python -m mlx_vae_tpu_torch.bench_train_f32

At the default model (E=128, H=256, n=2, L=64), f32, for B = 1024, 2048 and
4096 and the same shapes in bf16 beside them:

* ``fwd_ms`` / ``bwd_ms``: the whole-stack encoder's forward and backward
  (``ops/fused_encoder.py``), CUDA events, the least of three timings of 3
  calls each after a warm-up;
* ``launch_us``: the mean device time of one launch of each kernel of one
  forward and one backward call (``torch.profiler``), by kernel and, for
  the per-step kernels, by layer (launch i of a forward runs layer i // L;
  the reverse chain's launch i layer n - 1 - i % n), and of each
  weight-gradient pass in launch order;
* ``plan``: each launch's grid and shared memory
  (``ops/fused_encoder.py:encoder_launch_plan``).

Comparing B = 1024 / 2048 / 4096 separates a block's own latency (a launch
of fewer blocks than the card holds takes as long as one of its blocks)
from the card's throughput. The card's name and power limit go to stderr.
Without CUDA the script exits 2 and prints no result.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys

import torch

from mlx_vae_tpu_torch.bench import init_train_params
from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.ops import fused_encoder as fe
from mlx_vae_tpu_torch.ops import train_common as tc

L = 64


def time_ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def launches(fn) -> list:
    """(kernel name, device us) of each launch of one call, in order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    out = []
    for e in evs:
        m = re.search(r"(\w+_kernel)\b", e.name)
        out.append((m.group(1) if m else e.name[:40], e.time_range.elapsed_us()))
    return out


def by_kernel(evs: list, n: int) -> dict:
    """Mean us a launch by kernel; the per-step kernels also by layer."""
    out = {}
    steps = {}
    for name, us in evs:
        steps.setdefault(name, []).append(us)
    for name, us in steps.items():
        rec = {"count": len(us), "mean_us": sum(us) / len(us)}
        if len(us) == n * L and "fwd" in name:
            rec["by_layer_us"] = [sum(us[l * L:(l + 1) * L]) / L for l in range(n)]
        elif len(us) == n * L:  # the reverse chain: top down within a step
            rec["by_layer_us"] = [sum(us[n - 1 - l::n]) / L for l in range(n)]
        elif name.startswith("wgrad"):
            rec["each_us"] = us
        out[name] = rec
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_train_f32: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, file=sys.stderr)
    rec = {"device": torch.cuda.get_device_name(0), "smi": smi, "L": L, "cells": []}
    for dtype in ("float32", "bfloat16"):
        cfg = ModelConfig(compute_dtype=dtype, use_pallas=True)
        params = init_train_params(cfg, "cuda", 0)
        w = tc.prepare_stack_weights(params["encoder"], cfg, with_head=False)
        for B in (1024, 2048, 4096):
            g = torch.Generator(device="cuda").manual_seed(B)
            tok = torch.randint(0, cfg.vocab_size, (B, L), generator=g, device="cuda",
                                dtype=torch.int32)
            dh = torch.randn((B, cfg.hidden_dim), generator=g, device="cuda")
            k = fe.encoder_fwd(w, tok)
            p = fe.encoder_fwd_reference(w, tok)
            torch.cuda.synchronize()
            err = max(float((a.float() - b.float()).abs().max() / b.float().abs().max())
                      for a, b in zip(k, p))
            fwd = lambda: fe.encoder_fwd(w, tok)  # noqa: E731
            bwd = lambda: fe.encoder_bwd(w, tok, dh, *k[1:])  # noqa: E731
            cell = {"dtype": dtype, "B": B, "fwd_err": err, "fwd_ms": time_ms(fwd),
                    "bwd_ms": time_ms(bwd),
                    "launch_us": {"fwd": by_kernel(launches(fwd), cfg.num_layers),
                                  "bwd": by_kernel(launches(bwd), cfg.num_layers)},
                    "plan": fe.encoder_launch_plan(cfg, B, L)}
            rec["cells"].append(cell)
            print(f"{dtype} B={B}: fwd {cell['fwd_ms']:.3f} ms, bwd {cell['bwd_ms']:.3f} ms, "
                  f"err {err:.2e}; {json.dumps(cell['launch_us'])} [{smi}]", file=sys.stderr)
            del k, p
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
