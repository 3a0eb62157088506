"""Where a split-TF32 train launch spends its time, on one CUDA card; prints
ONE JSON line.

    python -m mlx_vae_tpu_torch.bench_train_f32 [--seq]

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

``--seq`` measures the per-layer sequence kernels instead (rows 7-8,
``ops/fused_seq_lstm.py``) at the scaled shape, H = 1024, B = 2048, f32, for
I = 1024 and 128: ``fwd_ms`` / ``bwd_ms`` as above, cuDNN's one-layer f32
``torch.nn.LSTM`` with TF32 off beside them (``cudnn_fwd_ms`` /
``cudnn_bwd_ms``, backward alone), and ``launch_us`` with each kernel's
launch count, mean and total device time in one call (how the backward
splits between its reverse chain, its weight-gradient pass and its column
sums).

Comparing B = 1024 / 2048 / 4096 separates a block's own latency (a launch
of fewer blocks than the card holds takes as long as one of its blocks)
from the card's throughput. The card's name and power limit go to stderr.
Without CUDA the script exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys

import torch

from mlx_vae_tpu_torch.bench import init_train_params
from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.ops import fused_encoder as fe
from mlx_vae_tpu_torch.ops import fused_seq_lstm as fs
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
        rec = {"count": len(us), "mean_us": sum(us) / len(us), "total_ms": sum(us) / 1e3}
        if len(us) == n * L and "fwd" in name:
            rec["by_layer_us"] = [sum(us[l * L:(l + 1) * L]) / L for l in range(n)]
        elif len(us) == n * L:  # the reverse chain: top down within a step
            rec["by_layer_us"] = [sum(us[n - 1 - l::n]) / L for l in range(n)]
        elif name.startswith("wgrad"):
            rec["each_us"] = us
        out[name] = rec
    return out


SEQ_H, SEQ_B = 1024, 2048  # the scaled model's layer width and batch


def cudnn_ms(I: int) -> tuple:
    """cuDNN's one-layer f32 ``torch.nn.LSTM`` with TF32 off at the scaled
    shape: (forward ms, backward-alone ms)."""
    torch.backends.cudnn.allow_tf32 = False
    lstm = torch.nn.LSTM(I, SEQ_H).to("cuda")
    lstm.flatten_parameters()
    x = torch.randn((L, SEQ_B, I), device="cuda", requires_grad=True)
    hc = (torch.zeros((1, SEQ_B, SEQ_H), device="cuda"),) * 2
    fwd = time_ms(lambda: lstm(x.detach(), hc), 1)
    out, _ = lstm(x, hc)
    g = torch.randn_like(out)
    leaves = [x] + list(lstm.parameters())
    return fwd, time_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), 1)


def seq_cells(smi: str) -> list:
    """Rows 7-8 in f32 at the scaled shape, I = 1024 and 128."""
    cells = []
    for I in (1024, 128):
        g = torch.Generator(device="cuda").manual_seed(I)
        s = SEQ_H ** -0.5
        wcat = (torch.rand((I + SEQ_H, 4 * SEQ_H), generator=g, device="cuda") * 2 - 1) * s
        bias = (torch.rand((4 * SEQ_H,), generator=g, device="cuda") * 2 - 1) * s
        xs = torch.randn((L, SEQ_B, I), generator=g, device="cuda")
        h0, c0, dhf, dcf = (0.3 * torch.randn((SEQ_B, SEQ_H), generator=g, device="cuda")
                            for _ in range(4))
        dhs = torch.randn((L, SEQ_B, SEQ_H), generator=g, device="cuda") / (SEQ_B * L) ** 0.5
        res = fs.seq_lstm_fwd(wcat, bias, xs, h0, c0)
        fwd = lambda: fs.seq_lstm_fwd(wcat, bias, xs, h0, c0)  # noqa: E731
        bwd = lambda: fs.seq_lstm_bwd_tm(wcat, xs, h0, c0, *res[:3], dhs, dhf, dcf)  # noqa
        cf, cb = cudnn_ms(I)
        cell = {"dtype": "float32", "I": I, "H": SEQ_H, "B": SEQ_B,
                "fwd_ms": time_ms(fwd, 1), "bwd_ms": time_ms(bwd, 1),
                "cudnn_fwd_ms": cf, "cudnn_bwd_ms": cb,
                "launch_us": {"fwd": by_kernel(launches(fwd), 1),
                              "bwd": by_kernel(launches(bwd), 1)}}
        cells.append(cell)
        print(f"f32 I={I} H={SEQ_H} B={SEQ_B}: fwd {cell['fwd_ms']:.3f} ms, bwd "
              f"{cell['bwd_ms']:.3f} ms, cuDNN (TF32 off) {cf:.3f} / {cb:.3f} ms; "
              f"{json.dumps(cell['launch_us'])} [{smi}]", file=sys.stderr)
        del res, wcat, xs, dhs
        torch.cuda.empty_cache()
    return cells


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", action="store_true",
                    help="the per-layer sequence kernels (rows 7-8) at the scaled shape")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_train_f32: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, file=sys.stderr)
    rec = {"device": torch.cuda.get_device_name(0), "smi": smi, "L": L, "cells": []}
    if args.seq:
        rec["cells"] = seq_cells(smi)
        print(json.dumps(rec))
        return 0
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
