"""The training decoder's backward (PERF row 5) on one CUDA card, by dtype;
prints ONE JSON line.

    python -m mlx_vae_tpu_torch.bench_dec_bwd [--dtypes float32,bfloat16] [--digest]

At the default model (V=80, E=128, C=1, H=256, n=2), L=64, with the fused
CE, on the plain forward's residuals (inputs made on the card from fixed
seeds, as ``chip_smoke.py`` phase 6 makes them):

* ``ms``: one whole backward (``ops/fused_train_decoder.py:decoder_bwd``)
  at B=4096, CUDA events, the least of three timings of 3 calls each after
  a warm-up;
* ``launch_us``: each kernel of one backward call (``torch.profiler``):
  its launches, their mean and their total device time;
* ``--digest``: a SHA-256 of every output of the reverse alone and of the
  whole backward (``launch_decoder_bwd(..., with_reverse=True)``) at each
  of phase 6's batches, with and without CE, and of the inputs. The
  functions it calls have kept their signatures, so the file runs in an
  older checkout too: run there (``python -m`` from that checkout's root)
  and here, and equal digests on equal inputs mean bitwise equal outputs.

The card's name and power limit go to stderr. Without CUDA the script
exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys

import torch

B, L = 4096, 64
BATCHES = (4096, 2053, 2052, 1000, 64, 34)  # chip_smoke.py:TRAIN_BATCHES


def _setup(dtype: str, Bn: int, with_ce: bool):
    """(w, din, targets, h0, cond, toks, hs, cs, gs) on the card: the
    default model's decoder weights (seed 0), phase 6's inputs for batch
    ``Bn`` (seed ``Bn``) and the plain forward's residuals under full
    teacher forcing."""
    from mlx_vae_tpu_torch.bench import init_train_params
    from mlx_vae_tpu_torch.config import ModelConfig
    from mlx_vae_tpu_torch.ops import fused_train_decoder as fd
    from mlx_vae_tpu_torch.ops import train_common as tc

    cfg = ModelConfig(compute_dtype=dtype, use_pallas=True)
    w = tc.prepare_stack_weights(init_train_params(cfg, "cuda", 0)["decoder"], cfg,
                                 with_head=True)
    g = torch.Generator(device="cuda").manual_seed(Bn)
    tok = torch.randint(0, cfg.vocab_size, (Bn, L), generator=g, device="cuda",
                        dtype=torch.int32)
    cond = torch.randn((Bn, cfg.num_conditions), generator=g, device="cuda")
    h0 = 0.5 * torch.randn((Bn, cfg.hidden_dim), generator=g, device="cuda")
    tf = torch.ones((L,), dtype=torch.bool, device="cuda")
    _, toks, hs, cs, gs = fd.decoder_fwd_reference(w, h0, cond, tok, tf, with_ce)
    din = (torch.randn((Bn,), generator=g, device="cuda") if with_ce else
           torch.randn((Bn, L, cfg.vocab_size), generator=g, device="cuda") / (Bn * L))
    return w, din, tok, h0, cond, toks, hs, cs, gs


def _sha(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def digest(dtype: str) -> dict:
    """{"B=.. ce|logits": {"inputs": sha, "outputs": sha}} of one dtype."""
    from mlx_vae_tpu_torch.ops import fused_train_decoder as fd

    lib, out = fd.build_library(), {}
    st = torch.cuda.current_stream().cuda_stream
    for Bn in BATCHES:
        for with_ce in (True, False):
            w, din, tok, h0, cond, toks, hs, cs, gs = _setup(dtype, Bn, with_ce)
            r = fd.launch_decoder_bwd(lib, w, din, tok, toks, h0, cond, hs, cs, gs, with_ce, st,
                                      with_reverse=True)
            torch.cuda.synchronize()
            out[f"B={Bn} {'ce' if with_ce else 'logits'}"] = {
                "inputs": _sha([w.wcat, w.wout, din, tok, h0, cond, toks, hs, cs, gs]),
                "outputs": _sha([*r[0], *r[1:]])}
    return out


def timing(dtype: str) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from mlx_vae_tpu_torch.ops import fused_train_decoder as fd

    w, din, tok, h0, cond, toks, hs, cs, gs = _setup(dtype, B, True)

    def call():
        return fd.decoder_bwd(w, din, tok, toks, h0, cond, hs, cs, gs, True)

    call()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            call()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / 3)
    # a first call as the profiler's warm-up step (traced, not kept): CUPTI
    # can drop the kernels launched as tracing starts; the kept step's own
    # range on the device ("ProfilerStep#1") is no kernel
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        call()
        torch.cuda.synchronize()
        prof.step()
        call()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.name.startswith("ProfilerStep"):
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0][:80]
            n, us = by.get(name, (0, 0.0))
            by[name] = (n + 1, us + e.time_range.elapsed_us())
    return {"ms": best, "launch_us": {k: {"launches": n, "mean_us": us / n, "total_us": us}
                                      for k, (n, us) in sorted(by.items(), key=lambda kv: -kv[1][1])}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--digest", action="store_true",
                    help="SHA-256 of every output at phase 6's batches, instead of times")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_dec_bwd: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip().splitlines()[0] if smi.strip() else torch.cuda.get_device_name(0),
          file=sys.stderr)
    run = digest if args.digest else timing
    out = {dt: run(dt) for dt in args.dtypes.split(",")}
    print(json.dumps({"dec_bwd_digest" if args.digest else "dec_bwd": out,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
