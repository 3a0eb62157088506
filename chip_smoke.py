#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's serving path once on an NVIDIA GPU.

    python3 chip_smoke.py            # phases 1-5 below
    python3 chip_smoke.py --sweep    # phases 1-2, then the tile sweep

Run from the root of a checkout, on a machine with one CUDA card, nvcc and
PyTorch built for CUDA. Phases (each prints one line or a few):

1. device: the card's name and power limit; TF32 off for matmuls and cuDNN;
2. build: nvcc builds ``mlx_vae_tpu_torch/csrc/fused_generate.cu`` (sm_90a);
3. kernel vs plain: the fused sampler kernel against its plain PyTorch
   version on the card at the default model width (V=80, E=128, H=256,
   latent 128, 1 condition, 2 layers), at every serving tier B = 256, 2048,
   8192, L=64, f32 and bf16, greedy, stochastic (T=0.8) and truncated
   (top-k=6 / top-p=0.8, T=0.8): tokens agree on >= 99.0% of first tokens
   and >= 97.0% of rows; the first step's scaled logits agree within
   1e-4 (f32) / 1e-2 (bf16) absolute; truncated first tokens lie in the
   plain version's kept set; rows emit only pad after EOS; moving seed
   blocks to other batch positions leaves their tokens bitwise unchanged;
4. the slice: a random-init checkpoint is served by the port's HTTP server
   (tiers 256,2048,8192, max_length 64, f32) and answers health, stochastic,
   repeated-seed, greedy, multi-pass and malformed requests; the kernel
   launch counter, reset just before, must have risen;
5. times: kernel vs plain sampler in mols/s at B = 256, 2048, 8192 (L=64,
   f32, T=0.8), CUDA events after a warm-up.

``--sweep`` times the kernel with each rows-per-thread instance forced
(1, 2, 4, 8) at B = 256, 1024, 2048, 8192, L=64, T=0.8, f32 and bf16:
three repeats of 5 launches each after a warm-up, CUDA events. It is the
measurement behind the tile rule in ``ops/fused_decoder.py:_tile_rows``.

Any failed check raises, so the script exits non-zero before the last line.
The last line is ``{"ok": true, "device": {...}}``; the line before it is
the per-kernel JSON record. Without CUDA the script exits 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import torch

AGREE_FIRST = 0.99  # share of first tokens that must agree, kernel vs plain
AGREE_ROWS = 0.97   # share of whole rows that must agree
# |kernel - plain| of the first step's scaled logits; in bf16 an f32
# difference of one ulp can move an operand's rounding by one bf16 step
LOGIT_ATOL = {"float32": 1e-4, "bfloat16": 1e-2}
TIERS = (256, 2048, 8192)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def default_model(dtype: str):
    from mlx_vae_tpu_torch.config import ModelConfig
    from mlx_vae_tpu_torch.models.decoder import init_decoder_params
    from mlx_vae_tpu_torch.utils.tree import params_from_numpy, params_to_numpy

    cfg = ModelConfig(compute_dtype=dtype)
    gen = torch.Generator().manual_seed(1234)
    params = params_from_numpy(params_to_numpy(init_decoder_params(gen, cfg)), "cuda")
    return cfg, params


def inputs(cfg, params, B: int, temperature: float, seed: int):
    from mlx_vae_tpu_torch.models.decoder import hidden_init_row
    from mlx_vae_tpu_torch.ops.fused_decoder import block_rows

    g = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.randn((B, cfg.latent_dim), generator=g, device="cuda")
    cond = torch.randn((B, cfg.num_conditions), generator=g, device="cuda")
    nb = -(-B // block_rows(B))
    seeds = torch.randint(0, 2**31 - 1, (nb,), generator=g, device="cuda",
                          dtype=torch.int32)
    temps = torch.full((nb,), temperature, device="cuda")
    h0 = hidden_init_row(params, cfg, z, cond).contiguous()
    return h0, cond.contiguous(), seeds, temps


def agreement(a: torch.Tensor, b: torch.Tensor):
    return ((a[:, 0] == b[:, 0]).float().mean().item(),
            (a == b).all(dim=1).float().mean().item())


def check_eos(toks: torch.Tensor, cfg) -> None:
    ended = torch.cumsum((toks == cfg.end_token).int(), dim=1)
    after = torch.zeros_like(ended, dtype=torch.bool)
    after[:, 1:] = ended[:, :-1] > 0
    bad = (after & (toks != cfg.pad_token)).sum().item()
    if bad:
        raise AssertionError(f"{bad} non-pad tokens after EOS")


def phase_kernel_vs_plain() -> tuple:
    """Returns (largest |kernel - plain| first-step logit, largest share of
    rows that differed) over every run."""
    from mlx_vae_tpu_torch.ops.fused_decoder import (
        fused_generate, fused_generate_reference, prepare_weights)
    from mlx_vae_tpu_torch.ops.sampling import truncate_logits_bisect

    L = 64
    worst_err, worst_rows = 0.0, 0.0
    modes = (("greedy", 1.0, {"greedy": True}), ("T=0.8", 0.8, {}),
             ("top_k=6 top_p=0.8", 0.8, {"top_k": 6, "top_p": 0.8}))
    for dtype in ("float32", "bfloat16"):
        cfg, params = default_model(dtype)
        w = prepare_weights(params, cfg, "cuda")
        for B in TIERS:
            for mode, temp, kw in modes:
                h0, cond, seeds, temps = inputs(cfg, params, B, temp, seed=7)
                lk = torch.empty((B, cfg.vocab_size), device="cuda")
                lp = torch.empty_like(lk)
                k = fused_generate(w, h0, cond, seeds, temps, L, logits_out=lk, **kw)
                torch.cuda.synchronize()
                p = fused_generate_reference(w, h0, cond, seeds, temps, L,
                                             logits_out=lp, **kw)
                torch.cuda.synchronize()
                first, rows = agreement(k, p)
                err = (lk - lp).abs().max().item()
                worst_err, worst_rows = max(worst_err, err), max(worst_rows, 1.0 - rows)
                line = (f"  {dtype} B={B} {mode}: first tokens {first:.4%}, rows "
                        f"{rows:.4%}, first-step logits max |diff| {err:.3e}")
                if "top_k" in kw:
                    kept = truncate_logits_bisect(lp, cfg.vocab_size, 6, 0.8) > -0.5e30
                    inside = kept[torch.arange(B, device="cuda"),
                                  k[:, 0].long()].float().mean().item()
                    line += f", first tokens in the plain kept set {inside:.4%}"
                    if inside < 1.0:
                        raise AssertionError("a truncated first token lies outside "
                                             "the kept set")
                log(line)
                if first < AGREE_FIRST or rows < AGREE_ROWS:
                    raise AssertionError(f"{dtype} B={B} {mode}: agreement below "
                                         f"{AGREE_FIRST:.0%} / {AGREE_ROWS:.0%}")
                if not err <= LOGIT_ATOL[dtype]:
                    raise AssertionError(f"{dtype} B={B} {mode}: logits differ by "
                                         f"{err} > {LOGIT_ATOL[dtype]}")
                if not ((k >= 0) & (k < cfg.vocab_size)).all():
                    raise AssertionError("token id out of range")
                check_eos(k, cfg)
                if mode == "T=0.8" and B > 256:
                    # seed blocks moved to other batch positions keep their tokens
                    bb = 256
                    nb = B // bb
                    perm = torch.arange(nb - 1, -1, -1, device="cuda")
                    moved = (perm[:, None] * bb + torch.arange(bb, device="cuda")).reshape(-1)
                    kp = fused_generate(w, h0[moved].contiguous(), cond[moved].contiguous(),
                                        seeds[perm].contiguous(), temps[perm].contiguous(), L)
                    torch.cuda.synchronize()
                    if not torch.equal(kp, k[moved]):
                        raise AssertionError("seed-block tokens changed with batch position")
                    log(f"  {dtype} B={B}: {nb} seed blocks reversed in the batch -> "
                        f"tokens bitwise unchanged")
    log("  EOS rows emit only pad after EOS: ok")
    return worst_err, worst_rows


def post(base, payload, path="/generate"):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def phase_slice(tmp: str) -> int:
    """Serve a random-init checkpoint; returns the kernel launches the
    requests made."""
    import numpy as np

    from mlx_vae_tpu_torch.cli.serve import build_parser, pass_seed, serve_forever
    from mlx_vae_tpu_torch.data.prepare import make_synthetic_dataset
    from mlx_vae_tpu_torch.models.decoder import hidden_init_row
    from mlx_vae_tpu_torch.ops.fused_decoder import (block_rows, fused_generate,
                                                     fused_generate_reference)
    from mlx_vae_tpu_torch.train.checkpoint import build_checkpoint_host, write_checkpoint

    cfg, params = default_model("float32")
    alphabet = make_synthetic_dataset(n=4, vocab_size=cfg.vocab_size)["alphabet"]
    ck = f"{tmp}/checkpoint_best.npz"
    write_checkpoint(ck, build_checkpoint_host(
        0, {"encoder": {}, "decoder": params}, {"encoder": {}, "decoder": {}}, {},
        data_stats={"properties_mean": [60.0], "properties_std": [25.0],
                    "alphabet": alphabet}))
    args = build_parser().parse_args([
        "--checkpoint", ck, "--port", "0", "--batch_sizes", "256,2048,8192",
        "--max_length", "64", "--device", "cuda"])
    ready = threading.Event()
    thread = threading.Thread(target=serve_forever, args=(args, ready), daemon=True)
    t0 = time.perf_counter()
    thread.start()
    if not ready.wait(timeout=300):
        raise AssertionError("server did not come up")
    log(f"  server up with every tier warm in {time.perf_counter() - t0:.2f}s")
    base = f"http://127.0.0.1:{ready.server.server_address[1]}"
    fields = {"num_molecules", "target", "temperature", "greedy", "top_k", "top_p",
              "mols_per_sec", "passes", "coalesced", "validity", "uniqueness",
              "selfies"}
    try:
        fused_generate.launches = 0  # count only the main path's launches
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
        if health["status"] != "ok" or health["batch_tiers"] != [256, 2048, 8192]:
            raise AssertionError(f"bad /health: {health}")
        log(f"  /health: backend={health['backend']} device={health['device']} "
            f"tiers={health['batch_tiers']} warm={health['warmup']['complete']}")
        req = {"num_molecules": 200, "target": [90.0], "temperature": 0.8,
               "seed": 11, "return_tokens": True}
        _, a = post(base, req)
        _, b = post(base, req)
        if a["tokens"] != b["tokens"]:
            raise AssertionError("same seed gave different tokens")
        _, g = post(base, {**req, "greedy": True})
        _, big = post(base, {"num_molecules": 10000, "target": [90.0],
                             "temperature": 0.8, "seed": 5, "max_selfies": 10,
                             "return_tokens": True})
        for name, resp, n in (("stochastic", a, 200), ("greedy", g, 200),
                              ("10000", big, 10000)):
            missing = fields - set(resp)
            if missing:
                raise AssertionError(f"{name} response lacks {sorted(missing)}")
            toks = np.asarray(resp["tokens"])
            if toks.shape != (n, 64) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
                raise AssertionError(f"{name}: bad token matrix {toks.shape}")
            if not (0.0 <= resp["validity"] <= 1.0 and 0.0 < resp["uniqueness"] <= 1.0
                    and np.isfinite(resp["mols_per_sec"])):
                raise AssertionError(f"{name}: bad metrics")
            log(f"  {name}: {resp['mols_per_sec']:.1f} mols/s served, "
                f"{resp['passes']} pass(es), validity {resp['validity']:.4f}, "
                f"uniqueness {resp['uniqueness']:.4f}")
        if big["passes"] < 2:
            raise AssertionError("10000 molecules should take more than one pass")
        try:
            post(base, {"num_molecules": 0})
            raise AssertionError("bad request was accepted")
        except urllib.error.HTTPError as e:
            if e.code != 400:
                raise
        log("  same seed -> identical tokens; malformed request -> 400")
        launches = fused_generate.launches
        if launches < 1:
            raise AssertionError("the served requests never launched the kernel")
        log(f"  kernel launches during the requests: {launches}")

        # The greedy response against the plain version on the same draws.
        service = ready.service
        gen = torch.Generator(device="cuda").manual_seed(pass_seed(11, 0))
        tier = service.plan_passes(200)[0]
        tn = torch.as_tensor(service.mean, device="cuda")
        cond = ((torch.full((tier, 1), 90.0, device="cuda") - tn)
                / torch.as_tensor(service.std, device="cuda")).contiguous()
        z = torch.randn((tier, cfg.latent_dim), generator=gen, device="cuda")
        nb = -(-tier // block_rows(tier))
        seeds = torch.randint(0, 2**31 - 1, (nb,), generator=gen, device="cuda",
                              dtype=torch.int32)
        h0 = hidden_init_row(service.params["decoder"], cfg, z, cond).contiguous()
        plain = fused_generate_reference(service.weights, h0, cond, seeds,
                                         torch.full((nb,), 0.8, device="cuda"),
                                         64, greedy=True)[:200].cpu().numpy()
        served = np.asarray(g["tokens"])
        rows = float((plain == served).all(1).mean())
        log(f"  served greedy rows equal to the plain version: {rows:.4%}")
        if rows < AGREE_ROWS:
            raise AssertionError("served greedy tokens disagree with the plain version")
    finally:
        ready.server.shutdown()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("server thread did not stop")
    return launches


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_times(smi: str) -> dict:
    from mlx_vae_tpu_torch.ops.fused_decoder import (
        fused_generate, fused_generate_reference, prepare_weights)

    cfg, params = default_model("float32")
    w = prepare_weights(params, cfg, "cuda")
    out = {}
    for B in (256, 2048, 8192):
        h0, cond, seeds, temps = inputs(cfg, params, B, 0.8, seed=3)
        k_ms = time_ms(lambda: fused_generate(w, h0, cond, seeds, temps, 64), 10)
        p_ms = time_ms(lambda: fused_generate_reference(w, h0, cond, seeds, temps, 64), 3)
        out[B] = (k_ms, p_ms)
        log(f"  B={B} L=64 f32 T=0.8: kernel {k_ms:.3f} ms ({B / k_ms * 1e3:,.0f} mols/s), "
            f"plain {p_ms:.3f} ms ({B / p_ms * 1e3:,.0f} mols/s) [{smi}]")
    return out


def phase_sweep(smi: str) -> list:
    """Kernel ms with each rows-per-thread instance forced."""
    from mlx_vae_tpu_torch.ops.fused_decoder import (_RPTS, fused_generate,
                                                     prepare_weights)

    out = []
    for dtype in ("float32", "bfloat16"):
        cfg, params = default_model(dtype)
        w = prepare_weights(params, cfg, "cuda")
        for B in (256, 1024, 2048, 8192):
            h0, cond, seeds, temps = inputs(cfg, params, B, 0.8, seed=3)
            cells = []
            for rpt in sorted(_RPTS):
                reps = [time_ms(lambda: fused_generate(w, h0, cond, seeds, temps, 64,
                                                       rows_per_thread=rpt), 5)
                        for _ in range(3)]
                out.append({"dtype": dtype, "B": B, "rows_per_thread": rpt,
                            "ms": reps})
                cells.append(f"R={rpt} {min(reps):.3f}-{max(reps):.3f}")
            log(f"  {dtype} B={B} L=64 T=0.8 kernel ms (3 repeats of 5): "
                f"{'; '.join(cells)} [{smi}]")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true",
                    help="time every rows-per-thread instance instead of phases 3-5")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from mlx_vae_tpu_torch.ops.fused_decoder import build_library

    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1 device] {name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; allow_tf32 matmul=False cudnn=False")

    t0 = time.perf_counter()
    build_library(verbose=True)
    log(f"[2 build] csrc/fused_generate.cu built and loaded in "
        f"{time.perf_counter() - t0:.2f}s")

    device = {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}
    if args.sweep:
        log(f"[sweep] rows per thread forced, default model [{smi}]")
        sweep = phase_sweep(smi)
        log(smi)
        print(json.dumps({"tile_sweep": sweep}))
        print(json.dumps({"ok": True, "device": device}))
        return 0

    log("[3 kernel vs plain] default model, B=256/2048/8192, L=64")
    worst_err, worst_rows = phase_kernel_vs_plain()

    log("[4 slice] port server, tiers 256,2048,8192, max_length 64, f32")
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_slice(tmp)

    log(f"[5 times] kernel vs plain sampler, CUDA events [{smi}]")
    times = phase_times(smi)

    k_ms, p_ms = times[8192]
    log(smi)
    print(json.dumps({"kernels": [{
        "name": "fused_generate", "route": "cuda",
        "source": "mlx_vae_tpu_torch/csrc/fused_generate.cu",
        "replaces": "mlx_vae_tpu/ops/pallas_decoder.py:142",
        "launches": launches,
        "max_abs_err": worst_err,
        "err_metric": "largest |kernel - plain| of the first step's scaled logits "
                      "over B=256/2048/8192, f32/bf16, greedy/T=0.8/top-k+top-p "
                      "(tolerance 1e-4 f32, 1e-2 bf16)",
        "max_row_disagreement": worst_rows,
        "ms": k_ms, "plain_ms": p_ms,
        "timed_shape": "B=8192 L=64 f32 T=0.8"}]}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
