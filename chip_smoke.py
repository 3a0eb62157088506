#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's serving path and train step once on an
NVIDIA GPU.

    python3 chip_smoke.py            # phases 1-12 below
    python3 chip_smoke.py --sweep    # phases 1-2, then the sampler's cluster / tile sweep

Run from the root of a checkout, on a machine with one CUDA card, nvcc and
PyTorch built for CUDA. Phases (each prints one line or a few):

1. device: the card's name and power limit; TF32 off for matmuls and cuDNN;
2. build: one nvcc per source, all at once, builds every
   ``mlx_vae_tpu_torch/csrc/*.cu`` (sm_90a): the sampler, the fused encoder,
   the fused training decoder, the sequence LSTM and the gate pair; the
   build fails if ptxas serialized a ``wgmma`` chain (warning C7515);
3. kernel vs plain: both fused sampler kernels, the tensor-core
   ``gen_tc_kernel`` (the default model's route) and the CUDA-core
   ``fused_generate_kernel`` (forced), against their plain PyTorch version
   on the card at the default model width (V=80, E=128, H=256, latent 128,
   1 condition, 2 layers), at every serving tier B = 256, 2048, 8192, L=64,
   f32 and bf16, greedy, stochastic (T=0.8) and truncated (top-k=6 /
   top-p=0.8, T=0.8): tokens agree on >= 99.0% of first tokens and >= 97.0%
   of rows; the first step's scaled logits agree within 1e-4 (f32) / 1e-2
   (bf16) absolute; truncated first tokens lie in the plain version's kept
   set; rows emit only pad after EOS; moving seed blocks to other batch
   positions, or running a block alone at B=256, leaves their tokens
   bitwise unchanged;
4. the slice: a random-init checkpoint is served by the port's HTTP server
   (tiers 256,2048,8192, max_length 64, f32) and answers health, stochastic,
   repeated-seed, greedy, multi-pass and malformed requests; the sampler
   launch counters, reset just before, must show tensor-core launches and
   no CUDA-core one, and /health names the fused sampler. A V=600
   checkpoint, which the sampler kernels refuse, is then served through the
   scan sampler (as the JAX server serves it): /health says "scan", same-seed
   requests repeat, no sampler launch. An H=48 checkpoint, which the
   tensor-core kernel refuses, is served through the CUDA-core kernel
   (routed by config, before any launch);
5. times: the tensor-core and CUDA-core sampler kernels in turns, in mols/s,
   at B = 256, 2048, 8192 (L=64, T=0.8, f32 and bf16), and the plain version
   (every f32 tier, bf16 at B=8192), CUDA events after a warm-up; one B=8192
   f32 pass under ``torch.profiler`` (kernel name and device time);
6. train kernels vs plain: the fused encoder's and the fused training
   decoder's forward and backward kernels (both decoder specializations:
   CE and logits) against their plain PyTorch versions at the default
   model, L=64, B=4096, 2053, 2052, 1000, 64 and 34 (the bench batch, phase
   12's eval batches, a ragged one, its monitor batch and its trailing
   train batch), f32 and bf16; each backward kernel gets
   the plain forward's residuals, as its plain twin does. Teacher forcing
   all on: every output and gradient leaf within max |kernel - plain| /
   max |plain| <= 1e-4 (f32; the two sum in different orders) or 2e-2
   (bf16; one ulp of a bf16 rounding is ~4e-3 of the value). In bf16 the
   encoder forward (the tensor-core step kernel, layer by layer) runs twice
   and must repeat bit for bit, and its backward also runs on the kernel
   forward's residuals against its plain version on the same residuals.
   The encoder backward's reverse chain is also held alone (dgates, dx0)
   against ``encoder_reverse_reference``, in both dtypes, and in bf16 (the
   tensor-core chain) a second backward must equal the first bit for bit.
   In bf16 the decoder forward (n*L tensor-core step launches and L
   ``dec_head_kernel`` launches) must repeat bit for bit, and each head
   launch alone, on the plain forward's residuals, is held against
   ``decoder_head_step_reference`` (CE or logits within 2e-2, next tokens
   on >= 99.0% of rows). The decoder backward's reverse alone (bf16: the
   head pass over all L*B rows and the tensor-core chain; f32:
   ``dec_bwd_kernel``) is held against ``decoder_reverse_steps_reference``
   (dgates, dx0, dlog, d(h_init), d(cond)); in bf16 a second backward must
   equal the first bit for bit, the head pass alone (targets -1, V and 999
   mixed in) is held against ``decoder_head_bwd_reference`` within 1e-4,
   and the backward also runs on the kernel forward's residuals. Teacher
   forcing 0.9: the fed-token rows agree on >= 97.0% and the first
   argmax-fed step on >= 99.0% (an argmax can flip where two logits tie).
   Teacher forcing 0 (the eval passes): the logits forward's kernel against
   its plain version fed the kernel's own argmax tokens by full teacher
   forcing (so a flip near a tie does not part the two paths), every output
   within the tolerances above, and in bf16 the bitwise repeat and
   head-alone checks;
7. the train slice: ``train_step`` at full width (default model, bf16,
   B=4096, L=64, fused route) takes 8 steps on a fixed synthetic batch; the
   losses stay finite, the total loss at step 8 is below step 1, and the
   four train-kernel launch counters, reset just before, have risen. One
   step on the fused route is held against the plain route
   (``use_pallas=False``, the scan path with autograd) on the same params
   and noise, in f32 and bf16: the 9 loss scalars, ``grad_norm`` and the
   post-Adam params;
8. train times: each train kernel against its plain version and, for the
   encoder pair, against cuDNN's two-layer ``torch.nn.LSTM`` at the same
   widths (the yardstick only), and the whole step on the fused route
   against the plain route, at B=4096, L=64, bf16 (CUDA events after a
   warm-up), with tokens/s; each reverse chain's mean step-kernel launch
   per layer (``torch.profiler``); one fused step under ``torch.profiler``:
   device time by kernel name and the device's idle share (against the
   profiled wall time and against the wall time of unprofiled calls, since
   the profiler adds host time to every launch); the bf16 step must
   show the tensor-core forward step kernel (``seq_fwd_step_kernel``) and
   the decoder's vocab head (``dec_head_kernel``) and no CUDA-core forward
   (``seq_fwd_kernel``, ``enc_fwd_kernel``, ``dec_fwd_kernel``), and the
   tensor-core reverse step kernels of the encoder (``enc_step_kernel``)
   and of the decoder (``dec_step_kernel``) and no ``enc_bwd_kernel`` or
   ``dec_bwd_kernel``;
9. scaled kernels vs plain: the per-layer sequence LSTM forward and backward
   (I=128, 129 (the scaled decoder's layer 0) and 1024, H=1024, B=2048,
   L=64, f32 and bf16, each backward also over residuals and inputs
   addressed inside layer-stacked arrays, and a second bf16 backward
   bitwise equal to the first; the bf16 forward, the tensor-core step
   kernel, also repeated bit for bit and with its input and residuals at
   rows 2t + 1 of layer-stacked arrays, bitwise equal to the dense call), the
   fused training decoder's logits specialization at the scaled model
   (H=1024, 4 layers, B=2048, L=64, f32 and bf16, teacher forcing 1.0 and
   0.9; in bf16 also phase 6's bitwise repeat and head-alone checks) and
   the LSTM gate pair at [4096, 1024], [2048, 4096] and [4096, 256] (f32),
   each against its plain version, with phase 6's tolerances and
   agreement floors;
10. the scaled slice: ``train_step`` at hidden 1024 / 4 layers / latent 512,
   bf16, B=2048, L=64, fused route (the per-layer one at this size) for 4
   steps: losses finite, the last below the first, and per step 4
   sequence-forward, 8 sequence-backward and 1 decoder logits-forward
   launches and none of the whole-stack kernels. One scaled step, and one
   default-model ``reference_zero_state`` step (whose decoder scan runs the
   gate kernel pair L*n times each way), are held against the plain route
   in f32 and bf16 as in phase 7;
11. scaled times: each new kernel against its plain version and, for the
   sequence LSTM, against cuDNN's one-layer ``torch.nn.LSTM`` (forward;
   backward alone) and for the gate pair against PyTorch's fused LSTM cell
   (``aten::_thnn_fused_lstm_cell``: the median device time of 200 launches
   of each, in turns, each queued behind a 128 MB write that evicts the L2
   and a spin kernel, so that every input comes from device memory and the
   host's launch time stays outside its events;
   ``mlx_vae_tpu_torch/bench_gates.py:median_ms``); the whole-stack kernels at the scaled
   shape through their ``launch_*`` functions (the route check); the
   scaled step on the fused route against the plain route, in tokens/s;
   and one scaled fused step under ``torch.profiler`` (as in phase 8, with
   the same check of the forward kernels' names);
12. the train CLI: the port's ``data.prepare``, ``cli.train`` and
   ``cli.generate`` run in this process (``main(argv)``). A 20,523-molecule
   synthetic corpus (split 16,418 / 2,052 / 2,053: four train batches of
   4096 and one of 34 rows; eval batches of 2052 and 2053 rows; the 64-row
   monitor batch; the native packer must build) trains for two epochs at
   the default model's width, bf16, ``--use_pallas``, with ``--eval_test``:
   the history has 2 finite epochs, ``train_recon`` falls, the epoch and
   best checkpoints exist, and the four train-kernel counters, reset just
   before, rose (printed per epoch). ``--resume --epochs 3`` then runs epoch
   index 2 alone under ``--profile``: its trace must show the tensor-core
   forward, head and reverse step kernels and none of the CUDA-core ones
   (phase 8's check), and gives the device's idle share over the epoch. The
   f32 train CLI on a 3,000-molecule corpus, B=256, one epoch, fused route
   against plain route from the same seed: every history value within
   ``CLI_F32_RTOL`` relative. ``cli.generate --data`` serves the trained
   checkpoint (8192 molecules, L=64) on the tensor-core sampler (its
   counter rose) and prints novelty. A 2,000-molecule drug-like SELFIES
   corpus trains for one bf16 epoch at B=256; its checkpoint carries the
   alphabet, and ``cli.generate`` on it prints validity and molecule-level
   metrics. The f32 fused run must launch all four train kernels (their
   counters reset just before) and the plain run none. Printed: epoch 2's
   train pass per batch beside phase 8's step time, the trainer's
   throughput line, the idle share, and the async checkpoint (the default)
   against ``--sync_checkpoint``: three epochs each with a save every
   epoch, in turns async, sync, sync, async, the wall time from the first
   epoch's start to the last save's end, each train pass, and the main
   thread's seconds in ``save_checkpoint``.

``--sweep`` times the tensor-core kernel with each cluster size forced and
the CUDA-core kernel with each rows-per-thread instance forced (1, 2, 4, 8)
at B = 256, 1024, 2048, 8192, L=64, T=0.8, f32 and bf16: three repeats of 5
launches each after a warm-up, CUDA events. It is the measurement behind
``ops/fused_decoder.py:tc_cluster_size`` and ``_tile_rows``.

Any failed check raises, so the script exits non-zero before the last line.
The last line is ``{"ok": true, "device": {...}}``; the line before it is
the per-kernel JSON record (each kernel's launches on its main path, its
largest error against the plain version, its time, the plain version's,
the library call's where one computes the same function, and its bound:
the larger of its operations over the card's peak for their type and its
bytes, each input read once and each output written once, over 3.35 TB/s).
Without CUDA the script exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import torch

TRAIN_KERNELS = ("fused_encoder_fwd", "fused_encoder_bwd", "fused_train_decoder_fwd",
                 "fused_train_decoder_bwd")
# max |kernel - plain| / max |plain| per output or gradient leaf
TRAIN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# dec_head_kernel alone against its twin: the same rounded operands, f32 sums
HEAD_TOL = 1e-4
# the bench batch, phase 12's eval batches, a ragged one, phase 12's monitor
# batch and its trailing train batch
TRAIN_BATCHES = (4096, 2053, 2052, 1000, 64, 34)
AGREE_FIRST = 0.99  # share of first tokens that must agree, kernel vs plain
AGREE_ROWS = 0.97   # share of whole rows that must agree
# |kernel - plain| of the first step's scaled logits; in bf16 an f32
# difference of one ulp can move an operand's rounding by one bf16 step
LOGIT_ATOL = {"float32": 1e-4, "bfloat16": 1e-2}
TIERS = (256, 2048, 8192)
# NVIDIA's published H100 SXM peaks (dense): bf16 tensor cores, f32 outside
# the tensor cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_TF32 = 495e12  # tensor cores, TF32 (dense): the f32 sampler's split-TF32 route
PEAK_BYTES = 3.35e12
SCALED = dict(hidden_dim=1024, num_layers=4, latent_dim=512)
SB, SL = 2048, 64  # the scaled batch and length


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


def phase_kernel_vs_plain() -> dict:
    """Both sampler kernels (the tensor-core route and the CUDA-core kernel,
    forced) against the plain version. Returns {kernel: (largest |kernel -
    plain| first-step logit, largest share of rows that differed)}."""
    from mlx_vae_tpu_torch.ops.fused_decoder import (
        fused_generate, fused_generate_reference, prepare_weights)
    from mlx_vae_tpu_torch.ops.sampling import truncate_logits_bisect

    L = 64
    worst = {"tc": [0.0, 0.0], "cuda_core": [0.0, 0.0]}
    modes = (("greedy", 1.0, {"greedy": True}), ("T=0.8", 0.8, {}),
             ("top_k=6 top_p=0.8", 0.8, {"top_k": 6, "top_p": 0.8}))
    for dtype in ("float32", "bfloat16"):
        cfg, params = default_model(dtype)
        w = prepare_weights(params, cfg, "cuda")
        for B in TIERS:
            for mode, temp, kw in modes:
                h0, cond, seeds, temps = inputs(cfg, params, B, temp, seed=7)
                lp = torch.empty((B, cfg.vocab_size), device="cuda")
                p = fused_generate_reference(w, h0, cond, seeds, temps, L, logits_out=lp, **kw)
                torch.cuda.synchronize()
                for kernel in ("tc", "cuda_core"):
                    lk = torch.empty_like(lp)
                    k = fused_generate(w, h0, cond, seeds, temps, L, logits_out=lk,
                                       kernel=kernel, **kw)
                    torch.cuda.synchronize()
                    first, rows = agreement(k, p)
                    err = (lk - lp).abs().max().item()
                    worst[kernel] = [max(worst[kernel][0], err),
                                     max(worst[kernel][1], 1.0 - rows)]
                    line = (f"  {kernel} {dtype} B={B} {mode}: first tokens {first:.4%}, rows "
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
                        raise AssertionError(f"{kernel} {dtype} B={B} {mode}: agreement below "
                                             f"{AGREE_FIRST:.0%} / {AGREE_ROWS:.0%}")
                    if not err <= LOGIT_ATOL[dtype]:
                        raise AssertionError(f"{kernel} {dtype} B={B} {mode}: logits differ by "
                                             f"{err} > {LOGIT_ATOL[dtype]}")
                    if not ((k >= 0) & (k < cfg.vocab_size)).all():
                        raise AssertionError("token id out of range")
                    check_eos(k, cfg)
                    if mode == "T=0.8" and B > 256:
                        check_seed_blocks(w, h0, cond, seeds, temps, k, kernel, f"{dtype} B={B}")
    log("  EOS rows emit only pad after EOS: ok")
    return {k: tuple(v) for k, v in worst.items()}


def check_seed_blocks(w, h0, cond, seeds, temps, k, kernel: str, what: str) -> None:
    """Seed blocks keep their tokens bit for bit when moved to other batch
    positions (all reversed) and when run alone at B=256 (its first, middle
    and last block)."""
    from mlx_vae_tpu_torch.ops.fused_decoder import fused_generate

    bb, L = 256, k.shape[1]
    nb = h0.shape[0] // bb
    perm = torch.arange(nb - 1, -1, -1, device="cuda")
    moved = (perm[:, None] * bb + torch.arange(bb, device="cuda")).reshape(-1)
    kp = fused_generate(w, h0[moved].contiguous(), cond[moved].contiguous(),
                        seeds[perm].contiguous(), temps[perm].contiguous(), L, kernel=kernel)
    torch.cuda.synchronize()
    if not torch.equal(kp, k[moved]):
        raise AssertionError(f"{kernel} {what}: seed-block tokens changed with batch position")
    for blk in (0, nb // 2, nb - 1):
        rows = slice(bb * blk, bb * (blk + 1))
        alone = fused_generate(w, h0[rows].contiguous(), cond[rows].contiguous(),
                               seeds[blk:blk + 1].contiguous(), temps[blk:blk + 1].contiguous(),
                               L, kernel=kernel)
        torch.cuda.synchronize()
        if not torch.equal(alone, k[rows]):
            raise AssertionError(f"{kernel} {what}: seed block {blk} alone at B=256 gave other "
                                 f"tokens")
    log(f"  {kernel} {what}: {nb} seed blocks reversed in the batch, and blocks 0, {nb // 2}, "
        f"{nb - 1} alone at B=256 -> tokens bitwise unchanged")


def post(base, payload, path="/generate"):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def phase_slice(tmp: str) -> int:
    """Serve a random-init checkpoint; returns the tensor-core sampler
    launches the requests made (they must make no CUDA-core launch)."""
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
        # count only the main path's launches
        fused_generate.launches = fused_generate.tc_launches = fused_generate.core_launches = 0
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
        if (health["status"] != "ok" or health["batch_tiers"] != [256, 2048, 8192]
                or health["sampler"] != "fused"):
            raise AssertionError(f"bad /health: {health}")
        log(f"  /health: backend={health['backend']} device={health['device']} "
            f"tiers={health['batch_tiers']} warm={health['warmup']['complete']} "
            f"sampler={health['sampler']}")
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
        launches = fused_generate.tc_launches
        if launches < 1 or fused_generate.core_launches or launches != fused_generate.launches:
            raise AssertionError(f"the served requests launched {launches} tensor-core and "
                                 f"{fused_generate.core_launches} CUDA-core sampler kernels: the "
                                 f"default config must take the tensor-core route only")
        log(f"  sampler launches during the requests: {launches} tensor-core "
            f"(gen_tc_kernel), 0 CUDA-core")

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


def phase_scan_served(tmp: str) -> None:
    """A checkpoint the fused sampler refuses (V = 600) is served on the
    card through the scan sampler, as the JAX server serves it: /health
    names the sampler, requests return tokens and the sampler kernel is not
    launched."""
    import numpy as np

    from mlx_vae_tpu_torch.cli.serve import build_parser, serve_forever
    from mlx_vae_tpu_torch.config import ModelConfig
    from mlx_vae_tpu_torch.models.decoder import init_decoder_params
    from mlx_vae_tpu_torch.ops.fused_decoder import fused_generate
    from mlx_vae_tpu_torch.train.checkpoint import build_checkpoint_host, write_checkpoint

    cfg = ModelConfig(vocab_size=600)
    ck = f"{tmp}/checkpoint_v600.npz"
    dec = init_decoder_params(torch.Generator().manual_seed(5), cfg)
    write_checkpoint(ck, build_checkpoint_host(
        0, {"encoder": {}, "decoder": dec}, {"encoder": {}, "decoder": {}}, {}))
    args = build_parser().parse_args([
        "--checkpoint", ck, "--port", "0", "--batch_sizes", "256", "--max_length", "64",
        "--no_normalize", "--device", "cuda"])
    ready = threading.Event()
    thread = threading.Thread(target=serve_forever, args=(args, ready), daemon=True)
    thread.start()
    if not ready.wait(timeout=300):
        raise AssertionError("server did not come up")
    base = f"http://127.0.0.1:{ready.server.server_address[1]}"
    try:
        before = fused_generate.launches
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
        if health["sampler"] != "scan" or health["model"]["vocab_size"] != 600:
            raise AssertionError(f"bad /health for the V=600 model: {health}")
        req = {"num_molecules": 300, "target": [0.0], "temperature": 0.8, "seed": 3,
               "return_tokens": True}
        _, a = post(base, req)
        _, b = post(base, req)
        toks = np.asarray(a["tokens"])
        if toks.shape != (300, 64) or toks.min() < 0 or toks.max() >= 600:
            raise AssertionError(f"V=600: bad token matrix {toks.shape}")
        if a["tokens"] != b["tokens"] or fused_generate.launches != before:
            raise AssertionError("V=600: tokens differ between same-seed requests, or the "
                                 "sampler kernel was launched")
        log(f"  V=600 checkpoint: /health sampler={health['sampler']}; 300 molecules in "
            f"{a['passes']} passes at {a['mols_per_sec']:.1f} mols/s, same seed -> same "
            f"tokens, sampler kernel launches 0")
    finally:
        ready.server.shutdown()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("server thread did not stop")


def phase_core_served(tmp: str) -> int:
    """A checkpoint the tensor-core sampler refuses (H = 48: no cluster size
    fits) is served on the card through the CUDA-core kernel, by config
    before any launch. Returns its CUDA-core launches."""
    import numpy as np

    from mlx_vae_tpu_torch.cli.serve import build_parser, serve_forever
    from mlx_vae_tpu_torch.config import ModelConfig
    from mlx_vae_tpu_torch.models.decoder import init_decoder_params
    from mlx_vae_tpu_torch.ops.fused_decoder import fused_generate, fused_generate_route
    from mlx_vae_tpu_torch.train.checkpoint import build_checkpoint_host, write_checkpoint

    cfg = ModelConfig(hidden_dim=48)
    if fused_generate_route(cfg) != "cuda_core":
        raise AssertionError("H=48 should take the CUDA-core sampler")
    ck = f"{tmp}/checkpoint_h48.npz"
    dec = init_decoder_params(torch.Generator().manual_seed(6), cfg)
    write_checkpoint(ck, build_checkpoint_host(
        0, {"encoder": {}, "decoder": dec}, {"encoder": {}, "decoder": {}}, {}))
    args = build_parser().parse_args([
        "--checkpoint", ck, "--port", "0", "--batch_sizes", "256", "--max_length", "64",
        "--no_normalize", "--device", "cuda"])
    ready = threading.Event()
    thread = threading.Thread(target=serve_forever, args=(args, ready), daemon=True)
    thread.start()
    if not ready.wait(timeout=300):
        raise AssertionError("server did not come up")
    base = f"http://127.0.0.1:{ready.server.server_address[1]}"
    try:
        fused_generate.launches = fused_generate.tc_launches = fused_generate.core_launches = 0
        req = {"num_molecules": 300, "target": [0.0], "temperature": 0.8, "seed": 4,
               "return_tokens": True}
        _, a = post(base, req)
        _, b = post(base, req)
        toks = np.asarray(a["tokens"])
        if toks.shape != (300, 64) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"H=48: bad token matrix {toks.shape}")
        core = fused_generate.core_launches
        if a["tokens"] != b["tokens"] or core < 1 or fused_generate.tc_launches:
            raise AssertionError(f"H=48: same-seed tokens differ, or the route launched "
                                 f"{core} CUDA-core / {fused_generate.tc_launches} tensor-core "
                                 f"kernels")
        log(f"  H=48 checkpoint: 300 molecules in {a['passes']} passes at "
            f"{a['mols_per_sec']:.1f} mols/s through the CUDA-core sampler ({core} launches, "
            f"0 tensor-core), same seed -> same tokens")
    finally:
        ready.server.shutdown()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("server thread did not stop")
    return core


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


GATE_SAMPLES = 200  # launches of each call behind row 9's median


def profile_step(what: str, fn, smi: str) -> dict:
    """One call of ``fn`` under ``torch.profiler`` after a warm-up call: the
    device time of each kernel by name, and the device's idle share (1 -
    the summed device time over the call's wall time on CUDA events; the
    port runs on one stream, so its kernels do not overlap), both against
    the profiled call's wall time and against the mean of three calls
    without the profiler (which adds host time to every launch)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0][:80]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    if not by_name:
        log(f"  profile, {what}: the profiler recorded no device time [{smi}]")
        return {"wall_ms": wall, "device_ms": None, "idle_share": None, "kernels": {}}
    plain_wall = time_ms(fn, 3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    log(f"  profile, {what}: {wall:.3f} ms wall, {busy:.3f} ms of device time, idle share "
        f"{max(0.0, 1 - busy / wall):.4f}; without the profiler {plain_wall:.3f} ms wall, "
        f"idle share {max(0.0, 1 - busy / plain_wall):.4f} [{smi}]")
    for name, ms in top[:12]:
        log(f"    {ms:10.3f} ms {ms / busy:7.2%}  {name}")
    return {"wall_ms": wall, "device_ms": busy, "idle_share": max(0.0, 1 - busy / wall),
            "plain_wall_ms": plain_wall, "kernels": dict(top)}


def chain_layer_us(fn, kernel: str, n: int) -> list:
    """Mean device us of a reverse chain's step-kernel launches per layer in
    one call of ``fn`` under ``torch.profiler``, after a warm-up call: the
    chain launches top down, so its launch i runs layer n - 1 - i % n."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and re.search(rf"\b{kernel}\b", e.name)), key=lambda e: e.time_range.start)
    us = [[] for _ in range(n)]
    for i, e in enumerate(evs):
        us[n - 1 - i % n].append(e.time_range.elapsed_us())
    return [sum(u) / max(len(u), 1) for u in us]


def check_kernels(prof: dict, what: str, role: str, step: str, old: tuple) -> None:
    """A bf16 step's profile must show the tensor-core kernel ``step`` and
    none of the CUDA-core kernels ``old`` that it replaced."""
    import re

    names = list(prof["kernels"])
    new = [n for n in names if re.search(rf"\b{step}\b", n)]
    gone = [n for n in names if re.search(rf"\b({'|'.join(old)})\b", n)]
    if not new or gone:
        raise AssertionError(f"{what}: {role} kernels in the profile: tensor-core {new}, "
                             f"CUDA-core {gone}")
    log(f"  {what}: the {role} ran as {new[0]} ({prof['kernels'][new[0]]:.3f} ms), no "
        f"{' or '.join(old)}")


def check_forward_kernels(prof: dict, what: str) -> None:
    """A bf16 step's forwards run on the tensor-core step kernel, and the
    decoder's vocab projection on dec_head_kernel: no CUDA-core forward."""
    old = ("seq_fwd_kernel", "enc_fwd_kernel", "dec_fwd_kernel")
    check_kernels(prof, what, "forwards", "seq_fwd_step_kernel", old)
    check_kernels(prof, what, "decoder's vocab head", "dec_head_kernel", old)


def phase_times(smi: str) -> dict:
    """Both sampler kernels in turns (CUDA-core, tensor-core, tensor-core,
    CUDA-core) at every tier, f32 and bf16, L=64, T=0.8, and the plain
    version at B=8192 (and every f32 tier); one B=8192 f32 tensor-core pass
    under torch.profiler. Returns {(dtype, B): (tc ms, CUDA-core ms, plain ms
    or None)} and the profile."""
    from mlx_vae_tpu_torch.ops.fused_decoder import (
        fused_generate, fused_generate_reference, prepare_weights)

    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg, params = default_model(dtype)
        w = prepare_weights(params, cfg, "cuda")
        for B in TIERS:
            h0, cond, seeds, temps = inputs(cfg, params, B, 0.8, seed=3)
            run = lambda kernel: fused_generate(w, h0, cond, seeds, temps, 64,  # noqa: E731
                                                kernel=kernel)
            t_ms, c_ms = turns(f"sampler {dtype} B={B} L=64 T=0.8", lambda: run("tc"),
                               lambda: run("cuda_core"), smi, 10, 10, names=("tensor-core",
                                                                              "CUDA-core"))
            p_ms = None
            if dtype == "float32" or B == 8192:
                p_ms = time_ms(lambda: fused_generate_reference(w, h0, cond, seeds, temps, 64), 3)
            out[(dtype, B)] = (t_ms, c_ms, p_ms)
            log(f"  {dtype} B={B}: tensor-core {B / t_ms * 1e3:,.0f} mols/s, CUDA-core "
                f"{B / c_ms * 1e3:,.0f} mols/s ({c_ms / t_ms:.2f}x)"
                + (f", plain {p_ms:.3f} ms ({B / p_ms * 1e3:,.0f} mols/s)" if p_ms else "")
                + f" [{smi}]")
            if dtype == "float32" and B == 8192:
                out["profile"] = profile_step("one B=8192 f32 sampler pass", lambda: run("tc"),
                                              smi)
                if not any("gen_tc_kernel" in k for k in out["profile"]["kernels"]):
                    raise AssertionError("the profile shows no gen_tc_kernel")
    return out


def phase_sweep(smi: str) -> list:
    """Sampler ms with each tensor-core cluster size and each CUDA-core
    rows-per-thread instance forced."""
    from mlx_vae_tpu_torch.ops.fused_decoder import (fused_generate, prepare_weights,
                                                     tc_cluster_size, tc_clusters)
    from mlx_vae_tpu_torch.ops.train_common import RPTS

    out = []
    for dtype in ("float32", "bfloat16"):
        cfg, params = default_model(dtype)
        w = prepare_weights(params, cfg, "cuda")
        for B in (256, 1024, 2048, 8192):
            h0, cond, seeds, temps = inputs(cfg, params, B, 0.8, seed=3)
            cells = []
            forced = ([("tc", "cluster", S) for S in tc_clusters(cfg)]
                      + [("cuda_core", "rows_per_thread", r) for r in sorted(RPTS)])
            for kernel, arg, v in forced:
                reps = [time_ms(lambda: fused_generate(w, h0, cond, seeds, temps, 64,
                                                       kernel=kernel, **{arg: v}), 5)
                        for _ in range(3)]
                out.append({"dtype": dtype, "B": B, "kernel": kernel, arg: v, "ms": reps})
                cells.append(f"{'S' if kernel == 'tc' else 'R'}={v} {min(reps):.3f}-"
                             f"{max(reps):.3f}")
            log(f"  {dtype} B={B} L=64 T=0.8 ms (3 repeats of 5), tensor-core S (rule: "
                f"{tc_cluster_size(cfg)}) and CUDA-core R: {'; '.join(cells)} [{smi}]")
    return out


SOURCES = ("fused_generate", "fused_encoder", "fused_train_decoder", "fused_seq_lstm",
           "fused_lstm_gates")


def build_all() -> None:
    """One nvcc per CUDA source, all started together, then load each."""
    from mlx_vae_tpu_torch.ops import (fused_decoder, fused_encoder, fused_lstm,
                                       fused_seq_lstm, fused_train_decoder)
    from mlx_vae_tpu_torch.ops.build import compile_sources

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        compile_sources(SOURCES, verbose=True)
    log(out.getvalue().rstrip())
    if "C7515" in out.getvalue():  # ptxas serialized a wgmma chain
        raise AssertionError("ptxas serialized wgmma (C7515): see the build log above")
    for mod in (fused_decoder, fused_encoder, fused_train_decoder, fused_seq_lstm, fused_lstm):
        mod.build_library()


TRAIN_SOURCES = {
    "fused_encoder_fwd": "mlx_vae_tpu_torch/csrc/fused_encoder.cu",
    "fused_encoder_bwd": "mlx_vae_tpu_torch/csrc/fused_encoder.cu",
    "fused_train_decoder_fwd": "mlx_vae_tpu_torch/csrc/fused_train_decoder.cu",
    "fused_train_decoder_bwd": "mlx_vae_tpu_torch/csrc/fused_train_decoder.cu",
}
# the bf16 decoder forward is two kernels of csrc: the step kernel and the head
DEC_FWD_NOTE = ("; bf16: n*L launches of train_common.cuh:seq_fwd_step_kernel and L of "
                "fused_train_decoder.cu:dec_head_kernel, also each dec_head_kernel launch "
                "alone against decoder_head_step_reference, each step's CE term or logits "
                "within 1e-4, with targets outside [0, V); teacher forcing 0: the logits "
                "forward against its plain version fed the kernel's own argmax tokens")
# the bf16 decoder backward: the head pass and the chain's step kernel
DEC_BWD_NOTE = ("; bf16: fused_train_decoder.cu:dec_head_bwd_kernel and dec_dtop_kernel "
                "over all L*B rows, then train_common.cuh:gate_kernel and n*L launches of "
                "fused_train_decoder.cu:dec_step_kernel; also the reverse alone against "
                "decoder_reverse_steps_reference (dgates, dx0, dlog, dh_init, dcond) and the "
                "head pass alone against decoder_head_bwd_reference within 1e-4, with targets "
                "outside [0, V)")
TRAIN_NOTES = {"fused_train_decoder_fwd": DEC_FWD_NOTE, "fused_train_decoder_bwd": DEC_BWD_NOTE}
TRAIN_REPLACES = {
    "fused_encoder_fwd": "mlx_vae_tpu/ops/pallas_encoder.py:119",
    "fused_encoder_bwd": "mlx_vae_tpu/ops/pallas_encoder.py:165",
    "fused_train_decoder_fwd": "mlx_vae_tpu/ops/pallas_train_decoder.py:136",
    "fused_train_decoder_bwd": "mlx_vae_tpu/ops/pallas_train_decoder.py:375",
}


def train_model(dtype: str, seed: int = 0):
    from mlx_vae_tpu_torch.bench import init_train_params
    from mlx_vae_tpu_torch.config import ModelConfig

    cfg = ModelConfig(compute_dtype=dtype, use_pallas=True)
    return cfg, init_train_params(cfg, "cuda", seed)


def train_inputs(cfg, B: int, L: int, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (B, L), generator=g, device="cuda",
                        dtype=torch.int32)
    cond = torch.randn((B, cfg.num_conditions), generator=g, device="cuda")
    h0 = 0.5 * torch.randn((B, cfg.hidden_dim), generator=g, device="cuda")
    return tok, cond, h0, g


def compare(what: str, got, want, dtype: str, worst: list, tol: float = None) -> None:
    """Hold each leaf of ``got`` against ``want``: max |diff| / max |plain|
    within ``tol`` (default TRAIN_TOL[dtype]); ``worst`` keeps (max abs, max
    rel)."""
    tol = TRAIN_TOL[dtype] if tol is None else tol
    line = []
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.float(), b.float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{what}: leaf {i} of the kernel is not finite")
        diff = (a - b).abs().max().item()
        rel = diff / max(b.abs().max().item(), 1e-30)
        worst[0], worst[1] = max(worst[0], diff), max(worst[1], rel)
        line.append(f"{rel:.2e}")
        if not rel <= tol:
            raise AssertionError(f"{what}: leaf {i} differs by {diff:.3e} "
                                 f"(rel {rel:.3e} > {tol})")
    log(f"  {what}: max|diff|/max|plain| per leaf [{', '.join(line)}]")


def phase_train_kernels() -> dict:
    """Returns {kernel: (largest abs diff, largest rel diff)} over every run."""
    from mlx_vae_tpu_torch.ops import fused_encoder as fe
    from mlx_vae_tpu_torch.ops import fused_train_decoder as fd
    from mlx_vae_tpu_torch.ops import train_common as tc

    L = 64
    worst = {k: [0.0, 0.0] for k in TRAIN_KERNELS}
    for dtype in ("float32", "bfloat16"):
        cfg, params = train_model(dtype)
        we = tc.prepare_stack_weights(params["encoder"], cfg, with_head=False)
        wd = tc.prepare_stack_weights(params["decoder"], cfg, with_head=True)
        for B in TRAIN_BATCHES:
            tag = f"{dtype} B={B}"
            tok, cond, h0, g = train_inputs(cfg, B, L, seed=B)
            k = fe.encoder_fwd(we, tok)
            p = fe.encoder_fwd_reference(we, tok)
            torch.cuda.synchronize()
            compare(f"{tag} encoder fwd [h_last, hs, cs, gs]", k, p, dtype,
                    worst["fused_encoder_fwd"])
            dh = torch.randn((B, cfg.hidden_dim), generator=g, device="cuda")
            kb = fe.encoder_bwd(we, tok, dh, *p[1:])
            pb = fe.encoder_bwd_reference(we, tok, dh, *p[1:])
            torch.cuda.synchronize()
            compare(f"{tag} encoder bwd [dW.., db, demb]", [*kb[0], *kb[1:]],
                    [*pb[0], *pb[1:]], dtype, worst["fused_encoder_bwd"])
            # the reverse chain alone (bf16: the tensor-core chain; f32: enc_bwd_kernel)
            le, st = fe.build_library(), torch.cuda.current_stream().cuda_stream
            kr = fe.launch_encoder_bwd(le, we, tok, dh, *p[1:], st, with_reverse=True)
            pr = fe.encoder_reverse_reference(we, dh, *p[1:])
            torch.cuda.synchronize()
            compare(f"{tag} encoder reverse alone [dgates, dx0]", kr[3:], pr, dtype,
                    worst["fused_encoder_bwd"])
            if dtype == "bfloat16":  # one writer per element, fixed-order sums
                again = fe.launch_encoder_bwd(le, we, tok, dh, *p[1:], st, with_reverse=True)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip([*kr[0], *kr[1:]],
                                                             [*again[0], *again[1:]])):
                    raise AssertionError(f"{tag} encoder bwd: two runs differ")
                log(f"  {tag} encoder bwd: a second run is bitwise equal (dW, db, demb, "
                    f"dgates, dx0)")
                del again
            del kr, pr
            if dtype == "bfloat16":
                again = fe.encoder_fwd(we, tok)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(k, again)):
                    raise AssertionError(f"{tag} encoder fwd: two runs differ")
                log(f"  {tag} encoder fwd: a second run is bitwise equal")
                # the backward on the tensor-core forward's own residuals
                kb = fe.encoder_bwd(we, tok, dh, *k[1:])
                pb = fe.encoder_bwd_reference(we, tok, dh, *k[1:])
                torch.cuda.synchronize()
                compare(f"{tag} encoder bwd on the kernel forward's residuals", [*kb[0], *kb[1:]],
                        [*pb[0], *pb[1:]], dtype, worst["fused_encoder_bwd"])
                del again
            del k, p, kb, pb
            tf_on = torch.ones((L,), dtype=torch.bool, device="cuda")
            for with_ce in (True, False):
                spec = "ce" if with_ce else "logits"
                k = fd.decoder_fwd(wd, h0, cond, tok, tf_on, with_ce)
                p = fd.decoder_fwd_reference(wd, h0, cond, tok, tf_on, with_ce)
                torch.cuda.synchronize()
                if not torch.equal(k[1], p[1]):
                    raise AssertionError(f"{tag} decoder fwd {spec}: fed tokens differ "
                                         f"under full teacher forcing")
                compare(f"{tag} decoder fwd {spec} [out, hs, cs, gs]", (k[0], *k[2:]),
                        (p[0], *p[2:]), dtype, worst["fused_train_decoder_fwd"])
                if dtype == "bfloat16":
                    check_decoder_chain(wd, h0, cond, tok, tf_on, with_ce, k, p, tag,
                                        worst["fused_train_decoder_fwd"])
                din = (torch.randn((B,), generator=g, device="cuda") if with_ce else
                       torch.randn((B, L, cfg.vocab_size), generator=g, device="cuda") / (B * L))
                kb = fd.decoder_bwd(wd, din, tok, p[1], h0, cond, *p[2:], with_ce)
                pb = fd.decoder_bwd_reference(wd, din, tok, p[1], h0, cond, *p[2:], with_ce)
                torch.cuda.synchronize()
                compare(f"{tag} decoder bwd {spec} [dW.., db, dwout, dbout, demb, "
                        f"dh_init, dcond]", [*kb[0], *kb[1:]], [*pb[0], *pb[1:]], dtype,
                        worst["fused_train_decoder_bwd"])
                del kb, pb
                check_decoder_reverse(wd, din, tok, h0, cond, k, p, with_ce, tag, dtype,
                                      worst["fused_train_decoder_bwd"])
                del k, p
            tf = torch.rand((L,), generator=g, device="cuda") < 0.9
            tf[3] = False  # at least one argmax-fed step
            k = fd.decoder_fwd(wd, h0, cond, tok, tf, True)
            p = fd.decoder_fwd_reference(wd, h0, cond, tok, tf, True)
            torch.cuda.synchronize()
            check_fed_tokens(f"{tag} decoder fwd ce, teacher forcing 0.9", k, p, tf)
            if dtype == "bfloat16":
                check_decoder_chain(wd, h0, cond, tok, tf, True, k, p, tag,
                                    worst["fused_train_decoder_fwd"])
            del k, p
            # teacher forcing 0, as in the eval passes: the plain version is fed
            # the kernel's own argmax tokens by full teacher forcing
            tf_off = torch.zeros((L,), dtype=torch.bool, device="cuda")
            k = fd.decoder_fwd(wd, h0, cond, tok, tf_off, False)
            fed = torch.cat([k[1][1:], tok.T[-1:]]).T.contiguous()  # fed[:, t] = k[1][t + 1]
            p = fd.decoder_fwd_reference(wd, h0, cond, fed, tf_on, False)
            torch.cuda.synchronize()
            if not torch.equal(k[1], p[1]):
                raise AssertionError(f"{tag} decoder fwd logits, teacher forcing 0: the plain "
                                     f"version was not fed the kernel's tokens")
            compare(f"{tag} decoder fwd logits, teacher forcing 0, plain fed the kernel's "
                    f"tokens [out, hs, cs, gs]", (k[0], *k[2:]), (p[0], *p[2:]), dtype,
                    worst["fused_train_decoder_fwd"])
            if dtype == "bfloat16":
                check_decoder_chain(wd, h0, cond, tok, tf_off, False, k, p, tag,
                                    worst["fused_train_decoder_fwd"])
            del k, p
    return {k: tuple(v) for k, v in worst.items()}


def check_fed_tokens(what: str, k, p, tf) -> None:
    """Fed tokens after the first argmax-fed step: >= AGREE_FIRST of the
    first such step and >= AGREE_ROWS of rows agree, kernel vs plain."""
    first = int(torch.nonzero(~tf)[0].item())
    first_ok, rows_ok = agreement(k[1].T[:, first + 1:], p[1].T[:, first + 1:])
    log(f"  {what}: fed-token rows agree {rows_ok:.4%}, first argmax-fed step "
        f"(t={first + 1}) {first_ok:.4%}")
    if first_ok < AGREE_FIRST or rows_ok < AGREE_ROWS:
        raise AssertionError(f"{what}: fed tokens agree below "
                             f"{AGREE_FIRST:.0%} / {AGREE_ROWS:.0%}")


def check_decoder_chain(w, h0, cond, tok, tf, with_ce: bool, k, p, tag: str,
                        worst: list) -> None:
    """The bf16 decoder forward's chain: a second call equals the first
    ``k`` bit for bit; and each step's ``dec_head_kernel`` alone, on the plain
    forward's residuals ``p``, against ``decoder_head_step_reference`` on the
    same inputs. Both read the same rounded operands, so each step's CE term
    (from zero) or logits is held within HEAD_TOL; the head alone is fed
    teacher forcing on even steps only, so that forced next tokens must equal
    the target and argmax-fed ones agree on >= AGREE_FIRST of rows a step."""
    from mlx_vae_tpu_torch.ops import fused_train_decoder as fd

    spec = "ce" if with_ce else "logits"
    again = fd.decoder_fwd(w, h0, cond, tok, tf, with_ce)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(k, again)):
        raise AssertionError(f"{tag} decoder fwd {spec}: two runs differ")
    del again
    lib, st = fd.build_library(), torch.cuda.current_stream().cuda_stream
    L = tok.shape[1]
    tf_head = torch.arange(L, device="cuda") % 2 == 0
    tgt = tok.clone()  # with targets outside [0, V), which add no CE term
    for j, bad in enumerate((-1, w.cfg.vocab_size, 999)):
        tgt[j::7, j::3] = bad
    k_out, p_out = torch.zeros_like(p[0]), torch.zeros_like(p[0])
    k_toks, p_toks = p[1].clone(), p[1].clone()
    k_terms, p_terms = [], []
    for t in range(L):
        if with_ce:  # each step's CE term alone
            k_out.zero_()
            p_out.zero_()
        fd.launch_decoder_head(lib, w, t, p[2], tgt, tf_head.to(torch.int32), k_toks, k_out,
                               with_ce, st)
        fd.decoder_head_step_reference(w, t, p[2], tgt, tf_head, p_toks, p_out, with_ce)
        if with_ce:
            k_terms.append(k_out.clone())
            p_terms.append(p_out.clone())
    torch.cuda.synchronize()
    if with_ce:
        k_out, p_out = torch.stack(k_terms), torch.stack(p_terms)
    # toks[t + 1]: forced for even t (odd rows), argmax-fed for odd t (even rows from 2)
    if not torch.equal(k_toks[1::2], p_toks[1::2]):
        raise AssertionError(f"{tag} dec_head_kernel: a forced next token is not the target")
    agree = (k_toks[2::2] == p_toks[2::2]).float().mean(dim=1).min().item()
    log(f"  {tag} decoder fwd {spec}: a second run is bitwise equal; dec_head_kernel alone "
        f"at all {L} steps: forced next tokens equal, argmax-fed ones agree on >= "
        f"{agree:.4%} of rows a step")
    compare(f"{tag} dec_head_kernel alone {spec} [out, each step]", [k_out], [p_out],
            "bfloat16", worst, tol=HEAD_TOL)
    if agree < AGREE_FIRST:
        raise AssertionError(f"{tag} dec_head_kernel: next tokens agree on {agree:.4%}")


def check_decoder_reverse(w, din, tok, h0, cond, k, p, with_ce: bool, tag: str, dtype: str,
                          worst: list) -> None:
    """The decoder backward's reverse alone (bf16: the head pass and the
    tensor-core chain; f32: ``dec_bwd_kernel``) on the plain forward's
    residuals ``p`` against ``decoder_reverse_steps_reference``, its plain
    twin launch by launch: dgates, dx0, dlog, d(h_init), d(cond). In bf16
    also: a second backward equals the first bit for bit; the head pass
    alone, with targets -1, V and 999 mixed in, against
    ``decoder_head_bwd_reference`` within HEAD_TOL (the same rounded
    operands, f32 sums); and the whole backward on the kernel forward's own
    residuals ``k`` against its plain version on the same residuals."""
    from mlx_vae_tpu_torch.ops import fused_train_decoder as fd

    spec = "ce" if with_ce else "logits"
    lib, st = fd.build_library(), torch.cuda.current_stream().cuda_stream

    def run():
        return fd.launch_decoder_bwd(lib, w, din, tok, p[1], h0, cond, *p[2:], with_ce, st,
                                     with_reverse=True)

    kr = run()
    pr = fd.decoder_reverse_steps_reference(w, din, tok, *p[2:], with_ce)
    torch.cuda.synchronize()
    compare(f"{tag} decoder reverse alone {spec} [dgates, dx0, dlog, dh_init, dcond]", kr[7:],
            pr, dtype, worst)
    del pr
    if dtype != "bfloat16":
        return
    again = run()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip([*kr[0], *kr[1:]], [*again[0], *again[1:]])):
        raise AssertionError(f"{tag} decoder bwd {spec}: two runs differ")
    log(f"  {tag} decoder bwd {spec}: a second run is bitwise equal (dW, db, dwout, dbout, "
        f"demb, dh_init, dcond, dgates, dx0, dlog)")
    del kr, again
    tgt = tok.clone()  # with targets outside [0, V), which add no one-hot
    for j, bad in enumerate((-1, w.cfg.vocab_size, 999)):
        tgt[j::7, j::3] = bad
    kh = fd.launch_decoder_head_bwd(lib, w, din, tgt, p[2], with_ce, st)
    ph = fd.decoder_head_bwd_reference(w, din, tgt, p[2], with_ce)
    torch.cuda.synchronize()
    compare(f"{tag} decoder head pass alone {spec}, targets -1/V/999 mixed in [dlog, dtop]",
            kh, ph, dtype, worst, tol=HEAD_TOL)
    del kh, ph
    kb = fd.decoder_bwd(w, din, tok, k[1], h0, cond, *k[2:], with_ce)
    pb = fd.decoder_bwd_reference(w, din, tok, k[1], h0, cond, *k[2:], with_ce)
    torch.cuda.synchronize()
    compare(f"{tag} decoder bwd {spec} on the kernel forward's residuals", [*kb[0], *kb[1:]],
            [*pb[0], *pb[1:]], dtype, worst)


def synthetic_batch(cfg, B: int, L: int):
    """Tokens [B, L] (pad 0 after EOS) and normalized TPSA [B, 1] from the
    repo's deterministic synthetic corpus, on the card."""
    import numpy as np

    from mlx_vae_tpu_torch.data.prepare import make_synthetic_dataset

    data = make_synthetic_dataset(n=B, vocab_size=cfg.vocab_size, max_length=L, seed=0)
    x = np.zeros((B, L), np.int32)
    for i, seq in enumerate(data["tokenized_sequences"]):
        x[i, :len(seq)] = seq[:L]
    tpsa = np.array([m["tpsa"] for m in data["molecules"]], np.float32)[:, None]
    cond = (tpsa - tpsa.mean()) / tpsa.std()
    return (torch.as_tensor(x, device="cuda"), torch.as_tensor(cond, device="cuda"))


def train_steps(cfg, params, x, cond, steps: int, counters: dict) -> dict:
    """``steps`` train steps on one batch with every launch count set to 0
    just before; checks that the losses stay finite and fall, and returns
    the counts."""
    import math

    from mlx_vae_tpu_torch.config import TrainConfig
    from mlx_vae_tpu_torch.train.optim import adam_init
    from mlx_vae_tpu_torch.train.steps import train_step

    B = x.shape[0]
    opt = {n: adam_init(p) for n, p in params.items()}
    gen = torch.Generator(device="cuda").manual_seed(2)
    reset_counts(counters)  # count only the main path's launches
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        _, _, m = train_step(params, opt, cfg, TrainConfig(batch_size=B), x, cond, gen, 0.05,
                             0.9)
        losses.append(m["total_loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(counters)
    losses = [float(v) for v in losses]
    log(f"  {steps} steps in {wall:.2f}s; total loss per step "
        f"{', '.join(f'{v:.4f}' for v in losses)}; last recon {float(m['recon_loss']):.4f}, "
        f"grad_norm {float(m['grad_norm']):.4f}")
    log(f"  launches during the {steps} steps: {counts}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("a loss is not finite")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"total loss did not fall: {losses[0]} -> {losses[-1]}")
    return counts


def phase_train_slice() -> dict:
    """Eight full-width bf16 steps through the kernels; returns the launch
    count of each train kernel in that run."""
    B, L = 4096, 64
    cfg, params = train_model("bfloat16")
    x, cond = synthetic_batch(cfg, B, L)
    counters = {k: v for k, v in kernel_counters().items() if k in TRAIN_KERNELS}
    launches = train_steps(cfg, params, x, cond, 8, counters)
    if min(launches.values()) < 1:
        raise AssertionError(f"a train kernel was never launched: {launches}")

    # one step, fused route against the plain route, same params and noise
    fused_vs_plain("default", lambda dt: train_model(dt, seed=3), x, cond, B, L)
    return launches


def phase_train_times(smi: str) -> dict:
    """{kernel: (kernel ms, plain ms)} and the whole step's times."""
    from mlx_vae_tpu_torch.config import TrainConfig
    from mlx_vae_tpu_torch.ops import fused_encoder as fe
    from mlx_vae_tpu_torch.ops import fused_train_decoder as fd
    from mlx_vae_tpu_torch.ops import train_common as tc
    from mlx_vae_tpu_torch.train.optim import adam_init
    from mlx_vae_tpu_torch.train.steps import train_step

    B, L = 4096, 64
    cfg, params = train_model("bfloat16")
    we = tc.prepare_stack_weights(params["encoder"], cfg, with_head=False)
    wd = tc.prepare_stack_weights(params["decoder"], cfg, with_head=True)
    tok, cond, h0, g = train_inputs(cfg, B, L, seed=5)
    tf = torch.rand((L,), generator=g, device="cuda") < 0.9
    enc = fe.encoder_fwd_reference(we, tok)
    dh = torch.randn((B, cfg.hidden_dim), generator=g, device="cuda")
    dec = fd.decoder_fwd_reference(wd, h0, cond, tok, tf, True)
    dce = torch.full((B,), 1.0 / (B * L), device="cuda")
    pairs = {
        "fused_encoder_fwd": (lambda: fe.encoder_fwd(we, tok),
                              lambda: fe.encoder_fwd_reference(we, tok)),
        "fused_encoder_bwd": (lambda: fe.encoder_bwd(we, tok, dh, *enc[1:]),
                              lambda: fe.encoder_bwd_reference(we, tok, dh, *enc[1:])),
        "fused_train_decoder_fwd": (
            lambda: fd.decoder_fwd(wd, h0, cond, tok, tf, True),
            lambda: fd.decoder_fwd_reference(wd, h0, cond, tok, tf, True)),
        "fused_train_decoder_bwd": (
            lambda: fd.decoder_bwd(wd, dce, tok, dec[1], h0, cond, *dec[2:], True),
            lambda: fd.decoder_bwd_reference(wd, dce, tok, dec[1], h0, cond, *dec[2:], True)),
    }
    out = {}
    for name, (kern, plain) in pairs.items():
        out[name] = turns(name, kern, plain, smi, 3, 2)
    # the reverse chains' launches by layer (the decoder's layer 0 has N = E + C + H
    # columns, the encoder's E + H)
    st = torch.cuda.current_stream().cuda_stream
    le, ld = fe.build_library(), fd.build_library()
    per_layer = {
        "enc_step_kernel": chain_layer_us(
            lambda: fe.launch_encoder_bwd(le, we, tok, dh, *enc[1:], st), "enc_step_kernel",
            cfg.num_layers),
        "dec_step_kernel": chain_layer_us(
            lambda: fd.launch_decoder_bwd(ld, wd, dce, tok, dec[1], h0, cond, *dec[2:], True,
                                          st), "dec_step_kernel", cfg.num_layers)}
    E, C, H = cfg.embedding_dim, cfg.num_conditions, cfg.hidden_dim
    for name, us in per_layer.items():
        k0 = E + C if name == "dec_step_kernel" else E
        log(f"  {name} per launch by layer (layer 0: N = {k0 + H} columns, "
            f"{-(-(k0 + H) // 128)} column tiles; layer l > 0: N = {2 * H}): "
            f"{', '.join(f'layer {l} {u:.2f} us' for l, u in enumerate(us))} [{smi}]")
    out["chain_layer_us"] = per_layer
    lib = cudnn_lstm_ms(cfg.embedding_dim, cfg.hidden_dim, cfg.num_layers, B, L, "bfloat16")
    out["library"] = {"fused_encoder_fwd": lib[0], "fused_encoder_bwd": lib[1]}
    log(f"  cuDNN torch.nn.LSTM, {cfg.num_layers} layers, I={cfg.embedding_dim} "
        f"H={cfg.hidden_dim} B={B} L={L} bf16: forward {lib[0]} ms, backward alone {lib[1]} ms "
        f"[{smi}]")
    del enc, dec
    tcfg = TrainConfig(batch_size=B)
    xs, conds = synthetic_batch(cfg, B, L)
    gen = torch.Generator(device="cuda").manual_seed(4)
    for route, c in (("plain", cfg.replace(use_pallas=False)), ("fused", cfg),
                     ("fused", cfg), ("plain", cfg.replace(use_pallas=False))):
        p = train_model("bfloat16")[1]
        o = {n: adam_init(v) for n, v in p.items()}
        ms = time_ms(lambda: train_step(p, o, c, tcfg, xs, conds, gen, 0.05, 0.9), 3)
        out.setdefault(f"step_{route}", []).append(ms)
        log(f"  train step, {route} route: {ms:.3f} ms = {B * L / ms * 1e3:,.0f} tokens/s "
            f"(B=4096 L=64 bf16) [{smi}]")
    p = train_model("bfloat16")[1]
    o = {n: adam_init(v) for n, v in p.items()}
    out["profile"] = profile_step("default train step, fused route (B=4096 L=64 bf16)",
                                  lambda: train_step(p, o, cfg, tcfg, xs, conds, gen, 0.05, 0.9),
                                  smi)
    check_forward_kernels(out["profile"], "default train step")
    check_kernels(out["profile"], "default train step", "encoder reverse chain",
                  "enc_step_kernel", ("enc_bwd_kernel",))
    check_kernels(out["profile"], "default train step", "decoder reverse chain",
                  "dec_step_kernel", ("dec_bwd_kernel",))
    heads = {k: v for k, v in out["profile"]["kernels"].items()
             if k in ("dec_head_bwd_kernel", "dec_dtop_kernel")}
    log(f"  default train step: the decoder backward's head pass {heads} (ms) [{smi}]")
    return out


def turns(name: str, kern, plain, smi: str, k_reps: int, p_reps: int,
          names=("kernel", "plain")) -> tuple:
    """(kernel ms, plain ms): the min of two runs each, in the order plain,
    kernel, kernel, plain."""
    p1 = time_ms(plain, p_reps)
    k1 = time_ms(kern, k_reps)
    k2 = time_ms(kern, k_reps)
    p2 = time_ms(plain, p_reps)
    log(f"  {name}: {names[0]} {k1:.3f} / {k2:.3f} ms, {names[1]} {p1:.3f} / {p2:.3f} ms "
        f"({names[1]}, {names[0]}, {names[0]}, {names[1]}) [{smi}]")
    return min(k1, k2), min(p1, p2)


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cudnn_lstm_ms(I: int, H: int, layers: int, B: int, L: int, dtype: str) -> tuple:
    """cuDNN's ``torch.nn.LSTM`` at these widths, a yardstick the port never
    calls: (forward ms, backward-alone ms), or (None, None) where PyTorch
    refuses the dtype."""
    wdt = DTYPES[dtype]
    lstm = torch.nn.LSTM(I, H, num_layers=layers).to("cuda", wdt)
    lstm.flatten_parameters()
    x = torch.randn((L, B, I), device="cuda", dtype=wdt, requires_grad=True)
    hc = (torch.zeros((layers, B, H), device="cuda", dtype=wdt),) * 2
    try:
        fwd = time_ms(lambda: lstm(x.detach(), hc), 3)
    except RuntimeError as e:
        log(f"  torch.nn.LSTM refused {dtype}: {str(e).splitlines()[0]}")
        return None, None
    out, _ = lstm(x, hc)
    g = torch.randn_like(out)
    leaves = [x] + list(lstm.parameters())
    bwd = time_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), 3)
    return fwd, bwd


def bound_ms(flops: float, nbytes: float, dtype: str) -> tuple:
    """(least ms, "operations" or "bytes"): the larger of the operations over
    the card's peak for their type and the bytes over its memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def scaled_model(dtype: str, seed: int = 0, use_pallas: bool = True):
    from mlx_vae_tpu_torch.bench import init_train_params
    from mlx_vae_tpu_torch.config import ModelConfig

    cfg = ModelConfig(compute_dtype=dtype, use_pallas=use_pallas, **SCALED)
    return cfg, init_train_params(cfg, "cuda", seed)


def seq_inputs(I: int, H: int, dtype: str, seed: int, stride: int = 1):
    """Weights like a layer's init, inputs, states and cotangents on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    wdt, s = DTYPES[dtype], H ** -0.5
    dev = dict(device="cuda")
    wcat = ((torch.rand((I + H, 4 * H), generator=g, **dev) * 2 - 1) * s).to(wdt)
    bias = (torch.rand((4 * H,), generator=g, **dev) * 2 - 1) * s
    xs = torch.randn((SL * stride, SB, I), generator=g, **dev).to(wdt)
    h0, c0, dhf, dcf = (0.3 * torch.randn((SB, H), generator=g, **dev) for _ in range(4))
    dhs = torch.randn((SL, SB, H), generator=g, **dev) / (SB * SL) ** 0.5
    return wcat, bias, xs, h0, c0, dhs, dhf, dcf


def phase_scaled_kernels() -> dict:
    """Returns {kernel: [largest abs diff, largest rel diff]} over every run."""
    from mlx_vae_tpu_torch.ops import fused_lstm as fl
    from mlx_vae_tpu_torch.ops import fused_seq_lstm as fs
    from mlx_vae_tpu_torch.ops import fused_train_decoder as fd
    from mlx_vae_tpu_torch.ops import train_common as tc

    worst = {k: [0.0, 0.0] for k in SEQ_RECORDS}
    H = SCALED["hidden_dim"]
    for dtype in ("float32", "bfloat16"):
        # I = 129: the scaled decoder's layer 0 (E + C), rows not 16-byte aligned
        for I in (128, 129, 1024):
            tag = f"{dtype} I={I} H={H} B={SB} L={SL}"
            wcat, bias, xs, h0, c0, dhs, dhf, dcf = seq_inputs(I, H, dtype, seed=I)
            k = fs.seq_lstm_fwd(wcat, bias, xs, h0, c0)
            p = fs.seq_lstm_fwd_reference(wcat, bias, xs, h0, c0)
            torch.cuda.synchronize()
            compare(f"{tag} seq fwd [hs, cs, gs, hf, cf]", k, p, dtype, worst["seq_lstm_fwd"])
            if dtype == "bfloat16":  # one writer per element: the step kernel repeats
                again = fs.seq_lstm_fwd(wcat, bias, xs, h0, c0)
                xs2 = torch.zeros((2 * SL,) + tuple(xs.shape[1:]), dtype=xs.dtype, device="cuda")
                xs2[1::2] = xs
                out = tuple(torch.zeros((2 * SL,) + tuple(a.shape[1:]), dtype=a.dtype,
                                        device="cuda") for a in k[:3])
                ks = fs.seq_lstm_fwd(wcat, bias, xs2, h0, c0, res_stride=2, res_offset=1,
                                     xs_stride=2, xs_offset=1, out=out)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(k, again)):
                    raise AssertionError(f"{tag} seq fwd: two runs differ")
                if not (all(torch.equal(a[1::2], b) for a, b in zip(ks[:3], k[:3]))
                        and torch.equal(ks[3], k[3]) and torch.equal(ks[4], k[4])):
                    raise AssertionError(f"{tag} seq fwd, strided: differs from the dense call")
                log(f"  {tag} seq fwd: a second run and a strided run (stride 2, offset 1) "
                    f"are bitwise equal to the first")
                del again, xs2, out, ks
            del k
            kb = fs.seq_lstm_bwd_tm(wcat, xs, h0, c0, *p[:3], dhs, dhf, dcf)
            pb = fs.seq_lstm_bwd_reference(wcat, xs, h0, c0, *p[:3], dhs, dhf, dcf)
            torch.cuda.synchronize()
            compare(f"{tag} seq bwd [dxs, dwcat, db, dh0, dc0]", kb, pb, dtype,
                    worst["seq_lstm_bwd"])
            # residuals and input as rows 2t+1 of [2L, B, .] arrays (the decoder's
            # layer-stacked residuals)
            stk = []
            for a in (*p[:3], xs):
                big = torch.zeros((2 * SL,) + tuple(a.shape[1:]), dtype=a.dtype, device="cuda")
                big[1::2] = a
                stk.append(big)
            ks = fs.seq_lstm_bwd_tm(wcat, stk[3], h0, c0, *stk[:3], dhs, dhf, dcf,
                                    res_stride=2, res_offset=1, xs_stride=2, xs_offset=1)
            torch.cuda.synchronize()
            compare(f"{tag} seq bwd, strided (stride 2, offset 1)", ks, pb, dtype,
                    worst["seq_lstm_bwd"])
            if dtype == "bfloat16":  # the fixed-order sums repeat bit for bit
                again = fs.seq_lstm_bwd_tm(wcat, xs, h0, c0, *p[:3], dhs, dhf, dcf)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(kb, again)):
                    raise AssertionError(f"{tag} seq bwd: two runs differ")
                log(f"  {tag} seq bwd: a second run is bitwise equal")
                del again
            del kb, pb, p, ks, stk
            torch.cuda.empty_cache()
        # row 6's counterpart: the decoder's fused forward, logits specialization
        cfg, params = scaled_model(dtype)
        wd = tc.prepare_stack_weights(params["decoder"], cfg, with_head=True)
        tok, cond, h0, g = train_inputs(cfg, SB, SL, seed=11)
        tag = f"{dtype} scaled decoder fwd logits"
        tf_on = torch.ones((SL,), dtype=torch.bool, device="cuda")
        k = fd.decoder_fwd(wd, h0, cond, tok, tf_on, False)
        p = fd.decoder_fwd_reference(wd, h0, cond, tok, tf_on, False)
        torch.cuda.synchronize()
        if not torch.equal(k[1], p[1]):
            raise AssertionError(f"{tag}: fed tokens differ under full teacher forcing")
        compare(f"{tag}, tf 1.0 [logits, hs, cs, gs]", (k[0], *k[2:]), (p[0], *p[2:]), dtype,
                worst["fused_train_decoder_fwd_logits"])
        if dtype == "bfloat16":
            check_decoder_chain(wd, h0, cond, tok, tf_on, False, k, p, f"{tag}, tf 1.0",
                                worst["fused_train_decoder_fwd_logits"])
        del k, p
        tf = torch.rand((SL,), generator=g, device="cuda") < 0.9
        tf[3] = False  # at least one argmax-fed step
        k = fd.decoder_fwd(wd, h0, cond, tok, tf, False)
        p = fd.decoder_fwd_reference(wd, h0, cond, tok, tf, False)
        torch.cuda.synchronize()
        check_fed_tokens(f"{tag}, tf 0.9", k, p, tf)
        if dtype == "bfloat16":
            check_decoder_chain(wd, h0, cond, tok, tf, False, k, p, f"{tag}, tf 0.9",
                                worst["fused_train_decoder_fwd_logits"])
        del k, p, wd, params
        torch.cuda.empty_cache()
    for B, Hg in ((4096, 1024), (2048, 4096), (4096, 256)):
        g = torch.Generator(device="cuda").manual_seed(B + Hg)
        gates = 3 * torch.randn((B, 4 * Hg), generator=g, device="cuda")
        c, dh, dc = (torch.randn((B, Hg), generator=g, device="cuda") for _ in range(3))
        k = fl.gates_fwd(gates, c)
        p = fl.gates_fwd_reference(gates, c)
        kb = fl.gates_bwd(gates, c, dh, dc)
        pb = fl.gates_bwd_reference(gates, c, dh, dc)
        torch.cuda.synchronize()
        compare(f"float32 gates fwd [{B}, {Hg}] [h, c]", k, p, "float32",
                worst["lstm_gates_fwd"])
        compare(f"float32 gates bwd [{B}, {Hg}] [dgates, dc_prev]", kb, pb, "float32",
                worst["lstm_gates_bwd"])
    return worst


def kernel_counters() -> dict:
    """{kernel: (wrapper, the attribute that counts its launches)}."""
    from mlx_vae_tpu_torch.ops import fused_encoder as fe
    from mlx_vae_tpu_torch.ops import fused_lstm as fl
    from mlx_vae_tpu_torch.ops import fused_seq_lstm as fs
    from mlx_vae_tpu_torch.ops import fused_train_decoder as fd

    return {"seq_lstm_fwd": (fs.seq_lstm_fwd, "launches"),
            "seq_lstm_bwd": (fs.seq_lstm_bwd_tm, "launches"),
            "fused_train_decoder_fwd_logits": (fd.decoder_fwd, "logits_launches"),
            "lstm_gates_fwd": (fl.gates_fwd, "launches"),
            "lstm_gates_bwd": (fl.gates_bwd, "launches"),
            "fused_encoder_fwd": (fe.encoder_fwd, "launches"),
            "fused_encoder_bwd": (fe.encoder_bwd, "launches"),
            "fused_train_decoder_fwd": (fd.decoder_fwd, "launches"),
            "fused_train_decoder_bwd": (fd.decoder_bwd, "launches")}


def reset_counts(counters: dict) -> None:
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def read_counts(counters: dict) -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}


def fused_vs_plain(what: str, model, x, cond, B: int, L: int) -> None:
    """One step on the fused route against the plain route, same params and
    noise, in f32 and bf16: phase 7's bounds."""
    import math

    from mlx_vae_tpu_torch.config import TrainConfig
    from mlx_vae_tpu_torch.train.optim import adam_init
    from mlx_vae_tpu_torch.train.steps import draw_noise, train_step
    from mlx_vae_tpu_torch.utils.tree import tree_leaves, tree_map

    tcfg = TrainConfig(batch_size=B)
    lr = tcfg.learning_rate
    max_step = lr * (1 - tcfg.adam_b1) / math.sqrt(1 - tcfg.adam_b2)
    gen = torch.Generator(device="cuda").manual_seed(6)
    for dtype, s_tol, same_min, leaf_off in (("float32", 1e-4, 0.9999, 1e-4),
                                              ("bfloat16", 1e-2, 0.98, None)):
        cfg, p0 = model(dtype)
        noise = draw_noise(gen, cfg, B, L, 0.9)
        out = {}
        for route, c in (("fused", cfg), ("plain", cfg.replace(use_pallas=False))):
            p = tree_map(torch.clone, p0)
            o = {n: adam_init(v) for n, v in p.items()}
            _, _, m = train_step(p, o, c, tcfg, x, cond, None, 0.05, 0.9, noise=noise)
            out[route] = (p, {k: float(v) for k, v in m.items()})
            del o
        del p0
        (pf, mf), (pp, mp) = out["fused"], out["plain"]
        worst = max(abs(mf[k] - mp[k]) / max(abs(mp[k]), 1e-6)
                    for k in mp if k not in ("mu_abs_max", "logvar_min", "logvar_max"))
        dp = [(a.detach() - b.detach()).abs() for a, b in zip(tree_leaves(pf), tree_leaves(pp))]
        off = [int((d > 1e-2 * max_step).sum()) for d in dp]
        same = 1.0 - sum(off) / sum(d.numel() for d in dp)
        worst_leaf = max(o / d.numel() for o, d in zip(off, dp))
        big = max(float(d.max()) for d in dp)
        log(f"  {what} {dtype} one step fused vs plain route: total {mf['total_loss']:.6f} vs "
            f"{mp['total_loss']:.6f}, grad_norm {mf['grad_norm']:.6f} vs {mp['grad_norm']:.6f}; "
            f"worst rel diff over the 9 scalars and grad_norm {worst:.3e} (tol {s_tol}); "
            f"post-Adam params: {same:.4%} of elements took the same step, worst leaf "
            f"{worst_leaf:.4%} off, max |diff| {big:.3e} (one step <= {max_step:.3e})")
        if not worst <= s_tol:
            raise AssertionError(f"{what} {dtype}: fused and plain route scalars differ by "
                                 f"{worst}")
        if not (same >= same_min and big <= 2 * max_step * 1.001):
            raise AssertionError(f"{what} {dtype}: post-Adam params differ ({same:.4%} same)")
        if leaf_off is not None and any(o > max(1, leaf_off * d.numel())
                                        for o, d in zip(off, dp)):
            raise AssertionError(f"{what} {dtype}: a post-Adam leaf differs in "
                                 f"{worst_leaf:.4%} of its elements")
        del out, pf, pp, dp
        torch.cuda.empty_cache()


def phase_scaled_slice() -> dict:
    """Four scaled bf16 steps, then the fused-vs-plain checks; returns the
    launch count of each new kernel on its main path (the scaled steps for
    the sequence and decoder kernels, the zero-state step for the gate
    pair)."""
    import math

    from mlx_vae_tpu_torch.config import ModelConfig, TrainConfig
    from mlx_vae_tpu_torch.train.optim import adam_init
    from mlx_vae_tpu_torch.train.steps import train_step

    cfg, params = scaled_model("bfloat16")
    x, cond = synthetic_batch(cfg, SB, SL)
    counters = kernel_counters()
    steps = 4
    counts = train_steps(cfg, params, x, cond, steps, counters)
    per_step = {"seq_lstm_fwd": 4, "seq_lstm_bwd": 8, "fused_train_decoder_fwd_logits": 1}
    want = {k: steps * per_step.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"scaled launches {counts}, expected {want}")
    del params
    torch.cuda.empty_cache()
    fused_vs_plain("scaled", lambda dt: scaled_model(dt, seed=3), x, cond, SB, SL)

    # the gate pair's main path: a default-model reference_zero_state step
    B, L = 4096, 64
    zcfg = ModelConfig(compute_dtype="bfloat16", use_pallas=True, reference_zero_state=True)
    zx, zcond = synthetic_batch(zcfg, B, L)
    _, zp = train_model("bfloat16", seed=4)
    zo = {n: adam_init(p) for n, p in zp.items()}
    gen = torch.Generator(device="cuda").manual_seed(2)
    reset_counts(counters)
    _, _, m = train_step(zp, zo, zcfg, TrainConfig(batch_size=B), zx, zcond, gen, 0.05, 0.9)
    torch.cuda.synchronize()
    zcounts = read_counts(counters)
    log(f"  reference_zero_state step, default model, bf16, B={B} L={L}: total loss "
        f"{float(m['total_loss']):.4f}; launches {zcounts}")
    n = zcfg.num_layers
    if not (zcounts["lstm_gates_fwd"] == L * n and zcounts["lstm_gates_bwd"] == L * n
            and math.isfinite(float(m["total_loss"]))):
        raise AssertionError(f"gate-kernel launches {zcounts}, expected {L * n} each way")
    del zp, zo, m
    torch.cuda.empty_cache()
    fused_vs_plain("reference_zero_state",
                   lambda dt: (zcfg.replace(compute_dtype=dt), train_model(dt, seed=5)[1]),
                   zx, zcond, B, L)
    counts.update({k: zcounts[k] for k in ("lstm_gates_fwd", "lstm_gates_bwd")})
    return counts


def lstm_flops(B: int, L: int, widths) -> float:
    """Multiply-adds x 2 of the cells' products over L steps of B rows, for
    layers of (input width, H)."""
    return 2.0 * B * L * sum((i + h) * 4 * h for i, h in widths)


def phase_scaled_times(smi: str) -> dict:
    """{kernel: (kernel ms, plain ms, library ms, bound ms, bound by)}, the
    whole-stack kernels' times at the scaled shape, and the scaled step's."""
    from mlx_vae_tpu_torch.bench_gates import l2_scrub, median_ms
    from mlx_vae_tpu_torch.config import TrainConfig
    from mlx_vae_tpu_torch.ops import fused_encoder as fe
    from mlx_vae_tpu_torch.ops import fused_lstm as fl
    from mlx_vae_tpu_torch.ops import fused_seq_lstm as fs
    from mlx_vae_tpu_torch.ops import fused_train_decoder as fd
    from mlx_vae_tpu_torch.ops import train_common as tc
    from mlx_vae_tpu_torch.train.optim import adam_init
    from mlx_vae_tpu_torch.train.steps import train_step

    out = {}
    H, dt, es = SCALED["hidden_dim"], "bfloat16", 2
    M = SB * SL
    for I in (128, 1024):
        wcat, bias, xs, h0, c0, dhs, dhf, dcf = seq_inputs(I, H, dt, seed=I + 1)
        res = fs.seq_lstm_fwd(wcat, bias, xs, h0, c0)
        fl_ops = lstm_flops(SB, SL, [(I, H)])
        w_bytes = (I + H) * 4 * H * es + 4 * H * 4
        fwd_bytes = M * I * es + w_bytes + 2 * SB * H * 4 + M * 6 * H * es + 2 * SB * H * 4
        bwd_bytes = (M * I * es + w_bytes + M * 6 * H * es + M * H * 4 + 4 * SB * H * 4
                     + M * I * 4 + (I + H) * 4 * H * 4 + 4 * H * 4 + 2 * SB * H * 4)
        k_ms, p_ms = turns(f"seq_lstm_fwd I={I}", lambda: fs.seq_lstm_fwd(wcat, bias, xs, h0, c0),
                           lambda: fs.seq_lstm_fwd_reference(wcat, bias, xs, h0, c0), smi, 3, 2)
        kb_ms, pb_ms = turns(f"seq_lstm_bwd I={I}",
                             lambda: fs.seq_lstm_bwd_tm(wcat, xs, h0, c0, *res[:3], dhs, dhf, dcf),
                             lambda: fs.seq_lstm_bwd_reference(wcat, xs, h0, c0, *res[:3], dhs,
                                                               dhf, dcf), smi, 2, 2)
        lib = cudnn_lstm_ms(I, H, 1, SB, SL, dt)
        log(f"  cuDNN torch.nn.LSTM, 1 layer, I={I} H={H} B={SB} L={SL} bf16: forward "
            f"{lib[0]} ms, backward alone {lib[1]} ms [{smi}]")
        out[f"seq_lstm_fwd I={I}"] = (k_ms, p_ms, lib[0], *bound_ms(fl_ops, fwd_bytes, dt))
        out[f"seq_lstm_bwd I={I}"] = (kb_ms, pb_ms, lib[1], *bound_ms(2 * fl_ops, bwd_bytes, dt))
        log(f"  I={I}: forward {fl_ops / 1e12:.4f} TFLOP, bound "
            f"{out[f'seq_lstm_fwd I={I}'][3]:.4f} ms, {fl_ops / k_ms / 1e9:.1f} TFLOP/s; "
            f"backward bound {out[f'seq_lstm_bwd I={I}'][3]:.4f} ms")
        del res, wcat, xs, dhs
        torch.cuda.empty_cache()

    cfg, params = scaled_model(dt)
    wd = tc.prepare_stack_weights(params["decoder"], cfg, with_head=True)
    we = tc.prepare_stack_weights(params["encoder"], cfg, with_head=False)
    tok, cond, h0, g = train_inputs(cfg, SB, SL, seed=12)
    tf = torch.rand((SL,), generator=g, device="cuda") < 0.9
    E, C, V, n = cfg.embedding_dim, cfg.num_conditions, cfg.vocab_size, cfg.num_layers
    dec_widths = [(E + C, H)] + [(H, H)] * (n - 1)
    dec_ops = lstm_flops(SB, SL, dec_widths) + 2.0 * M * H * V
    stack_bytes = sum((i + H) * 4 * H for i, _ in dec_widths) * es
    res_bytes = M * n * 6 * H * es
    k_ms, p_ms = turns("fused_train_decoder_fwd_logits",
                       lambda: fd.decoder_fwd(wd, h0, cond, tok, tf, False),
                       lambda: fd.decoder_fwd_reference(wd, h0, cond, tok, tf, False), smi, 2, 1)
    out["fused_train_decoder_fwd_logits"] = (
        k_ms, p_ms, None, *bound_ms(dec_ops, stack_bytes + res_bytes + M * V * 4 + M * 8, dt))

    # route check: the whole-stack kernels at the scaled shape, through their
    # launch functions (no route, no counter)
    st = torch.cuda.current_stream().cuda_stream
    le, ld = fe.build_library(), fd.build_library()
    enc_res = fe.launch_encoder_fwd(le, we, tok, st)
    dec_res = fd.launch_decoder_fwd(ld, wd, h0, cond, tok, tf.int(), True, st)
    dce = torch.full((SB,), 1.0 / M, device="cuda")
    whole = {
        "whole-stack encoder fwd": lambda: fe.launch_encoder_fwd(le, we, tok, st),
        "whole-stack encoder bwd": lambda: fe.launch_encoder_bwd(le, we, tok, h0, *enc_res[1:],
                                                                 st),
        "whole-stack decoder fwd (CE)": lambda: fd.launch_decoder_fwd(ld, wd, h0, cond, tok,
                                                                      tf.int(), True, st),
        "whole-stack decoder bwd (CE)": lambda: fd.launch_decoder_bwd(
            ld, wd, dce, tok, dec_res[1], h0, cond, *dec_res[2:], True, st),
    }
    for name, fn in whole.items():
        ms = time_ms(fn, 1)
        out[name] = ms
        log(f"  route check, {name} at H={H} n={n} B={SB} L={SL} bf16: {ms:.3f} ms [{smi}]")
    del enc_res, dec_res, wd, we, params
    torch.cuda.empty_cache()

    # the gate pair at its main path's shape (default model: B=4096, H=256)
    Bg, Hg = 4096, 256
    g = torch.Generator(device="cuda").manual_seed(9)
    gates = torch.randn((Bg, 4 * Hg), generator=g, device="cuda")
    c, dh, dc = (torch.randn((Bg, Hg), generator=g, device="cuda") for _ in range(3))
    zero = torch.zeros_like(gates)
    k_ms, p_ms = turns("lstm_gates_fwd", lambda: fl.gates_fwd(gates, c),
                       lambda: fl.gates_fwd_reference(gates, c), smi, 50, 50)
    kb_ms, pb_ms = turns("lstm_gates_bwd", lambda: fl.gates_bwd(gates, c, dh, dc),
                         lambda: fl.gates_bwd_reference(gates, c, dh, dc), smi, 50, 50)
    aten = torch.ops.aten
    hy, cy, ws = aten._thnn_fused_lstm_cell(gates, zero, c)
    med = median_ms({
        "kernel fwd": lambda: fl.gates_fwd(gates, c),
        "aten fwd": lambda: aten._thnn_fused_lstm_cell(gates, zero, c),
        "kernel bwd": lambda: fl.gates_bwd(gates, c, dh, dc),
        "aten bwd": lambda: aten._thnn_fused_lstm_cell_backward_impl(dh, dc, c, cy, ws, False)},
        GATE_SAMPLES, l2_scrub())
    log(f"  gate pair vs PyTorch's fused LSTM cell (aten::_thnn_fused_lstm_cell) [{Bg}, {Hg}] "
        f"f32, median device ms of {GATE_SAMPLES} launches each, interleaved, each behind a "
        f"128 MB write that evicts the L2: forward kernel "
        f"{med['kernel fwd']:.5f} / aten {med['aten fwd']:.5f}, backward kernel "
        f"{med['kernel bwd']:.5f} / aten {med['aten bwd']:.5f} [{smi}]")
    units = Bg * Hg
    out["lstm_gates_fwd"] = (med["kernel fwd"], p_ms, med["aten fwd"],
                             *bound_ms(40.0 * units, 28.0 * units, "float32"))
    out["lstm_gates_bwd"] = (med["kernel bwd"], pb_ms, med["aten bwd"],
                             *bound_ms(70.0 * units, 48.0 * units, "float32"))

    # the scaled step, plain route against the fused route
    tcfg = TrainConfig(batch_size=SB)
    xb, cb = synthetic_batch(cfg, SB, SL)
    gen = torch.Generator(device="cuda").manual_seed(4)
    for route, use in (("plain", False), ("fused", True), ("fused", True), ("plain", False)):
        c_, p = scaled_model(dt, use_pallas=use)
        o = {k: adam_init(v) for k, v in p.items()}
        ms = time_ms(lambda: train_step(p, o, c_, tcfg, xb, cb, gen, 0.05, 0.9), 1)
        out.setdefault(f"scaled_step_{route}", []).append(ms)
        log(f"  scaled train step, {route} route: {ms:.3f} ms = {M / ms * 1e3:,.0f} tokens/s "
            f"(H=1024 n=4 B={SB} L={SL} bf16) [{smi}]")
        del p, o
        torch.cuda.empty_cache()
    c_, p = scaled_model(dt)
    o = {k: adam_init(v) for k, v in p.items()}
    out["profile"] = profile_step(f"scaled train step, fused route (H=1024 n=4 B={SB} L={SL} "
                                  f"bf16)", lambda: train_step(p, o, c_, tcfg, xb, cb, gen, 0.05,
                                                               0.9), smi)
    check_forward_kernels(out["profile"], "scaled train step")
    del p, o
    torch.cuda.empty_cache()
    return out


def default_bounds() -> dict:
    """{kernel: (bound ms, bound by)} of the sampler and the default-model
    train kernels at the shapes phases 5 and 8 time them; the sampler's by
    route: CUDA-core f32 FMA (67 TFLOP/s), split-TF32 (3 x the operations at
    495 TFLOP/s), bf16 (989 TFLOP/s)."""
    from mlx_vae_tpu_torch.config import ModelConfig

    cfg = ModelConfig()
    E, C, H, V, n = (cfg.embedding_dim, cfg.num_conditions, cfg.hidden_dim, cfg.vocab_size,
                     cfg.num_layers)
    out = {}
    B, L = 8192, 64  # the sampler, f32
    M = B * L
    ops = lstm_flops(B, L, [(E + C, H)] + [(H, H)] * (n - 1)) + 2.0 * M * H * V
    w = ((E + C + H) * 4 * H + (n - 1) * 2 * H * 4 * H + H * V + V * E) * 4
    nbytes = w + B * (H + C) * 4 + M * 4
    out["fused_generate"] = bound_ms(ops, nbytes, "float32")  # CUDA cores
    # the tensor-core route: three TF32 products a product in f32, bf16 as is
    t_bytes = nbytes / PEAK_BYTES
    t_tf32 = 3 * ops / PEAK_TF32
    out["fused_generate_tc"] = (max(t_tf32, t_bytes) * 1e3,
                                "operations" if t_tf32 >= t_bytes else "bytes")
    out["fused_generate_tc_bf16"] = bound_ms(ops, nbytes - w // 2, "bfloat16")
    B, L, es = 4096, 64, 2  # the train kernels, bf16
    M = B * L
    res = M * n * 6 * H * es
    enc_w = [(E, H)] + [(H, H)] * (n - 1)
    dec_w = [(E + C, H)] + [(H, H)] * (n - 1)
    enc_ops, dec_ops = lstm_flops(B, L, enc_w), lstm_flops(B, L, dec_w)
    wb = lambda ws: sum((i + h) * 4 * h for i, h in ws)  # noqa: E731
    grads = lambda ws, head: (wb(ws) + n * 4 * H + V * E + head) * 4  # noqa: E731
    out["fused_encoder_fwd"] = bound_ms(enc_ops, M * 4 + (wb(enc_w) + V * E) * es + res
                                        + B * H * 4, "bfloat16")
    out["fused_encoder_bwd"] = bound_ms(2 * enc_ops, M * 4 + (wb(enc_w) + V * E) * es + res
                                        + B * H * 4 + grads(enc_w, 0), "bfloat16")
    dec_in = M * 4 + B * (H + C) * 4 + (wb(dec_w) + V * E + 2 * H * V) * es
    out["fused_train_decoder_fwd"] = bound_ms(dec_ops + 2.0 * M * H * V,
                                              dec_in + B * 4 + M * 4 + res, "bfloat16")
    out["fused_train_decoder_bwd"] = bound_ms(
        2 * dec_ops + 6.0 * M * H * V, dec_in + B * 4 + M * 4 + res
        + grads(dec_w, H * V + V) + B * (H + C) * 4, "bfloat16")
    return out


def run_main(main, argv: list) -> str:
    """``main(argv)`` of a port CLI in this process, its standard output
    captured and returned (its standard error, the progress bars, dropped);
    its last lines are logged."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        main(argv)
    text = out.getvalue()
    for line in text.strip().splitlines()[-3:]:
        log(f"    | {line}")
    return text


def read_history(ck: str) -> dict:
    with open(f"{ck}/training_history.json") as f:
        return json.load(f)


def trace_profile(path: str) -> dict:
    """Device time by kernel name, and the idle share (1 - the device's busy
    time over the span of every event), from a ``torch.profiler`` Chrome
    trace (the train CLI's ``--profile``)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    by_name, busy = {}, 0.0
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            busy += e["dur"] / 1e3
            if e["cat"] == "kernel":
                name = e["name"].replace("(anonymous namespace)::", "").split("(")[0][:80]
                by_name[name] = by_name.get(name, 0.0) + e["dur"] / 1e3
    wall = (max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)) / 1e3
    return {"wall_ms": wall, "device_ms": busy, "idle_share": max(0.0, 1 - busy / wall),
            "kernels": by_name}


def epoch_counts(counters: dict, seen: list):
    """Patch ``ARCVAETrainer.train_epoch`` so that each epoch appends the
    train-kernel launch counts so far to ``seen``; returns the undo."""
    from mlx_vae_tpu_torch.train.trainer import ARCVAETrainer

    real = ARCVAETrainer.train_epoch

    def counted(self, *a, **kw):
        out = real(self, *a, **kw)
        seen.append(read_counts(counters))
        return out

    ARCVAETrainer.train_epoch = counted
    return lambda: setattr(ARCVAETrainer, "train_epoch", real)


def save_timing(rec: dict):
    """Patch ``ARCVAETrainer`` so that ``rec`` gets the clock at each
    epoch's start (``"epoch"``) and at the end of each ``join_saves``
    (``"join"``), and the seconds the calling thread spends in
    ``save_checkpoint`` (``"save_s"``); returns the undo."""
    from mlx_vae_tpu_torch.train.trainer import ARCVAETrainer

    real = {k: getattr(ARCVAETrainer, k) for k in ("train_epoch", "save_checkpoint",
                                                   "join_saves")}
    rec.update(epoch=[], join=[], save_s=0.0)

    def train_epoch(self, *a, **kw):
        rec["epoch"].append(time.perf_counter())
        return real["train_epoch"](self, *a, **kw)

    def save_checkpoint(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return real["save_checkpoint"](self, *a, **kw)
        finally:
            rec["save_s"] += time.perf_counter() - t0

    def join_saves(self):
        try:
            return real["join_saves"](self)
        finally:
            rec["join"].append(time.perf_counter())

    for k, f in (("train_epoch", train_epoch), ("save_checkpoint", save_checkpoint),
                 ("join_saves", join_saves)):
        setattr(ARCVAETrainer, k, f)
    return lambda: [setattr(ARCVAETrainer, k, f) for k, f in real.items()]


TRAIN_PASS = re.compile(r"Throughput: ([\d,]+) tokens/sec \(([\d.]+)s train pass\)")
# history values of the f32 train CLI, fused route against plain route: the
# tolerance of the CPU parity test (tests/test_torch_trainer.py, the port against
# JAX over 2 epochs, f32), whose worst measured error is 8.0e-7
CLI_F32_RTOL = 1e-5


def phase_train_cli(smi: str, step_ms: float) -> dict:
    """The port's train and generate CLIs in this process at the default
    model's width (phase 12 of the docstring); returns the train kernels'
    launches over the two-epoch run and the sampler's over the served run,
    and the times."""
    import os

    from mlx_vae_tpu_torch.cli import generate as cli_generate
    from mlx_vae_tpu_torch.cli import train as cli_train
    from mlx_vae_tpu_torch.data import packer, prepare
    from mlx_vae_tpu_torch.ops.fused_decoder import fused_generate
    from mlx_vae_tpu_torch.train.checkpoint import load_checkpoint

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        s, ck = f"{tmp}/s.json", f"{tmp}/ck"
        run_main(prepare.main, ["--synthetic", "20523", "--output", s])
        if packer._get_lib() is None:
            raise AssertionError("native/packer.cpp did not build")
        base = ["--data", s, "--batch_size", "4096", "--compute_dtype", "bfloat16",
                "--use_pallas", "--checkpoint_freq", "1", "--checkpoint_dir", ck]

        # two epochs: 4 batches of 4096 and one of 34, eval at 2052 and 2053 rows
        counters = {k: v for k, v in kernel_counters().items() if k in TRAIN_KERNELS}
        seen = []
        undo = epoch_counts(counters, seen)
        reset_counts(counters)
        try:
            text = run_main(cli_train.main, base + ["--epochs", "2", "--eval_test",
                                                    "--verbose"])
        finally:
            undo()
        launches = read_counts(counters)
        for e, c in enumerate(seen):
            log(f"  epoch {e + 1}: train-kernel launches so far {c}")
        if min(launches.values()) < 1:
            raise AssertionError(f"a train kernel was never launched: {launches}")
        h = read_history(ck)
        if h["epoch"] != [0, 1] or not all(math.isfinite(v) for k in h for v in h[k]):
            raise AssertionError(f"history of the two-epoch run: {h}")
        if not h["train_recon"][1] < h["train_recon"][0]:
            raise AssertionError(f"train_recon did not fall: {h['train_recon']}")
        for name in ("checkpoint_epoch_000.npz", "checkpoint_epoch_001.npz",
                     "checkpoint_best.npz"):
            if not os.path.exists(f"{ck}/{name}"):
                raise AssertionError(f"{name} was not written")
        if "Test set (2,053 samples)" not in text:
            raise AssertionError("--eval_test printed no test line")
        passes = TRAIN_PASS.findall(text)
        out["batch_ms"] = float(passes[1][1]) * 1e3 / 5
        out["throughput"] = passes[1][0]
        log(f"  two epochs: train_recon {h['train_recon']}, val_loss {h['val_loss']}; "
            f"train pass epoch 1 {passes[0][1]} s, epoch 2 {passes[1][1]} s over 5 batches "
            f"= {out['batch_ms']:.3f} ms a batch (phase 8's fused step at B=4096: "
            f"{step_ms:.3f} ms); Throughput {passes[1][0]} tokens/s [{smi}]")
        # the async checkpoint (the default) against --sync_checkpoint: three
        # epochs each, a checkpoint every epoch, in turns async, sync, sync,
        # async; the epochs' wall time runs from the first epoch's start to the
        # end of the last save (its join), so it holds every save
        out["save"] = {"async": [], "sync": []}
        for i, mode in enumerate(("async", "sync", "sync", "async")):
            rec = {}
            undo = save_timing(rec)
            try:
                text = run_main(cli_train.main, base[:-1] + [
                    f"{tmp}/ck_{mode}_{i}", "--epochs", "3",
                    *(["--sync_checkpoint"] if mode == "sync" else [])])
            finally:
                undo()
            passes = [float(p[1]) for p in TRAIN_PASS.findall(text)]
            row = {"epochs_wall_s": rec["join"][-1] - rec["epoch"][0],
                   "train_pass_s": passes, "save_call_s": rec["save_s"]}
            out["save"][mode].append(row)
            log(f"  three epochs, {mode} checkpoint: epochs' wall {row['epochs_wall_s']:.4f} s "
                f"(first epoch's start to the last save's end), train passes "
                f"{', '.join(f'{p:.4f}' for p in passes)} s, the main thread in "
                f"save_checkpoint {row['save_call_s']:.4f} s [{smi}]")

        # resume for a third epoch, profiled: the kernels by name and the idle share
        text = run_main(cli_train.main, base + ["--epochs", "3", "--resume",
                                                "--profile", f"{tmp}/prof"])
        if "Resuming from epoch 2" not in text or read_history(ck)["epoch"] != [0, 1, 2]:
            raise AssertionError("--resume did not run epoch index 2 alone")
        prof = trace_profile(f"{tmp}/prof/trace.json")
        check_forward_kernels(prof, "train CLI epoch 3")
        check_kernels(prof, "train CLI epoch 3", "encoder reverse chain", "enc_step_kernel",
                      ("enc_bwd_kernel",))
        check_kernels(prof, "train CLI epoch 3", "decoder reverse chain", "dec_step_kernel",
                      ("dec_bwd_kernel",))
        out["idle_share"] = prof["idle_share"]
        log(f"  train CLI epoch 3 under torch.profiler: {prof['wall_ms']:.3f} ms wall, "
            f"{prof['device_ms']:.3f} ms of device time, idle share {prof['idle_share']:.4f} "
            f"[{smi}]")

        # fused against plain in f32 from the same seed
        f = f"{tmp}/f.json"
        run_main(prepare.main, ["--synthetic", "3000", "--output", f])
        hist = {}
        for route, extra in (("fused", ["--use_pallas"]), ("plain", [])):
            reset_counts(counters)
            run_main(cli_train.main, ["--data", f, "--batch_size", "256", "--epochs", "1",
                                      "--checkpoint_dir", f"{tmp}/{route}", *extra])
            hist[route], f32_launches = read_history(f"{tmp}/{route}"), read_counts(counters)
            log(f"  train CLI f32, {route} route: train-kernel launches {f32_launches}")
            if route == "fused" and min(f32_launches.values()) < 1:
                raise AssertionError(f"the f32 fused run left a train kernel unlaunched: "
                                     f"{f32_launches}")
            if route == "plain" and max(f32_launches.values()) > 0:
                raise AssertionError(f"the plain route launched a train kernel: {f32_launches}")
        worst = max(abs(a - b) / max(abs(b), 1e-6)
                    for k in hist["plain"] if k != "epoch"
                    for a, b in zip(hist["fused"][k], hist["plain"][k]))
        log(f"  train CLI f32, fused route against plain, 1 epoch of 2400 rows at B=256: "
            f"worst relative difference over the history {worst:.3e} "
            f"(tolerance {CLI_F32_RTOL})")
        if not worst <= CLI_F32_RTOL:
            raise AssertionError(f"fused and plain histories differ: {hist}")
        out["f32_worst"] = worst

        # serve what was trained: the tensor-core sampler, novelty against --data
        fused_generate.launches = fused_generate.tc_launches = 0
        fused_generate.core_launches = 0
        text = run_main(cli_generate.main, [
            "--checkpoint", f"{ck}/checkpoint_best.npz", "--data", s,
            "--num_molecules", "8192", "--batch_size", "8192", "--max_length", "64",
            "--target", "90", "--output", f"{tmp}/gen.npz"])
        out["sampler_launches"] = fused_generate.tc_launches
        if fused_generate.tc_launches < 1 or "Novelty vs training set" not in text:
            raise AssertionError(f"generate: {fused_generate.tc_launches} tensor-core "
                                 f"launches; output {text[-500:]}")

        # a real SELFIES corpus: one epoch, the alphabet in the checkpoint, validity
        d, dk = f"{tmp}/d.json", f"{tmp}/dk"
        run_main(prepare.main, ["--drug_like", "2000", "--output", d])
        run_main(cli_train.main, ["--data", d, "--batch_size", "256", "--epochs", "1",
                                  "--compute_dtype", "bfloat16", "--use_pallas",
                                  "--checkpoint_dir", dk])
        with open(d) as fh:
            alphabet = json.load(fh)["alphabet"]
        if load_checkpoint(f"{dk}/checkpoint_best.npz")["data_stats"]["alphabet"] != alphabet:
            raise AssertionError("the checkpoint does not carry the corpus's alphabet")
        text = run_main(cli_generate.main, [
            "--checkpoint", f"{dk}/checkpoint_best.npz", "--num_molecules", "2048",
            "--batch_size", "2048", "--max_length", "64", "--target", "90",
            "--output", f"{tmp}/gen_d.json"])
        valid = re.search(r"Validity: ([\d.]+)%", text)
        if valid is None or "Molecule-level" not in text:
            raise AssertionError(f"generate on the SELFIES checkpoint: {text[-500:]}")
        log(f"  drug-like corpus, alphabet {len(alphabet)}: one epoch, then validity "
            f"{valid.group(1)}% [{smi}]")
    out["launches"] = launches
    return out


# kernel: (source, the TPU kernel it replaces, its row in phase 11's times,
# the timed shape)
SEQ_RECORDS = {
    "seq_lstm_fwd": ("fused_seq_lstm.cu", "pallas_seq_lstm.py:116", "seq_lstm_fwd I=1024",
                     "I=1024 H=1024 B=2048 L=64 bf16"),
    "seq_lstm_bwd": ("fused_seq_lstm.cu", "pallas_seq_lstm.py:195", "seq_lstm_bwd I=1024",
                     "I=1024 H=1024 B=2048 L=64 bf16"),
    "fused_train_decoder_fwd_logits": (
        "fused_train_decoder.cu", "pallas_train_decoder.py:203",
        "fused_train_decoder_fwd_logits", "H=1024 n=4 V=80 E=128 B=2048 L=64 bf16 tf 0.9"),
    "lstm_gates_fwd": ("fused_lstm_gates.cu", "pallas_lstm.py:56", "lstm_gates_fwd",
                       "B=4096 H=256 f32"),
    "lstm_gates_bwd": ("fused_lstm_gates.cu", "pallas_lstm.py:68", "lstm_gates_bwd",
                       "B=4096 H=256 f32"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true",
                    help="time every sampler cluster size and rows-per-thread instance "
                         "instead of phases 3-11")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1 device] {name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; allow_tf32 matmul=False cudnn=False")

    t0 = time.perf_counter()
    build_all()
    log(f"[2 build] csrc/{'.cu, '.join(SOURCES)}.cu built and loaded in "
        f"{time.perf_counter() - t0:.2f}s")

    device = {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}
    if args.sweep:
        log(f"[sweep] cluster size and rows per thread forced, default model [{smi}]")
        sweep = phase_sweep(smi)
        log(smi)
        print(json.dumps({"tile_sweep": sweep}))
        print(json.dumps({"ok": True, "device": device}))
        return 0

    log("[3 kernel vs plain] both sampler kernels, default model, B=256/2048/8192, L=64")
    worst = phase_kernel_vs_plain()

    log("[4 slice] port server, tiers 256,2048,8192, max_length 64, f32")
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_slice(tmp)
        phase_scan_served(tmp)
        core_launches = phase_core_served(tmp)

    log(f"[5 times] tensor-core vs CUDA-core vs plain sampler, CUDA events [{smi}]")
    times = phase_times(smi)

    log(f"[6 train kernels vs plain] default model, L=64, B={'/'.join(map(str, TRAIN_BATCHES))}, "
        f"f32/bf16")
    errs = phase_train_kernels()

    log("[7 train slice] train_step, default model, bf16, B=4096, L=64, fused route")
    launches_train = phase_train_slice()

    log(f"[8 train times] B=4096 L=64 bf16, CUDA events [{smi}]")
    train_times = phase_train_times(smi)

    log("[9 scaled kernels vs plain] sequence LSTM, decoder logits forward, gate pair")
    seq_errs = phase_scaled_kernels()

    log("[10 scaled slice] train_step, hidden 1024 / 4 layers, bf16, B=2048, L=64, fused "
        "route; reference_zero_state gate path")
    launches_seq = phase_scaled_slice()

    log(f"[11 scaled times] CUDA events [{smi}]")
    seq_times = phase_scaled_times(smi)

    log("[12 train CLI] cli.train on a 20,523-molecule corpus, default model, bf16, "
        "B=4096, fused route; resume; f32 fused vs plain; cli.generate with --data")
    cli = phase_train_cli(smi, sum(train_times["step_fused"]) / len(train_times["step_fused"]))

    bounds = default_bounds()
    t_ms, c_ms, p_ms = times[("float32", 8192)]
    sampler_err = ("largest |kernel - plain| of the first step's scaled logits over "
                   "B=256/2048/8192, f32/bf16, greedy/T=0.8/top-k+top-p (tolerance 1e-4 f32, "
                   "1e-2 bf16)")
    tiers = {f"{d} B={B}": {"tc_ms": v[0], "cuda_core_ms": v[1], "plain_ms": v[2]}
             for (d, B), v in ((k, v) for k, v in times.items() if k != "profile")}
    log(smi)
    print(json.dumps({"kernels": [{
        "name": "fused_generate_tc", "route": "cuda",
        "source": "mlx_vae_tpu_torch/csrc/fused_generate.cu (tc::gen_tc_kernel)",
        "replaces": "mlx_vae_tpu/ops/pallas_decoder.py:142",
        "launches": launches,
        "launches_train_cli": cli["sampler_launches"],
        "max_abs_err": worst["tc"][0], "err_metric": sampler_err,
        "max_row_disagreement": worst["tc"][1],
        "ms": t_ms, "plain_ms": p_ms,
        "bound_ms": bounds["fused_generate_tc"][0], "bound_by": bounds["fused_generate_tc"][1],
        "bound_note": "f32 as split-TF32: 3 x the operations over 495 TFLOP/s, or the bytes "
                      "over 3.35 TB/s; bf16: bound_ms_bf16 (989 TFLOP/s)",
        "bound_ms_bf16": bounds["fused_generate_tc_bf16"][0],
        "bf16_ms": times[("bfloat16", 8192)][0], "tiers": tiers,
        "library_ms": None,
        "timed_shape": "B=8192 L=64 f32 T=0.8"}, {
        "name": "fused_generate", "route": "cuda",
        "source": "mlx_vae_tpu_torch/csrc/fused_generate.cu (fused_generate_kernel)",
        "replaces": "mlx_vae_tpu/ops/pallas_decoder.py:142",
        "launches": core_launches,
        "launches_note": "phase 4's H=48 served run (a config the tensor-core sampler does "
                         "not take); the default config's served run launches it 0 times",
        "max_abs_err": worst["cuda_core"][0], "err_metric": sampler_err,
        "max_row_disagreement": worst["cuda_core"][1],
        "ms": c_ms, "plain_ms": p_ms,
        "bound_ms": bounds["fused_generate"][0], "bound_by": bounds["fused_generate"][1],
        "library_ms": None,
        "timed_shape": "B=8192 L=64 f32 T=0.8"}] + [{
            "name": kname, "route": "cuda", "source": TRAIN_SOURCES[kname],
            "replaces": TRAIN_REPLACES[kname], "launches": launches_train[kname],
            "launches_train_cli": cli["launches"][kname],
            "max_abs_err": errs[kname][0],
            "err_metric": f"largest |kernel - plain| over every output (forward) or "
                          f"gradient leaf (backward; the encoder's also its reverse chain's "
                          f"dgates and dx0) at B={'/'.join(map(str, TRAIN_BATCHES))}, "
                          f"f32/bf16, teacher forcing on{TRAIN_NOTES.get(kname, '')}"
                          f"; largest max|diff|/max|plain| {errs[kname][1]:.3e} "
                          f"(tolerance 1e-4 f32, 2e-2 bf16)",
            "ms": train_times[kname][0], "plain_ms": train_times[kname][1],
            "bound_ms": bounds[kname][0], "bound_by": bounds[kname][1],
            "library_ms": train_times["library"].get(kname),
            "timed_shape": "B=4096 L=64 bf16" + (" with_ce" if "decoder" in kname else "")}
            for kname in TRAIN_KERNELS] + [{
            "name": kname, "route": "cuda", "source": f"mlx_vae_tpu_torch/csrc/{src}",
            "replaces": f"mlx_vae_tpu/ops/{tpu}", "launches": launches_seq[kname],
            "max_abs_err": seq_errs[kname][0],
            "err_metric": f"largest |kernel - plain| over every output or gradient leaf "
                          f"(phase 9{DEC_FWD_NOTE if 'decoder' in kname else ''}); largest "
                          f"max|diff|/max|plain| {seq_errs[kname][1]:.3e} "
                          f"(tolerance 1e-4 f32, 2e-2 bf16)",
            **dict(zip(("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"), seq_times[row])),
            "timed_shape": shape}
            for kname, (src, tpu, row, shape) in SEQ_RECORDS.items()]}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
