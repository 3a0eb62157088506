#!/usr/bin/env python3
"""Molecule-generation server (counterpart of ``mlx_vae_tpu/cli/serve.py``).

``python -m mlx_vae_tpu_torch.cli.serve --checkpoint ck.npz --device cuda``.
Stdlib HTTP (``http.server``) over a trained checkpoint, with the JAX
server's flags, endpoints, field names and 400/500/503 mapping:

* **Size tiers**: requests route to the smallest tier of the ladder
  (``--batch_sizes``, e.g. ``256,2048,8192``) that fits; larger requests
  decompose into several passes (``plan_cover``).
* **Background warm-up**: every (tier, sampler config) pair runs once
  before it serves (the first run builds the kernel). The constructor warms
  the smallest tier, then the server binds, and a daemon thread warms the
  rest smallest tier first, then the block streams. Meanwhile requests plan
  over warm tiers only; a config with no warm tier, or a request whose
  warm-tier plan needs more than ``WARM_PLAN_FACTOR`` times the passes of
  the full ladder's plan, gets a 503 with Retry-After. A failed warm-up run
  leaves its tier cold, ends the warm-up and shows in ``/health`` as
  ``warmup["error"]``. ``--sync_warmup`` warms the whole ladder before the
  server binds.
* **One device, one dispatcher**: a single dispatcher thread owns the
  device; handler threads enqueue jobs and wait, so health checks never
  queue behind generation.
* **Request coalescing**: once the ladder is warm, jobs already waiting in
  the queue with the same sampler config join one group, up to the largest
  coalescible tier (no artificial wait), whose blocks of ``block_rows``
  rows are laid end to end and cut into shared passes. Block ``b`` of a
  request draws its z and its sampler seed as a pure function of (request
  seed, b) (:func:`block_streams`), its ``h0`` by one product of fixed
  shape, and carries its own temperature and conditions; the kernel
  computes each block from its own inputs alone. So a request's tokens are
  the same whether it runs alone or coalesced, in whichever pass and
  position. Stochastic and truncated configs coalesce only on the fused
  sampler (the scan sampler's draws depend on batch position); greedy ones
  wherever greedy rows are row-independent (:func:`greedy_row_independent`).
  A job that cannot coalesce runs solo, its pass ``p`` drawing from a
  ``torch.Generator`` seeded from (request seed, p).
* **Sampler by config**: the fused sampler where the kernel takes the
  model, else the scan sampler (``models/vae.py:generation_sampler``), as
  the JAX server routes on its accelerator; ``/health`` reports it as
  ``"sampler"``, and the fused sampler's route
  (``ops/fused_decoder.py:fused_generate_route``: ``"tc"``, ``"steps"`` or
  ``"cuda_core"``) as ``"sampler_route"``.

Seeded streams are reproducible on one device; they are not the JAX
server's threefry draws, and the CPU and the card give different bits.

Endpoints::

    GET  /health            -> {"status": "ok", "model": {...}, ...}
    POST /generate          <- {"num_molecules": 1000, "target": [90.0],
                                "temperature": 0.8, "greedy": false,
                                "seed": 0, "return_tokens": false}
                            -> {"selfies": [...], "validity": ..,
                                "uniqueness": .., "mols_per_sec": ..,
                                "passes": .., "coalesced": ..}
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from mlx_vae_tpu_torch.cli.common import add_cache_flags


# ---- pass planning (pure; copied from mlx_vae_tpu/cli/serve.py) ----

def _cover(rem: int, options: tuple) -> list:
    """Minimal covering of ``rem`` units by tier passes: DP over
    ``options`` of ``(units, rows, tier)`` minimizing lexicographic
    (total device rows, number of passes) with mixed tiers allowed —
    e.g. tiers [8, 32, 128] cover 68 rows as 32+32+8 (3 passes), not
    nine 8-row passes (the homogeneous covering with equal rows but 3x
    the per-pass relay round-trips). Units are scaled by their gcd so
    the DP length is tiers-granular, not row-granular."""
    g = 0
    for u, _, _ in options:
        g = math.gcd(g, u)
    need = -(-rem // g)
    opts = [(u // g, r, t) for u, r, t in options]
    inf = float("inf")
    best = [(0, 0, None, 0)] + [(inf, inf, None, 0)] * need
    for x in range(1, need + 1):
        b = (inf, inf, None, 0)
        for u, r, t in opts:
            prev = best[max(0, x - u)]
            cand = (prev[0] + r, prev[1] + 1, t, max(0, x - u))
            if cand[:2] < b[:2]:
                b = cand
        best[x] = b
    out, x = [], need
    while x > 0:
        _, _, t, x = best[x]
        out.append(t)
    return sorted(out, reverse=True)


def plan_cover(n: int, tiers: tuple) -> tuple:
    """Decompose an n-row job into warm-tier passes minimizing
    lexicographic (total device rows, passes)."""
    return plan_cover_blocks(n, tiers, 1)


@functools.lru_cache(maxsize=4096)
def plan_cover_blocks(nblocks: int, co_tiers: tuple, chunk: int) -> tuple:
    """Tier-pass covering of ``nblocks`` chunk-block units minimizing
    lexicographic (total device rows, passes), mixed tiers allowed.

    Large jobs peel whole largest-tier passes before the DP, but only
    down to ``big + F`` where every unit count >= F/g is exactly
    representable by tier multiples (Erdős–Graham bound 2*(t1/g)*(big/g)
    on the scaled Frobenius number) — peeling inside that region is
    provably rows-minimal, unlike a blind peel-to-big, which on a
    non-divisible ladder like (8, 12) would plan 16 rows as 12+8 instead
    of 8+8. Pathological ladders whose bound would blow the DP domain
    (>500k states) fall back to peel-to-big."""
    caps = {t: t // chunk for t in co_tiers}
    big = co_tiers[-1]
    cb = caps[big]
    g = 0
    for t in co_tiers:
        g = math.gcd(g, caps[t])
    stop = cb + 2 * (caps[co_tiers[0]] // g) * (cb // g) * g
    if stop // g > 500_000:
        stop = cb
    plan, rem = [], nblocks
    while rem >= max(stop, cb):
        plan.append(big)
        rem -= cb
    if rem:
        plan.extend(_cover(rem, tuple((caps[t], t, t) for t in co_tiers)))
    return tuple(plan)


# A request planned over the warm tiers alone may take at most this many
# times the passes of its plan over the whole ladder; beyond it, a 503 until
# the warm-up completes. 20 rows over a warm 8-row tier of (8, 32) still
# plan as [8, 8, 8] (the whole ladder's plan too); 1,000,000 rows need
# 125,000 passes there against 31,250.
WARM_PLAN_FACTOR = 2


def build_parser():
    p = argparse.ArgumentParser(description="Serve molecule generation over HTTP")
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--data", type=str, default=None,
                   help="Dataset JSON (stats + alphabet; else from "
                        "checkpoint)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--batch_size", type=int, default=4096,
                   help="Largest batch tier (single-tier form of "
                        "--batch_sizes)")
    p.add_argument("--batch_sizes", type=str, default=None,
                   help="Comma-separated batch tiers, e.g. "
                        "'256,2048,8192'. Requests route to the smallest "
                        "tier that fits; overrides --batch_size")
    p.add_argument("--max_length", type=int, default=64)
    p.add_argument("--max_molecules", type=int, default=1_000_000,
                   help="Reject larger requests instead of queueing them")
    p.add_argument("--no_normalize", action="store_true")
    p.add_argument("--calibrate_response", type=str, default=None,
                   metavar="A,B",
                   help="Invert a measured linear conditioning response "
                        "achieved = A + B*request on the FIRST condition "
                        "axis for every request: the model is conditioned "
                        "on (target - A)/B. Responses carry the "
                        "transformed value as 'calibrated_request'")
    p.add_argument("--truncation", action="append", default=None,
                   metavar="SPEC",
                   help="Serve a truncated-sampling config, e.g. "
                        "'top_k=6' or 'top_k=6,top_p=0.8' (repeatable). "
                        "Only declared configs are served")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--sync_warmup", action="store_true",
                   help="Warm every (tier, sampler config) pair before the "
                        "server binds. Default: warm the smallest tier, bind, "
                        "and warm the rest on a background thread; requests "
                        "plan over warm tiers until it completes")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda[:N] (the kernel) or cpu (its plain version)")
    add_cache_flags(p)
    return p


def parse_truncation(spec: str) -> tuple:
    """Parse one --truncation SPEC ('top_k=K[,top_p=P]') -> (top_k, top_p)."""
    tk, tp = 0, 1.0
    for part in spec.split(","):
        k, _, v = part.strip().partition("=")
        try:
            if k == "top_k":
                tk = int(v)
            elif k == "top_p":
                tp = float(v)
            else:
                raise ValueError
        except ValueError:
            raise SystemExit(f"bad --truncation entry {part.strip()!r} "
                             "(expected top_k=N and/or top_p=F)") from None
    if tk < 0 or not 0.0 < tp <= 1.0 or (tk, tp) == (0, 1.0):
        raise SystemExit(f"--truncation {spec!r}: need top_k > 0 and/or "
                         "top_p in (0, 1)")
    return tk, tp


class _DispatchError(RuntimeError):
    """A job failed on the dispatcher side (device error, or close()
    draining the queue) — an HTTP 500, never a 400."""


class _ColdLadderError(RuntimeError):
    """No warm tier can serve this request's sampler config — an HTTP 503
    with Retry-After, not a 500: the request is valid."""


def _pkey_name(pk) -> str:
    """``/health``'s name of a sampler config (greedy, top_k, top_p)."""
    return f"greedy={pk[0]},top_k={pk[1]},top_p={pk[2]}"


class _Job:
    """One /generate request in flight through the dispatcher."""

    __slots__ = ("n", "greedy", "temperature", "target_norm", "seed",
                 "top_k", "top_p",
                 "done", "tokens", "error", "dt", "passes", "coalesced")

    def __init__(self, n, greedy, temperature, target_norm, seed,
                 top_k=0, top_p=1.0):
        self.n = n
        self.greedy = greedy
        self.temperature = temperature
        self.target_norm = target_norm
        self.seed = seed
        self.top_k = top_k
        self.top_p = top_p
        self.done = threading.Event()
        self.tokens = None
        self.error = None
        self.dt = 0.0
        self.passes = 0
        self.coalesced = False

    @property
    def pkey(self):
        """Sampler config: (greedy, top_k, top_p)."""
        return (self.greedy, self.top_k, self.top_p)


def pass_seed(seed: int, pass_index: int) -> int:
    """The torch.Generator seed of one solo pass: a hash of (request seed,
    pass index), so passes of one request draw independent streams."""
    return int(np.random.SeedSequence([seed % 2**64, pass_index])
               .generate_state(1, np.uint64)[0])


# ---- the coalesced path's block streams ----

_SEED_TAG = 0x2545F491  # keys a block's sampler seed apart from its z draws


def _block_keys(seeds, blocks) -> torch.Tensor:
    """``[nb]`` int64 (CPU) stream keys, one per (request seed, block index)
    pair: ``mix(mix(mix(lo) ^ hi) ^ b)`` with ``lo``/``hi`` the 32-bit
    halves of the seed mod 2**64 and ``mix`` the sampler's lowbias32 hash."""
    from mlx_vae_tpu_torch.ops.fused_decoder import _mix

    s = np.asarray([int(v) % 2**64 for v in seeds], np.uint64)
    lo = torch.from_numpy((s & np.uint64(0xFFFFFFFF)).astype(np.int64))
    hi = torch.from_numpy((s >> np.uint64(32)).astype(np.int64))
    return _mix(_mix(_mix(lo) ^ hi) ^ torch.as_tensor(np.asarray(blocks, np.int64)))


def _draw_blocks(keys: torch.Tensor, chunk: int, latent_dim: int):
    """``(z [nb * chunk, latent_dim] f32, seeds [nb] int32)`` for block keys
    ``[nb]`` on their device: each z element is Box-Muller (in float64) of
    two uniforms hashed from (key, row in block, dim); each seed a hash of
    the key in ``[0, 2**31 - 1)``. Every value depends on its own block's
    key alone."""
    from mlx_vae_tpu_torch.ops.fused_decoder import _mix

    dev = keys.device
    seeds = (_mix(_mix(keys ^ _SEED_TAG)) % (2**31 - 1)).to(torch.int32)
    kr = _mix(keys[:, None] ^ torch.arange(chunk, dtype=torch.int64, device=dev))
    d2 = 2 * torch.arange(latent_dim, dtype=torch.int64, device=dev)
    u1 = (_mix(_mix(kr[..., None] ^ d2)).double() + 1.0) * 2.0**-32  # (0, 1]
    u2 = _mix(_mix(kr[..., None] ^ (d2 + 1))).double() * 2.0**-32   # [0, 1)
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
    return z.float().reshape(-1, latent_dim), seeds


def block_streams(seed: int, first_block: int, nblocks: int, chunk: int,
                  latent_dim: int, device):
    """Blocks ``[first_block, first_block + nblocks)`` of a request's
    canonical streams: ``(z [nblocks * chunk, latent_dim] float32, seeds
    [nblocks] int32)``. Block ``b``'s z rows and sampler seed are a pure
    function of (``seed``, ``b``), drawn for all blocks in one vectorized
    call; the same on every call on one device (not the JAX server's
    threefry draws, and not the same bits on the CPU and the card)."""
    blocks = np.arange(first_block, first_block + nblocks)
    keys = _block_keys([seed] * nblocks, blocks).to(device)
    return _draw_blocks(keys, chunk, latent_dim)


def greedy_row_independent(sampler: str, device: torch.device) -> bool:
    """Whether a greedy row's tokens depend on its own inputs alone, not on
    the pass it runs in: what greedy coalescing needs. The fused sampler
    computes each row alone (and the coalesced path gives it an ``h0`` of a
    fixed-shape product: on an H100 cuBLAS gives other bits at 8 rows than
    at 256). The scan sampler runs each step's products over the whole
    pass. The CPU tests hold its greedy rows coalesced against solo, and
    the JAX server coalesces them too; on an H100 a 2048-row pass changes
    rows against 256-row passes (ROADMAP "Contract differences"), so on
    CUDA they do not coalesce."""
    return sampler == "fused" or device.type != "cuda"


class GenerationService:
    """Checkpoint + prepared kernel weights + a tier ladder + the dispatcher."""

    def __init__(self, args):
        from mlx_vae_tpu_torch.cli.common import resolve_device, resolve_property_stats
        from mlx_vae_tpu_torch.cli.generate import infer_model_shape, parse_calibration
        from mlx_vae_tpu_torch.config import ModelConfig
        from mlx_vae_tpu_torch.models.vae import generation_sampler
        from mlx_vae_tpu_torch.ops.fused_decoder import block_rows, prepare_weights
        from mlx_vae_tpu_torch.train.checkpoint import load_checkpoint
        from mlx_vae_tpu_torch.utils.tree import params_from_numpy

        # Cheap flag validation BEFORE the checkpoint load.
        if args.batch_sizes:
            try:
                tiers = sorted({int(s) for s in args.batch_sizes.split(",")})
            except ValueError:
                raise SystemExit(
                    f"bad --batch_sizes {args.batch_sizes!r} (expected "
                    f"comma-separated ints, e.g. 256,2048,8192)") from None
        else:
            tiers = [args.batch_size]
        if any(t < 1 for t in tiers):
            raise SystemExit(f"batch tiers must be >= 1, got {tiers}")
        self.calib = None
        if args.calibrate_response is not None:
            try:
                self.calib = parse_calibration(args.calibrate_response)
            except ValueError:
                raise SystemExit("--calibrate_response must be 'A,B' "
                                 "(floats, B != 0), the fitted response "
                                 "line achieved = A + B*request") from None
        self.trunc_cfgs = sorted({parse_truncation(s)
                                  for s in (args.truncation or [])})
        self.device = resolve_device(args.device)

        ckpt = load_checkpoint(args.checkpoint)
        dec = ckpt["params"]["decoder"]
        self.shape = infer_model_shape(dec)
        # use_pallas as the JAX server sets it on its accelerator: the fused
        # sampler where it takes the config, else the scan sampler
        self.cfg = ModelConfig(compute_dtype=args.compute_dtype, use_pallas=True,
                               **self.shape)
        self.sampler = generation_sampler(self.cfg)
        self.mean, self.std, self.alphabet, _ = resolve_property_stats(
            args.data, args.no_normalize, ckpt, self.cfg.num_conditions)
        self.tiers = tiers
        self.batch = tiers[-1]  # legacy /health field: the largest tier
        self.max_length = args.max_length
        self.max_molecules = args.max_molecules
        self.pkeys = ([(False, 0, 1.0), (True, 0, 1.0)]
                      + [(False, tk, tp) for tk, tp in self.trunc_cfgs])

        # The route is the config's at every tier, so one flag says whether
        # a pass runs the fused sampler. Coalescing works in blocks of the
        # fused sampler's seed block (8 rows on the scan route); the
        # coalesced passes run only at tiers made of whole blocks.
        fused = self.sampler == "fused"
        self.chunk = block_rows(tiers[-1]) if fused else 8
        self.co_tiers = [t for t in tiers if t % self.chunk == 0]
        greedy_ok = greedy_row_independent(self.sampler, self.device)
        self._can_coalesce = {pk: bool(self.co_tiers) and (greedy_ok if pk[0] else fused)
                              for pk in self.pkeys}
        self.params = {"decoder": params_from_numpy(dec, self.device)}
        self.weights = (prepare_weights(self.params["decoder"], self.cfg, self.device)
                        if fused else None)

        self._pending = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        self._stats = {"device_passes": 0, "jobs": 0, "coalesced_jobs": 0}
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True)
        self._dispatcher.start()

        # Every (tier, sampler config) pair runs once before it serves. The
        # smallest tier warms here; the rest of the ladder (and the block
        # streams) on a daemon thread, or here too under --sync_warmup.
        self._warm = set()
        self._warm_done = threading.Event()
        self._warm_error = None
        self._co_warm = False  # the block streams ran once
        self._warmer = None
        t0 = time.perf_counter()
        for pk in self.pkeys:
            self._warm_one(self.tiers[0], pk)
        if args.sync_warmup:
            self._warm_rest()
            print(f"Warmed {len(self._warm)} (tier, sampler) pairs (tiers "
                  f"{self.tiers}, --sync_warmup) on {self.device} in "
                  f"{time.perf_counter() - t0:.1f}s")
        else:
            self._warmer = threading.Thread(target=self._warm_rest, daemon=True)
            self._warmer.start()
            print(f"Serving after warming the {self.tiers[0]}-row tier on "
                  f"{self.device} in {time.perf_counter() - t0:.1f}s; warming the "
                  f"rest of tiers {self.tiers} in the background")

    # ---- warm-up ----

    def _warm_one(self, tier, pk):
        """Run (tier, sampler config) once and mark it warm."""
        job = _Job(1, pk[0], 1.0,
                   np.zeros((1, self.cfg.num_conditions), np.float32), 0,
                   top_k=pk[1], top_p=pk[2])
        self._run_solo(job, forced_tier=tier, count_stats=False)
        self._warm.add((tier,) + pk)

    def _warm_rest(self):
        """Warm the remaining pairs smallest tier first, then the block
        streams. A failure is recorded (``/health`` ``warmup.error``) and
        leaves its pair cold; the warm-up ends either way."""
        try:
            for t in self.tiers:
                for pk in self.pkeys:
                    if self._closed:
                        return
                    if (t,) + pk not in self._warm:
                        try:
                            self._warm_one(t, pk)
                        except Exception as e:
                            self._warm_failed(f"tier {t} {_pkey_name(pk)}", e)
            if self.co_tiers and not self._closed:
                try:
                    x = self._block_inputs([_Job(1, False, 1.0, np.zeros(
                        (1, self.cfg.num_conditions), np.float32), 0)])[0]
                    x.sum().item()
                    self._co_warm = True
                except Exception as e:
                    self._warm_failed("block streams", e)
        finally:
            self._warm_done.set()

    def _warm_failed(self, what: str, e: Exception):
        msg = f"{what}: {type(e).__name__}: {e}"
        print(f"WARNING: warm-up failed, {msg}", flush=True)
        if self._warm_error is None:
            self._warm_error = msg

    def wait_warm(self, timeout=None) -> bool:
        """Block until the warm-up has ended (the whole ladder and the block
        streams warm, unless ``/health`` shows an error)."""
        return self._warm_done.wait(timeout)

    # ---- planning ----

    def _padded(self, n: int) -> int:
        return -(-n // self.chunk) * self.chunk

    def plan_passes(self, n: int) -> list[int]:
        """Pass decomposition for n molecules over the whole ladder."""
        return list(plan_cover(n, tuple(self.tiers)))

    def _plan_warm(self, job) -> list[int]:
        """Pass plan over the tiers warm for this job's sampler config
        (``plan_passes`` once the ladder is warm). A 503 where no tier is
        warm, or where the plan needs more than ``WARM_PLAN_FACTOR`` times
        the passes of the full ladder's: such a job would hold the one
        dispatcher while the tier it needs warms."""
        warm = tuple(t for t in self.tiers if (t,) + job.pkey in self._warm)
        if not warm:
            raise _ColdLadderError(
                f"no warm tier for sampler config greedy={job.pkey[0]} "
                f"top_k={job.pkey[1]} top_p={job.pkey[2]} yet "
                f"(background warm-up running)")
        plan = list(plan_cover(job.n, warm))
        full = len(plan_cover(job.n, tuple(self.tiers)))
        if len(plan) > WARM_PLAN_FACTOR * full:
            raise _ColdLadderError(
                f"{job.n} molecules need {len(plan)} passes over the warm tiers "
                f"{list(warm)} against {full} over the whole ladder; retry once "
                f"warm-up completes")
        return plan

    def _plan_blocks(self, nblocks: int) -> list[int]:
        """Coalescible-tier pass plan for nblocks chunk-blocks."""
        return list(plan_cover_blocks(nblocks, tuple(self.co_tiers), self.chunk))

    # ---- dispatcher ----

    def _eligible(self, job) -> bool:
        """Can this job run on the block-canonical coalesced path? Only once
        the warm-up has ended with every coalescible tier of its config and
        the block streams warm; before that every job runs solo over warm
        tiers."""
        return (self._warm_done.is_set() and self._co_warm
                and self._can_coalesce[job.pkey]
                and self._padded(job.n) <= self.co_tiers[-1]
                and all((t,) + job.pkey in self._warm for t in self.co_tiers))

    def close(self, timeout: float = 30.0):
        """Stop the dispatcher and the warm-up threads. Queued-but-unstarted
        jobs fail with an error (their clients unblock) rather than
        hanging."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            drained = list(self._pending)
            self._pending.clear()
            self._cv.notify_all()
        for j in drained:
            j.error = RuntimeError("service closed")
            j.done.set()
        for t in (self._dispatcher, self._warmer):
            if t is not None and t is not threading.current_thread():
                t.join(timeout)

    def _dispatch_loop(self):
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if self._closed:
                    return
                job = self._pending.popleft()
                group = [job]
                coalesce = self._eligible(job)
                if coalesce:
                    # pull every already-waiting job of the same config
                    # while the group fits the largest coalescible tier (no
                    # artificial wait: batch what is queued)
                    cap = self.co_tiers[-1]
                    rows = self._padded(job.n)
                    keep = collections.deque()
                    while self._pending:
                        nxt = self._pending.popleft()
                        nrows = self._padded(nxt.n)
                        if (nxt.pkey == job.pkey and self._eligible(nxt)
                                and nrows <= cap - rows):
                            group.append(nxt)
                            rows += nrows
                        else:
                            keep.append(nxt)
                    self._pending.extendleft(reversed(keep))
            try:
                if coalesce:
                    self._run_coalesced(group)
                else:
                    self._run_solo(job)
            except Exception as e:  # surface to every waiting client
                for j in group:
                    j.error = e
            finally:
                for j in group:
                    j.done.set()

    def _run_solo(self, job, forced_tier=None, count_stats=True):
        """Serial tiered passes for one job (also runs the warm-up)."""
        from mlx_vae_tpu_torch.models.vae import vae_generate

        out, t0 = [], time.perf_counter()
        passes = ([forced_tier] if forced_tier is not None
                  else self._plan_warm(job))
        tn = torch.as_tensor(np.asarray(job.target_norm, np.float32)
                             .reshape(1, -1), device=self.device)
        rem = job.n
        for p, tier in enumerate(passes):
            take = min(rem, tier)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(pass_seed(job.seed, p))
            cond = tn.expand(tier, self.cfg.num_conditions).contiguous()
            toks = vae_generate(self.params, self.cfg, cond, gen,
                                max_length=self.max_length,
                                temperature=job.temperature,
                                greedy=job.greedy, top_k=job.top_k,
                                top_p=job.top_p, weights=self.weights)
            # Quarter the device->host transfer when ids fit a byte.
            if self.cfg.vocab_size < 256:
                toks = toks.to(torch.uint8)
            out.append(toks[:take])
            rem -= take
        job.tokens = torch.cat(out).cpu().numpy()[:job.n]
        job.dt = time.perf_counter() - t0
        job.passes = len(passes)
        if count_stats:  # warm-up runs don't count as served jobs
            self._stats["device_passes"] += len(passes)
            self._stats["jobs"] += 1

    def _block_inputs(self, group):
        """The group's blocks end to end on the device: ``(x, cond, seeds,
        temps, nbs)``, ``x`` each block's ``h0`` (fused sampler) or ``z``
        (scan sampler) ``[rows, *]``, ``cond [rows, C]``, ``seeds`` and
        ``temps [blocks]``, ``nbs`` the blocks of each job. A block's ``h0``
        is one product of the fixed shape ``[chunk, latent]``, so its bits
        do not depend on the pass or the group it runs in."""
        from mlx_vae_tpu_torch.models.decoder import hidden_init_row

        C, ch, dev = self.cfg.num_conditions, self.chunk, self.device
        nbs = [-(-j.n // ch) for j in group]
        keys = _block_keys([j.seed for j, nb in zip(group, nbs) for _ in range(nb)],
                           np.concatenate([np.arange(nb) for nb in nbs]))
        z, seeds = _draw_blocks(keys.to(dev), ch, self.cfg.latent_dim)
        cond = torch.as_tensor(np.repeat(
            np.stack([np.asarray(j.target_norm, np.float32).reshape(-1)[:C] for j in group]),
            np.asarray(nbs) * ch, axis=0), device=dev)
        temps = torch.as_tensor(np.repeat(
            np.asarray([j.temperature for j in group], np.float32), nbs), device=dev)
        if self.sampler == "fused":
            dec = self.params["decoder"]
            z = torch.cat([hidden_init_row(dec, self.cfg, zb, cb)
                           for zb, cb in zip(z.split(ch), cond.split(ch))])
        return z, cond, seeds, temps, nbs

    def _run_coalesced(self, group):
        """Serve every job of ``group`` (one sampler config) through shared
        passes: the jobs' blocks laid end to end, cut into coalescible-tier
        passes (``plan_cover_blocks``), a partial pass padded with zero rows
        (zero ``h0`` or ``z``, zero conditions), seed 0 and temperature 1.0,
        the rows reassembled per job. Each job's ``dt`` is its row share of
        the group's wall clock, so per-request ``mols_per_sec`` sums to the
        device rate. The scan sampler only ever gets greedy groups here."""
        from mlx_vae_tpu_torch.models.sampling import generate_with_temperature
        from mlx_vae_tpu_torch.ops.fused_decoder import fused_generate

        t0 = time.perf_counter()
        greedy, top_k, top_p = group[0].pkey
        ch = self.chunk
        x, cond, seeds, temps, nbs = self._block_inputs(group)
        nblocks = sum(nbs)
        plan = self._plan_blocks(nblocks)
        outs, boff = [], 0
        for tier in plan:
            cap = tier // ch
            nsel = min(cap, nblocks - boff)
            r0, rows = boff * ch, nsel * ch
            xp = torch.nn.functional.pad(x[r0:r0 + rows], (0, 0, 0, tier - rows))
            cp = torch.nn.functional.pad(cond[r0:r0 + rows], (0, 0, 0, tier - rows))
            if self.sampler == "fused":
                sp = torch.nn.functional.pad(seeds[boff:boff + nsel], (0, cap - nsel))
                tp = torch.nn.functional.pad(temps[boff:boff + nsel], (0, cap - nsel),
                                             value=1.0)
                toks = fused_generate(self.weights, xp, cp, sp, tp, self.max_length,
                                      greedy=greedy, top_k=top_k, top_p=top_p)
            else:
                toks = generate_with_temperature(self.params["decoder"], self.cfg, xp, cp,
                                                 max_length=self.max_length, greedy=True)
            if self.cfg.vocab_size < 256:
                toks = toks.to(torch.uint8)
            outs.append(toks[:rows])
            boff += nsel
        rows_all = torch.cat(outs).cpu().numpy()
        dt = time.perf_counter() - t0
        off = 0
        for job, nb in zip(group, nbs):
            job.tokens = rows_all[off:off + job.n]
            off += nb * ch
            job.dt = dt * nb / nblocks
            job.passes = len(plan)
            job.coalesced = len(group) > 1
        self._stats["device_passes"] += len(plan)
        self._stats["jobs"] += len(group)
        if len(group) > 1:
            self._stats["coalesced_jobs"] += len(group)

    # ---- request surface ----

    @staticmethod
    def _number(req: dict, field: str, default, kind):
        """Fetch a numeric request field, rejecting JSON booleans and
        non-integral values for int fields."""
        v = req.get(field, default)
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise ValueError(f"{field} must be a number, got {v!r}")
        if kind is int and not float(v).is_integer():
            raise ValueError(f"{field} must be an integer, got {v!r}")
        return kind(v)

    def generate(self, req: dict) -> dict:
        from mlx_vae_tpu_torch.cli.common import normalized_targets
        from mlx_vae_tpu_torch.data.metrics import uniqueness
        from mlx_vae_tpu_torch.data.prepare import decode_tokens, selfies_validity

        n = req.get("num_molecules", 100)
        if isinstance(n, bool) or not isinstance(n, int) \
                or not 1 <= n <= self.max_molecules:
            raise ValueError(f"num_molecules must be an int in "
                             f"[1, {self.max_molecules}], got {n!r}")
        temperature = self._number(req, "temperature", 1.0, float)
        if temperature <= 0:
            raise ValueError(f"temperature must be > 0, got {temperature}")
        greedy = bool(req.get("greedy", False))
        top_k = self._number(req, "top_k", 0, int)
        top_p = self._number(req, "top_p", 1.0, float)
        if (top_k, top_p) != (0, 1.0):
            if greedy:
                raise ValueError("top_k/top_p have no effect with "
                                 "greedy=true (argmax ignores truncation)")
            if (top_k, top_p) not in set(self.trunc_cfgs):
                raise ValueError(
                    f"truncation (top_k={top_k}, top_p={top_p}) is not "
                    f"declared; served configs: {self.trunc_cfgs or 'none'} "
                    f"— start the server with --truncation "
                    f"'top_k=K,top_p=P', or use generate.py")
        max_selfies = self._number(req, "max_selfies", 1000, int)
        if max_selfies < 0:
            raise ValueError(f"max_selfies must be >= 0, got {max_selfies}")
        target = req.get("target", [90.0])
        if not isinstance(target, list) or any(
                isinstance(t, bool) or not isinstance(t, (int, float))
                for t in target):
            raise ValueError(f"target must be a list of numbers, got {target!r}")
        target = [float(t) for t in target]
        model_target = list(target)
        if self.calib is not None and model_target:
            ca, cb = self.calib
            model_target[0] = (model_target[0] - ca) / cb
        tn = normalized_targets(model_target, self.mean, self.std,
                                self.cfg.num_conditions)
        seed = self._number(req, "seed", 0, int)

        job = _Job(n, greedy, temperature, tn, seed, top_k=top_k, top_p=top_p)
        with self._cv:
            if self._closed:
                raise _DispatchError("service closed")
            self._pending.append(job)
            self._cv.notify()
        job.done.wait()
        if job.error is not None:
            if isinstance(job.error, _ColdLadderError):
                raise job.error  # handler maps to 503 + Retry-After
            raise _DispatchError(
                f"{type(job.error).__name__}: {job.error}") from job.error
        tokens = job.tokens

        out = {
            "num_molecules": int(n),
            "target": target,
            **({"calibrated_request": round(model_target[0], 2)}
               if self.calib is not None and model_target else {}),
            "temperature": temperature,
            "greedy": greedy,
            "top_k": top_k,
            "top_p": top_p,
            "mols_per_sec": n / max(job.dt, 1e-9),
            "passes": job.passes,
            "coalesced": job.coalesced,
            "validity": selfies_validity(tokens, self.alphabet or []),
            "uniqueness": uniqueness(tokens),
        }
        if self.alphabet:
            out["selfies"] = [decode_tokens(t, self.alphabet)
                              for t in tokens[:max_selfies]]
        if req.get("return_tokens"):
            out["tokens"] = tokens.tolist()
        return out

    def health(self) -> dict:
        from mlx_vae_tpu_torch.ops.fused_decoder import fused_generate, fused_generate_route

        total = len(self.tiers) * len(self.pkeys)
        return {"status": "ok", "model": self.shape,
                "warmup": {
                    "complete": self._warm_done.is_set() and len(self._warm) == total,
                    "warm_programs": len(self._warm),
                    "total_programs": total,
                    "warm_tiers": {
                        _pkey_name(pk): [t for t in self.tiers if (t,) + pk in self._warm]
                        for pk in self.pkeys},
                    "error": self._warm_error},
                "batch_size": self.batch, "batch_tiers": self.tiers,
                "calibrate_response": list(self.calib) if self.calib
                else None,
                "truncation_configs": [list(c) for c in self.trunc_cfgs],
                "coalescing": {
                    "stochastic": self._can_coalesce[(False, 0, 1.0)],
                    "greedy": self._can_coalesce[(True, 0, 1.0)],
                    "truncated": {f"top_k={tk},top_p={tp}": self._can_coalesce[(False, tk, tp)]
                                  for tk, tp in self.trunc_cfgs},
                    "block_rows": self.chunk},
                "stats": dict(self._stats),
                "sampler": self.sampler,
                "sampler_route": (fused_generate_route(self.cfg) if self.sampler == "fused"
                                  else None),
                "kernel_launches": fused_generate.launches,
                "max_length": self.max_length,
                "backend": self.device.type,
                "device": (torch.cuda.get_device_name(self.device)
                           if self.device.type == "cuda" else "cpu"),
                "alphabet_size": len(self.alphabet or [])}


def make_handler(service: GenerationService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict, headers: dict = None):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._send(200, service.health())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("request body must be a JSON object")
                payload = service.generate(req)
            except _ColdLadderError as e:
                self._send(503, {"error": str(e), "retry_after": 60},
                           headers={"Retry-After": "60"})
                return
            except _DispatchError as e:
                # Dispatcher-side failures are the SERVER's fault: a JSON
                # 500, never a 400 even when the underlying error is a
                # ValueError.
                self._send(500, {"error": str(e)})
                return
            except (ValueError, TypeError, KeyError, json.JSONDecodeError,
                    SystemExit) as e:
                self._send(400, {"error": str(e)})
                return
            # The 200 write sits OUTSIDE the try: a send failure must not
            # trigger a second response onto a half-written stream.
            self._send(200, payload)

        def log_message(self, fmt, *fmt_args):  # quiet per-request stderr
            pass

    return Handler


class _Server(ThreadingHTTPServer):
    """The stdlib threading server with a listen backlog of 128 (not 5), so
    a burst of concurrent clients, which coalescing batches, queues instead
    of being refused."""

    request_queue_size = 128


def serve_forever(args, ready_event=None):
    """Build the service, bind, and serve. ``ready_event`` (tests, smoke
    runs) is set once the socket is bound (the smallest tier warm, or every
    tier under ``--sync_warmup``); the bound server and the service are
    stashed on it for shutdown."""
    service = GenerationService(args)
    server = _Server((args.host, args.port), make_handler(service))
    if ready_event is not None:
        ready_event.server = server
        ready_event.service = service
        ready_event.set()
    print(f"Serving on http://{server.server_address[0]}:"
          f"{server.server_address[1]} (POST /generate, GET /health)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()


def main(argv=None):
    serve_forever(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
