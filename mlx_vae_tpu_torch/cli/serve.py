#!/usr/bin/env python3
"""Molecule-generation server (counterpart of ``mlx_vae_tpu/cli/serve.py``).

``python -m mlx_vae_tpu_torch.cli.serve --checkpoint ck.npz --device cuda``.
Stdlib HTTP (``http.server``) over a trained checkpoint, with the JAX
server's flags, endpoints, field names and 400/500/503 mapping:

* **Size tiers**: requests route to the smallest tier of the ladder
  (``--batch_sizes``, e.g. ``256,2048,8192``) that fits; larger requests
  decompose into several passes (``plan_cover``). Every (tier, sampler
  config) pair runs once at startup, which builds the kernel and warms the
  device; there is no compile to hide, so ``--sync_warmup`` is accepted and
  changes nothing.
* **One device, one dispatcher**: a single dispatcher thread owns the
  device; handler threads enqueue jobs and wait, so health checks never
  queue behind generation.
* **Per-pass streams**: pass ``p`` of a request draws its z, sampler seeds
  and temperatures from a ``torch.Generator`` seeded from (request seed,
  p), so a seeded request is reproducible on the same device.
* **Sampler by config**: the fused sampler where the kernel takes the
  model, else the scan sampler (``models/vae.py:generation_sampler``), as
  the JAX server routes on its accelerator; ``/health`` reports it as
  ``"sampler"``.
* Request coalescing and background warm-up are not ported yet; ``/health``
  reports ``coalescing`` as false for every sampler config.

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
                   help="Accepted for the JAX server's flag surface: every "
                        "tier is warmed before serving either way")
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
    """The torch.Generator seed of one pass: a hash of (request seed, pass
    index), so passes of one request draw independent streams."""
    return int(np.random.SeedSequence([seed % 2**64, pass_index])
               .generate_state(1, np.uint64)[0])


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
        self.chunk = block_rows(tiers[-1])
        self.params = {"decoder": params_from_numpy(dec, self.device)}
        self.weights = (prepare_weights(self.params["decoder"], self.cfg, self.device)
                        if self.sampler == "fused" else None)

        self._pending = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        self._stats = {"device_passes": 0, "jobs": 0, "coalesced_jobs": 0}
        self._warm = set()
        t0 = time.perf_counter()
        for t in self.tiers:
            for pk in self.pkeys:
                self._warm_one(t, pk)
        print(f"Warmed {len(self._warm)} (tier, sampler) pairs (tiers "
              f"{self.tiers}) on {self.device} in "
              f"{time.perf_counter() - t0:.1f}s")
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True)
        self._dispatcher.start()

    def _warm_one(self, tier, pk):
        """Run (tier, sampler config) once and mark it warm."""
        job = _Job(1, pk[0], 1.0,
                   np.zeros((1, self.cfg.num_conditions), np.float32), 0,
                   top_k=pk[1], top_p=pk[2])
        self._run_solo(job, forced_tier=tier, count_stats=False)
        self._warm.add((tier,) + pk)

    # ---- planning ----

    def plan_passes(self, n: int) -> list[int]:
        """Pass decomposition for n molecules over the ladder."""
        return list(plan_cover(n, tuple(self.tiers)))

    def _plan_warm(self, job) -> list[int]:
        """Pass plan over the tiers warm for this job's sampler config."""
        warm = tuple(t for t in self.tiers if (t,) + job.pkey in self._warm)
        if not warm:
            raise _ColdLadderError(
                f"no warm tier for sampler config greedy={job.pkey[0]} "
                f"top_k={job.pkey[1]} top_p={job.pkey[2]}")
        return list(plan_cover(job.n, warm))

    # ---- dispatcher ----

    def close(self, timeout: float = 30.0):
        """Stop the dispatcher thread. Queued-but-unstarted jobs fail with
        an error (their clients unblock) rather than hanging."""
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
        if self._dispatcher is not threading.current_thread():
            self._dispatcher.join(timeout)

    def _dispatch_loop(self):
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if self._closed:
                    return
                job = self._pending.popleft()
            try:
                self._run_solo(job)
            except Exception as e:  # surface to the waiting client
                job.error = e
            finally:
                job.done.set()

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
        from mlx_vae_tpu_torch.ops.fused_decoder import fused_generate

        total = len(self.tiers) * len(self.pkeys)
        return {"status": "ok", "model": self.shape,
                "warmup": {
                    "complete": len(self._warm) == total,
                    "warm_programs": len(self._warm),
                    "total_programs": total,
                    "warm_tiers": {
                        f"greedy={pk[0]},top_k={pk[1]},top_p={pk[2]}":
                        [t for t in self.tiers if (t,) + pk in self._warm]
                        for pk in self.pkeys}},
                "batch_size": self.batch, "batch_tiers": self.tiers,
                "calibrate_response": list(self.calib) if self.calib
                else None,
                "truncation_configs": [list(c) for c in self.trunc_cfgs],
                "coalescing": {
                    "stochastic": False,
                    "greedy": False,
                    "truncated": {f"top_k={tk},top_p={tp}": False
                                  for tk, tp in self.trunc_cfgs},
                    "block_rows": self.chunk},
                "stats": dict(self._stats),
                "sampler": self.sampler,
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


def serve_forever(args, ready_event=None):
    """Build the service, bind, and serve. ``ready_event`` (tests, smoke
    runs) is set once the socket is bound and every tier is warm; the bound
    server and the service are stashed on it for shutdown."""
    service = GenerationService(args)
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(service))
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
