"""The fused sampler's routes and its plain version, timed in turns on the card.

    python -m mlx_vae_tpu_torch.bench_sampler_routes \\
        --configs 1024:4:80,768:2:80 --dtypes bfloat16,float32 \\
        --batches 256,2048,8192 --routes cuda_core,plain

A config is ``H:n:V`` (E=128, C=1, latent 128 as the default model; random
weights from ``--seed``). For every config, dtype and batch the routes named
(``tc``, ``steps``, ``cuda_core`` forced through ``fused_generate(kernel=)``,
and ``plain``: ``fused_generate_reference`` on the card) run at L=64, T=0.8,
each after one warm-up call at the first batch, in the order given and then
reversed, each time the mean of ``--reps`` calls between CUDA events; the
line keeps the smaller of the two. A call's time is predicted from the
route's last one (per row): a route predicted above ``--once_above_s`` is
timed by one call a turn, and above ``--one_turn_above_s`` by one call in
the first turn alone. A route the config does not take is skipped with a
note. Beside each time: the bound of the route's work (the larger of
the operations over the route's peak and the bytes over 3.35 TB/s; bf16 on
the tensor cores at 989 TFLOP/s, f32 as split-TF32 at 495 / 3, the CUDA-core
kernel and the plain version's f32 at 67), and mols/s. Prints one JSON line,
``{"sampler_routes": [...], "smi": "<name, power limit>"}``, and writes it
to ``--output`` if given. ``--agree`` prints instead each route's token
agreement with the plain version and with the other routes at ``--top_k``
/ ``--top_p`` (T=0.8), beside the first step's logit spread, the gap at the
k-th logit and the plain rows' length.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

PEAK = {"bfloat16": 989e12, "split_tf32": 495e12 / 3, "float32": 67e12}
PEAK_BYTES = 3.35e12


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def parse_config(spec: str, dtype: str):
    from mlx_vae_tpu_torch.config import ModelConfig

    H, n, V = (int(x) for x in spec.split(":"))
    return ModelConfig(hidden_dim=H, num_layers=n, vocab_size=V, compute_dtype=dtype)


def sampler_flops(cfg, B: int, L: int) -> float:
    """Multiply-adds x 2 of one pass: every layer's gate product and the
    vocab head, for B rows over L steps."""
    E, C, H, V, n = (cfg.embedding_dim, cfg.num_conditions, cfg.hidden_dim, cfg.vocab_size,
                     cfg.num_layers)
    macs = (E + C + H) * 4 * H + (n - 1) * 2 * H * 4 * H + H * V
    return 2.0 * macs * B * L


def sampler_bytes(cfg, B: int, L: int) -> float:
    """Each input read once, the tokens written once: the weights in the
    compute dtype, h0 and the conditions in f32, the int32 tokens."""
    E, C, H, V, n = (cfg.embedding_dim, cfg.num_conditions, cfg.hidden_dim, cfg.vocab_size,
                     cfg.num_layers)
    es = 2 if cfg.compute_dtype == "bfloat16" else 4
    w = ((E + C + H) * 4 * H + (n - 1) * 2 * H * 4 * H + H * V + V * E) * es
    return w + B * (H + C) * 4 + B * L * 4


def route_bound(cfg, B: int, L: int, route: str) -> tuple:
    """(bound ms, "operations" or "bytes") of one pass on ``route``: the
    tensor-core routes at bf16's or split-TF32's rate, the CUDA-core kernel
    and the plain version's f32 at the CUDA cores' f32 rate (bf16 weights
    are widened to f32 before their products there)."""
    peak = "float32"
    if route in ("tc", "steps"):
        peak = "bfloat16" if cfg.compute_dtype == "bfloat16" else "split_tf32"
    t_ops = sampler_flops(cfg, B, L) / PEAK[peak]
    t_bytes = sampler_bytes(cfg, B, L) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def timed_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def model(cfg, seed: int, routes):
    """Random-init params on the card and their prepared weights, with the
    step route's operands where ``routes`` names it."""
    from mlx_vae_tpu_torch.models.decoder import init_decoder_params
    from mlx_vae_tpu_torch.ops.fused_decoder import prepare_weights
    from mlx_vae_tpu_torch.utils.tree import params_from_numpy, params_to_numpy

    params = params_from_numpy(params_to_numpy(
        init_decoder_params(torch.Generator().manual_seed(seed), cfg)), "cuda")
    kernel = "steps" if "steps" in routes else None
    return params, prepare_weights(params, cfg, "cuda", kernel=kernel)


def inputs(cfg, params, B: int, temperature: float, seed: int):
    from mlx_vae_tpu_torch.models.decoder import hidden_init_row
    from mlx_vae_tpu_torch.ops.fused_decoder import block_rows

    g = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.randn((B, cfg.latent_dim), generator=g, device="cuda")
    cond = torch.randn((B, cfg.num_conditions), generator=g, device="cuda")
    nb = -(-B // block_rows(B))
    seeds = torch.randint(0, 2**31 - 1, (nb,), generator=g, device="cuda", dtype=torch.int32)
    temps = torch.full((nb,), temperature, device="cuda")
    return hidden_init_row(params, cfg, z, cond).contiguous(), cond.contiguous(), seeds, temps


def runner(w, args, route: str):
    from mlx_vae_tpu_torch.ops import fused_decoder as fd

    if route == "plain":
        return lambda: fd.fused_generate_reference(w, *args)
    return lambda: fd.fused_generate(w, *args, kernel=route)


def refusal(cfg, route: str):
    """Why ``route`` does not take ``cfg``, or None."""
    from mlx_vae_tpu_torch.ops import fused_decoder as fd

    if route == "plain":
        return None
    if route not in fd.KERNELS:
        return f"no route {route!r} in this tree"
    try:
        fd.fused_generate_route(cfg, kernel=route)
    except NotImplementedError as e:
        return str(e)
    return None


def bench(spec: str, dtype: str, batches, routes, L: int, temperature: float, reps: int,
          once_above_s: float, one_turn_above_s: float, seed: int, smi: str) -> list:
    cfg = parse_config(spec, dtype)
    out, live, per_row = [], [], {}
    for route in routes:
        why = refusal(cfg, route)
        if why is None:
            live.append(route)
        else:
            print(f"  {spec} {dtype}: {route} skipped: {why}", flush=True)
    params, w = model(cfg, seed, live)
    for B in batches:
        args = inputs(cfg, params, B, temperature, seed + B) + (L,)
        fns = {r: runner(w, args, r) for r in live}
        for r in live:
            if r not in per_row:  # warm-up (builds the kernels), and the first prediction
                t0 = time.perf_counter()
                fns[r]()
                torch.cuda.synchronize()
                per_row[r] = (time.perf_counter() - t0) / B
        guess = {r: per_row[r] * B for r in live}
        n = {r: 1 if guess[r] > once_above_s else reps for r in live}
        ms = {r: [] for r in live}
        for i, r in enumerate(live + live[::-1]):
            if i < len(live) or guess[r] <= one_turn_above_s:
                ms[r].append(timed_ms(fns[r], n[r]))
        for r in live:
            per_row[r] = min(ms[r]) / 1e3 / B
            bound, by = route_bound(cfg, B, L, r)
            rec = dict(config=spec, H=cfg.hidden_dim, n=cfg.num_layers, V=cfg.vocab_size,
                       dtype=dtype, B=B, L=L, T=temperature, route=r, ms=min(ms[r]),
                       ms_each=ms[r], calls_each=n[r], mols_per_s=B / min(ms[r]) * 1e3,
                       bound_ms=bound, bound_by=by)
            out.append(rec)
            print(f"  {spec} {dtype} B={B}: {r} {min(ms[r]):.3f} ms "
                  f"({' / '.join(f'{x:.3f}' for x in ms[r])}, {n[r]} call(s) each), bound "
                  f"{bound:.3f} ({by}) [{smi}]", flush=True)
    return out


def agree(spec: str, dtype: str, batches, routes, L: int, temperature: float, top_k: int,
          top_p: float, seed: int, smi: str) -> list:
    """``--agree``: each route's tokens against the plain version's and
    against each other (the share of equal first tokens and of equal rows)
    at top-k / top-p, with what decides how often a kept set can flip: the
    first step's scaled logits (their spread in a row, the gap between the
    k-th and (k+1)-th largest) and the plain rows' length to the end
    token."""
    from mlx_vae_tpu_torch.ops import fused_decoder as fd

    cfg = parse_config(spec, dtype)
    live = [r for r in routes if r != "plain" and refusal(cfg, r) is None]
    params, w = model(cfg, seed, live)
    out = []
    for B in batches:
        h0, cond, seeds, temps = inputs(cfg, params, B, temperature, seed + B)
        lp = torch.empty((B, cfg.vocab_size), device="cuda")
        toks = {"plain": fd.fused_generate_reference(w, h0, cond, seeds, temps, L,
                                                     top_k=top_k, top_p=top_p, logits_out=lp)}
        for r in live:
            toks[r] = fd.fused_generate(w, h0, cond, seeds, temps, L, top_k=top_k, top_p=top_p,
                                        kernel=r)
        top = lp.topk(min(top_k + 1, cfg.vocab_size), dim=1).values
        gap = (top[:, -2] - top[:, -1]) if top_k else top[:, 0] - top[:, 1]
        ended = (toks["plain"] == cfg.end_token).int().cumsum(1) > 0
        pairs = {}
        names = ["plain"] + live
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                pairs[f"{b} vs {a}"] = ((toks[a][:, 0] == toks[b][:, 0]).float().mean().item(),
                                        (toks[a] == toks[b]).all(1).float().mean().item())
        rec = dict(config=spec, dtype=dtype, B=B, L=L, T=temperature, top_k=top_k, top_p=top_p,
                   seed=seed, logit_std=lp.std(dim=1).mean().item(),
                   kth_gap_median=gap.median().item(),
                   kth_gap_below_1e4=(gap < 1e-4).float().mean().item(),
                   row_length=(L - ended.sum(1)).float().mean().item() + 1, agreement=pairs)
        out.append(rec)
        print(f"  {spec} {dtype} B={B} seed {seed}: logit std {rec['logit_std']:.4f}, gap at k "
              f"median {rec['kth_gap_median']:.3e} (< 1e-4 in {rec['kth_gap_below_1e4']:.2%}), "
              f"plain rows {rec['row_length']:.1f} tokens; first / rows: "
              + "; ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in pairs.items())
              + f" [{smi}]", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default="1024:4:80")
    ap.add_argument("--dtypes", default="bfloat16,float32")
    ap.add_argument("--batches", default="256,2048,8192")
    ap.add_argument("--routes", default="steps,cuda_core,plain")
    ap.add_argument("--length", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--once_above_s", type=float, default=2.0)
    ap.add_argument("--one_turn_above_s", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--agree", action="store_true",
                    help="token agreement of the routes with the plain version and each other "
                         "at --top_k / --top_p, instead of times")
    ap.add_argument("--top_k", type=int, default=6)
    ap.add_argument("--top_p", type=float, default=0.8)
    ap.add_argument("--output", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_sampler_routes: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = smi_line()
    recs = []
    batches, routes = [int(b) for b in args.batches.split(",")], args.routes.split(",")
    for spec in args.configs.split(","):
        for dtype in args.dtypes.split(","):
            if args.agree:
                recs += agree(spec, dtype, batches, routes, args.length, args.temperature,
                              args.top_k, args.top_p, args.seed, smi)
            else:
                recs += bench(spec, dtype, batches, routes, args.length, args.temperature,
                              args.reps, args.once_above_s, args.one_turn_above_s, args.seed,
                              smi)
    line = json.dumps({"sampler_routes": recs, "smi": smi})
    print(line)
    if args.output:
        with open(args.output, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
