#!/usr/bin/env python3
"""Latent-space molecular design CLI (counterpart of
``mlx_vae_tpu/cli/optimize.py``).

``python -m mlx_vae_tpu_torch.cli.optimize --checkpoint ck.npz --target 90``
with the JAX CLI's flags, on one device (``--device``, default ``cuda``;
``cpu`` runs the sampler's plain version). A batch of latent candidates is
drawn from the prior, descends ``||predictor(z) - target||^2`` plus a
quadratic prior term by Adam (``models/latent_opt.py``), and is decoded
under the target as its condition (``cli/generate.py:make_generate_fn``),
then scored by validity and uniqueness. The checkpoint needs the property
predictor head (``--use_property_predictor`` at training).

``z0`` and the decode's draws come from one ``torch.Generator`` on the
device, seeded with ``--seed``: torch's Philox draws are not JAX's
threefry draws, so the candidates differ from the JAX CLI's for the same
seed. The output JSON has the JAX CLI's keys.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from mlx_vae_tpu_torch.cli.common import add_cache_flags


def build_parser():
    p = argparse.ArgumentParser(
        description="Optimize latent candidates toward target properties, "
                    "then decode them")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="Path to a .npz checkpoint trained with "
                        "--use_property_predictor")
    p.add_argument("--data", type=str, default=None,
                   help="Dataset JSON (for property normalization stats + "
                        "alphabet)")
    p.add_argument("--target", type=float, nargs="+", default=[90.0],
                   help="Target property value(s), raw units (e.g. TPSA 90)")
    p.add_argument("--num_molecules", type=int, default=1024)
    p.add_argument("--opt_steps", type=int, default=300,
                   help="Adam steps of latent descent")
    p.add_argument("--opt_lr", type=float, default=0.05)
    p.add_argument("--prior_weight", type=float, default=0.01,
                   help="Weight of the ||z||^2/latent_dim prior term that "
                        "keeps candidates in-distribution")
    p.add_argument("--z_clip", type=float, default=3.0,
                   help="Per-coordinate hard bound on z during descent")
    p.add_argument("--max_length", type=int, default=80)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--top_p", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", type=str, default="optimized.json")
    p.add_argument("--no_normalize", action="store_true",
                   help="Treat --target as already-normalized model units")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda[:N] (the kernels) or cpu (their plain versions)")
    add_cache_flags(p)
    return p


def main(argv=None):
    """Run the CLI; returns the output document with, beside its keys,
    ``z0`` and the objective trajectory (numpy) and the loop's seconds
    (``opt_seconds``)."""
    from mlx_vae_tpu_torch.cli.common import (normalized_targets, resolve_device,
                                              resolve_property_stats)
    from mlx_vae_tpu_torch.cli.generate import infer_model_shape, make_generate_fn
    from mlx_vae_tpu_torch.config import ModelConfig
    from mlx_vae_tpu_torch.data.metrics import uniqueness
    from mlx_vae_tpu_torch.data.prepare import decode_tokens, selfies_validity
    from mlx_vae_tpu_torch.models.latent_opt import optimize_latent
    from mlx_vae_tpu_torch.models.vae import generation_sampler
    from mlx_vae_tpu_torch.train.checkpoint import load_checkpoint
    from mlx_vae_tpu_torch.utils.tree import params_from_numpy

    parser = build_parser()
    args = parser.parse_args(argv)
    if args.opt_steps < 1:
        parser.error(f"--opt_steps must be >= 1, got {args.opt_steps}")
    if args.top_k < 0:
        parser.error(f"--top_k must be >= 0 (0 disables), got {args.top_k}")
    if not 0.0 < args.top_p <= 1.0:
        parser.error(f"--top_p must be in (0, 1], got {args.top_p}")
    device = resolve_device(args.device)

    ckpt = load_checkpoint(args.checkpoint)
    if "predictor" not in ckpt["params"]:
        raise SystemExit(
            "ERROR: this checkpoint has no property-predictor head — latent "
            "optimization needs one. Re-train with --use_property_predictor "
            "(and lambda_prop > 0) so the z->properties surrogate exists.")
    params = {k: params_from_numpy(ckpt["params"][k], device) for k in ("decoder", "predictor")}

    mcfg = ModelConfig(compute_dtype=args.compute_dtype, use_pallas=True,
                       **infer_model_shape(ckpt["params"]["decoder"]))
    mean, std, alphabet, _ = resolve_property_stats(
        args.data, args.no_normalize, ckpt, mcfg.num_conditions)
    target = normalized_targets(args.target, mean, std, mcfg.num_conditions)

    B = args.num_molecules
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    z0 = torch.randn((B, mcfg.latent_dim), generator=gen, device=device)

    t0 = time.perf_counter()
    z_opt, info = optimize_latent(params, mcfg, z0, torch.from_numpy(target).to(device),
                                  steps=args.opt_steps, lr=args.opt_lr,
                                  prior_weight=args.prior_weight, z_clip=args.z_clip)
    obj = info["objective"].cpu().numpy()
    dt_opt = time.perf_counter() - t0
    print(f"Optimized {B:,} candidates x {args.opt_steps} steps in {dt_opt:.4f}s "
          f"({1e3 * dt_opt / args.opt_steps:.3f} ms a step on {device}; objective "
          f"{obj[0]:.4f} -> {obj[-1]:.4f})")

    # De-normalized surrogate predictions, before vs after.
    pred0 = info["pred_init"].cpu().numpy() * std + mean
    pred1 = info["pred_final"].cpu().numpy() * std + mean
    for c in range(mcfg.num_conditions):
        print(f"  property {c}: target {args.target[c]:.2f} | predicted "
              f"{pred0[:, c].mean():.2f}+-{pred0[:, c].std():.2f} -> "
              f"{pred1[:, c].mean():.2f}+-{pred1[:, c].std():.2f}")

    print("Decoding with the " + (
        "fused sampler" if generation_sampler(mcfg) == "fused" else
        "scan sampler (the fused kernel does not take this model)"))
    decode = make_generate_fn(mcfg, params["decoder"], args.max_length, args.temperature,
                              args.greedy, top_k=args.top_k, top_p=args.top_p)
    cond = torch.from_numpy(target).to(device).expand(B, mcfg.num_conditions).contiguous()
    tokens = decode(z_opt, cond, gen).cpu().numpy()
    validity = selfies_validity(tokens, alphabet or [])
    # Uniqueness matters here specifically: descent pulls every candidate
    # toward the same surrogate optimum, so mode collapse of the decoded
    # set is THE failure mode to watch (raise prior_weight / lower steps).
    uniq = uniqueness(tokens)
    print(f"Decoded {B:,} optimized molecules; validity "
          f"{100 * validity:.1f}%, uniqueness {100 * uniq:.1f}%")

    out = {
        "tokens": tokens.tolist(),
        "z_optimized": z_opt.cpu().numpy().tolist(),
        "target": args.target,
        "opt_steps": args.opt_steps,
        "opt_lr": args.opt_lr,
        "prior_weight": args.prior_weight,
        "objective_first": float(obj[0]),
        "objective_final": float(obj[-1]),
        "predicted_before_mean": pred0.mean(axis=0).tolist(),
        "predicted_after_mean": pred1.mean(axis=0).tolist(),
        "validity": validity,
        "uniqueness": uniq,
        "temperature": args.temperature,
    }
    if alphabet:
        out["selfies"] = [decode_tokens(t, alphabet) for t in tokens[:1000]]
    with open(args.output, "w") as f:
        json.dump(out, f)
    print(f"Saved {args.output}")
    return {**out, "z0": z0.cpu().numpy(), "objective": obj, "opt_seconds": dt_opt}


if __name__ == "__main__":
    main()
