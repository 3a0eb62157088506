#!/usr/bin/env python3
"""Latent-space interpolation between two molecules (counterpart of
``mlx_vae_tpu/cli/interpolate.py``).

``python -m mlx_vae_tpu_torch.cli.interpolate --checkpoint ck.npz --data
d.json`` with the JAX CLI's flags, on one device (``--device``, default
``cuda``; ``cpu`` runs the kernels' plain versions). Both endpoints are
encoded in one batch of two rows (``models/encoder.py:encoder_apply``),
the path between their ``mu`` is walked (``models/latent_eval.py:
latent_path``, slerp or lerp), the conditions are interpolated linearly
between the endpoints' own normalized properties, and every waypoint is
decoded greedily in one batch (``cli/generate.py:make_generate_fn``).
The output JSON has the JAX CLI's keys.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mlx_vae_tpu_torch.cli.common import add_cache_flags


def build_parser():
    p = argparse.ArgumentParser(
        description="Decode the latent path between two dataset molecules")
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--data", type=str, required=True,
                   help="Dataset JSON the endpoint molecules come from")
    p.add_argument("--split", choices=["train", "val", "test"],
                   default="test", help="Split the indices refer to")
    p.add_argument("--index_a", type=int, default=0,
                   help="Row index of the first endpoint in the split")
    p.add_argument("--index_b", type=int, default=1,
                   help="Row index of the second endpoint in the split")
    p.add_argument("--steps", type=int, default=9,
                   help="Waypoints including both endpoints (>= 2)")
    p.add_argument("--mode", choices=["slerp", "lerp"], default="slerp",
                   help="Spherical (norm-preserving) or straight-line path")
    p.add_argument("--output", type=str, default="interpolation.json")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda[:N] (the kernels) or cpu (their plain versions)")
    add_cache_flags(p)
    return p


def main(argv=None):
    """Run the CLI; returns the output document."""
    from mlx_vae_tpu_torch.cli.common import resolve_device
    from mlx_vae_tpu_torch.cli.generate import infer_model_shape, make_generate_fn
    from mlx_vae_tpu_torch.config import ModelConfig
    from mlx_vae_tpu_torch.data.prepare import decode_tokens, selfies_validity
    from mlx_vae_tpu_torch.data.split import load_and_split
    from mlx_vae_tpu_torch.models.encoder import encoder_apply
    from mlx_vae_tpu_torch.models.latent_eval import latent_path
    from mlx_vae_tpu_torch.train.checkpoint import load_checkpoint
    from mlx_vae_tpu_torch.utils.tree import params_from_numpy

    parser = build_parser()
    args = parser.parse_args(argv)
    if args.steps < 2:
        parser.error(f"--steps must be >= 2, got {args.steps}")
    device = resolve_device(args.device)

    ckpt = load_checkpoint(args.checkpoint)
    params = {k: params_from_numpy(ckpt["params"][k], device) for k in ("encoder", "decoder")}
    mcfg = ModelConfig(compute_dtype=args.compute_dtype, use_pallas=True,
                       **infer_model_shape(ckpt["params"]["decoder"]))

    train_ds, val_ds, test_ds, data = load_and_split(
        args.data,
        property_keys=tuple(["tpsa", "logp", "mw"][:mcfg.num_conditions]))
    ds = {"train": train_ds, "val": val_ds, "test": test_ds}[args.split]
    for name in ("index_a", "index_b"):
        idx = getattr(args, name)
        if not 0 <= idx < len(ds):
            parser.error(f"--{name} {idx} out of range for the "
                         f"{len(ds)}-molecule {args.split} split")
    alphabet = data.get("alphabet")

    rows = np.stack([ds.molecules[args.index_a], ds.molecules[args.index_b]])
    conds = np.stack([ds.properties_normalized[args.index_a],
                      ds.properties_normalized[args.index_b]])
    L = rows.shape[1]

    with torch.no_grad():
        mu, _ = encoder_apply(params["encoder"], mcfg, torch.from_numpy(rows).to(device),
                              torch.from_numpy(conds).to(device))
    mu = mu.cpu().numpy()

    z_path = latent_path(mu[0], mu[1], args.steps, mode=args.mode)
    t = np.linspace(0.0, 1.0, args.steps)[:, None].astype(np.float32)
    cond_path = (1 - t) * conds[0] + t * conds[1]

    gen = make_generate_fn(mcfg, params["decoder"], L, 1.0, greedy=True)
    g = torch.Generator(device=device)
    g.manual_seed(0)  # greedy is deterministic; a fixed generator
    tokens = gen(torch.from_numpy(z_path).to(device),
                 torch.from_numpy(cond_path).to(device), g).cpu().numpy()

    validity = selfies_validity(tokens, alphabet or [])
    distinct = len({row.tobytes() for row in tokens})
    print(f"Interpolated {args.steps} steps ({args.mode}) between "
          f"{args.split}[{args.index_a}] and {args.split}[{args.index_b}] on {device}: "
          f"{distinct} distinct decodes, validity {100 * validity:.1f}%")
    if alphabet:
        for i, row in enumerate(tokens):
            print(f"  t={t[i, 0]:.2f}  {decode_tokens(row, alphabet)}")

    out = {
        "mode": args.mode,
        "steps": args.steps,
        "split": args.split,
        "indices": [args.index_a, args.index_b],
        "tokens": tokens.tolist(),
        "z_path": z_path.tolist(),
        "validity": validity,
        "distinct_decodes": distinct,
        "endpoint_tokens": rows.tolist(),
    }
    if alphabet:
        out["selfies"] = [decode_tokens(row, alphabet) for row in tokens]
        out["endpoint_selfies"] = [decode_tokens(r, alphabet) for r in rows]
    with open(args.output, "w") as f:
        json.dump(out, f)
    print(f"Saved {args.output}")
    return out


if __name__ == "__main__":
    main()
