"""Latent-optimization fidelity study: does optimize-then-decode
(``models/latent_opt.py``) beat plain conditional generation at hitting a
property target? (counterpart of ``benchmarks/latent_opt_fidelity.py``).

Both arms decode with the target as the condition input from the same
latents and the same sampler seeds; the optimized arm first descends each
latent against the trained z -> properties surrogate
(``models/latent_opt.py:optimize_latent``: ``--opt_steps`` Adam steps at
``--opt_lr``, ``--prior_weight``). Achieved TPSA is the synthetic corpus's
noise-free formula on the tokens (``data/prepare.py:synthetic_tpsa``), or
with ``--chem`` the Ertl TPSA of the decoded molecules: ground truth, so a
surrogate that over-fits shows as a gap between ``surrogate_pred_after``
(the surrogate's mean prediction after the descent, de-normalised by the
train split's stats) and ``achieved_mean``.

Needs a checkpoint trained with ``--use_property_predictor``; the model
shape is read from it. Sampling as in :mod:`.conditioning_fidelity` (bf16,
the fused route on the card, ``--device``, ``--seed``, ``--compute_dtype``,
``--sampler``). Usage::

    python -m mlx_vae_tpu_torch.studies.latent_opt_fidelity \\
        --checkpoint ck/checkpoint_best.npz --data d.json

The output (``mlx_vae_tpu_torch/studies/latent_opt_fidelity_torch.json``,
or ``..._chem_torch.json`` under ``--chem``) is never written under
``benchmarks/``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from mlx_vae_tpu_torch.studies.conditioning_fidelity import (STUDY_DIR, achieved_descriptors,
                                                             add_sampling_flags,
                                                             corpus_alphabet, draw, load_model,
                                                             route, synthetic_achieved,
                                                             write_output)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--targets", type=float, nargs="+", default=[50.0, 90.0, 130.0])
    ap.add_argument("--batch_size", type=int, default=2048)
    ap.add_argument("--max_length", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--opt_steps", type=int, default=300)
    ap.add_argument("--opt_lr", type=float, default=0.05)
    ap.add_argument("--prior_weight", type=float, default=0.01)
    ap.add_argument("--chem", action="store_true",
                    help="score decoded molecules with the vendored chemistry backend "
                         "(Ertl TPSA) instead of the synthetic token formula")
    ap.add_argument("--output", default=None,
                    help="default: mlx_vae_tpu_torch/studies/latent_opt_fidelity_torch.json, "
                         "or ..._chem_torch.json under --chem; never under benchmarks/")
    add_sampling_flags(ap)
    return ap


def main(argv=None) -> dict:
    """Run the study; returns the written document: ``results`` (the JAX
    script's rows), ``route``, ``tokens_device``, ``latent_device`` and
    ``config``."""
    from mlx_vae_tpu_torch.cli.common import resolve_device
    from mlx_vae_tpu_torch.cli.generate import make_generate_fn
    from mlx_vae_tpu_torch.data.split import load_and_split
    from mlx_vae_tpu_torch.models.latent_opt import optimize_latent
    from mlx_vae_tpu_torch.studies.elbo_compare import refuse_benchmarks_path

    args = build_parser().parse_args(argv)
    if args.output is None:
        args.output = str(STUDY_DIR / ("latent_opt_fidelity_chem_torch.json" if args.chem
                                       else "latent_opt_fidelity_torch.json"))
    refuse_benchmarks_path(args.output)
    device = resolve_device(args.device)
    _, params, mcfg = load_model(args.checkpoint, device, args.compute_dtype, args.sampler)
    if "predictor" not in params:
        raise SystemExit("checkpoint has no predictor head — re-train with "
                         "--use_property_predictor")
    train_ds, _, _, _ = load_and_split(args.data)
    mean, std = train_ds.properties_mean, train_ds.properties_std
    alphabet = corpus_alphabet(args.data) if args.chem else None

    gen = make_generate_fn(mcfg, params["decoder"], args.max_length, args.temperature,
                           greedy=False)
    devices, latent_devices = set(), set()

    def achieved(out: torch.Tensor) -> np.ndarray:
        devices.add(str(out.device))
        toks = out.cpu().numpy()
        if args.chem:
            return achieved_descriptors(toks, alphabet, ("tpsa",))[1]["tpsa"]
        return synthetic_achieved(toks, mcfg.vocab_size)

    results = []
    for target in args.targets:
        tn = float((target - mean[0, 0]) / std[0, 0])
        cond = torch.full((args.batch_size, 1), tn, device=device)
        z0, g = draw(args.seed, args.batch_size, mcfg.latent_dim, device)
        base = achieved(gen(z0, cond, g))

        z_opt, info = optimize_latent(params, mcfg, z0, torch.tensor([tn], device=device),
                                      steps=args.opt_steps, lr=args.opt_lr,
                                      prior_weight=args.prior_weight)
        latent_devices.add(str(z_opt.device))
        _, g = draw(args.seed, args.batch_size, mcfg.latent_dim, device)  # the same seeds
        tuned = achieved(gen(z_opt, cond, g))
        pred_after = float(info["pred_final"].mean().item() * std[0, 0] + mean[0, 0])

        if args.chem and (len(base) == 0 or len(tuned) == 0):
            raise SystemExit("--chem: nothing decoded; wrong checkpoint/corpus pairing?")
        row = {
            "target": target,
            "conditional": {"achieved_mean": float(base.mean()),
                            "achieved_std": float(base.std()),
                            "mae": float(np.abs(base - target).mean())},
            "optimized": {"achieved_mean": float(tuned.mean()),
                          "achieved_std": float(tuned.std()),
                          "mae": float(np.abs(tuned - target).mean()),
                          "surrogate_pred_after": pred_after},
        }
        if args.chem:
            row["conditional"]["decoded"] = int(len(base))
            row["optimized"]["decoded"] = int(len(tuned))
            row["backend"] = "vendored-ertl"
        results.append(row)
        print(f"target {target:6.1f}: conditional {base.mean():6.1f} "
              f"± {base.std():5.1f} (MAE {row['conditional']['mae']:5.1f}) | "
              f"optimized {tuned.mean():6.1f} ± {tuned.std():5.1f} "
              f"(MAE {row['optimized']['mae']:5.1f}, surrogate {pred_after:6.1f})")

    doc = {"results": results, "route": route(mcfg, device),
           "tokens_device": sorted(devices), "latent_device": sorted(latent_devices),
           "config": {"checkpoint": args.checkpoint, "targets": args.targets,
                      "batch_size": args.batch_size, "max_length": args.max_length,
                      "temperature": args.temperature, "opt_steps": args.opt_steps,
                      "opt_lr": args.opt_lr, "prior_weight": args.prior_weight,
                      "chem": args.chem, "seed": args.seed, "device": str(device),
                      "torch": torch.__version__}}
    write_output(args.output, doc)
    return doc


if __name__ == "__main__":
    main()
