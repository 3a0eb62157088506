#!/usr/bin/env python3
"""Bulk conditional generation CLI (counterpart of
``mlx_vae_tpu/cli/generate.py``).

``python -m mlx_vae_tpu_torch.cli.generate --checkpoint ck.npz ...`` with the
JAX CLI's flags. ``--device`` (default ``cuda``) picks the card, where the
fused sampler kernel runs; ``--device cpu`` runs its plain version. A model
the kernel does not take runs the scan sampler on either device, as the JAX
CLI routes it; the CLI prints which sampler it uses. ``--data`` gives the
train-split stats and alphabet, and novelty against the training split.

Each batch's z is drawn from its own generator (seed 0), and the sampler's
noise from another (seeded per rank, ``parallel/mesh.py:fold_seed``).
``--data_parallel`` over more than one rank (a process group the caller or
torchrun set up, or one rank spawned per visible card) draws every batch's
z on every rank and decodes the rank's contiguous block of rows; rank 0
gathers the tokens (gloo), prints the metrics and writes the output, so a
greedy run equals the one-rank run. ``--data_parallel`` on one device
generates there, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from mlx_vae_tpu_torch.cli.common import add_cache_flags


def build_parser():
    p = argparse.ArgumentParser(description="Generate molecules from a trained AR-CVAE")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="Path to a .npz checkpoint (e.g. checkpoints/checkpoint_best.npz)")
    p.add_argument("--data", type=str, default=None,
                   help="Dataset JSON (for property normalization stats + "
                        "alphabet, and novelty against its training split)")
    p.add_argument("--num_molecules", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=4096)
    p.add_argument("--max_length", type=int, default=80)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--greedy", action="store_true",
                   help="Argmax decoding (the reference's behavior)")
    p.add_argument("--top_k", type=int, default=0,
                   help="Sample only among the k most likely tokens per "
                        "step (0 = disabled); runs in-kernel")
    p.add_argument("--top_p", type=float, default=1.0,
                   help="Nucleus sampling: restrict each step to the "
                        "smallest token set with cumulative probability "
                        ">= top_p (1.0 = disabled); runs in-kernel")
    p.add_argument("--target", type=float, nargs="+", default=[90.0],
                   help="Target property value(s), raw units (e.g. TPSA 90)")
    p.add_argument("--output", type=str, default="generated.json",
                   help="Output path. A .npz suffix stores the token matrix "
                        "as a compressed array; anything else writes the "
                        "JSON document.")
    p.add_argument("--no_normalize", action="store_true",
                   help="Pass --target values to the model raw, without "
                        "z-scoring by the train-set stats")
    p.add_argument("--calibrate_response", type=str, default=None,
                   metavar="A,B",
                   help="Invert a measured linear conditioning response "
                        "achieved = A + B*request on the FIRST condition "
                        "axis: the value sent to the model becomes "
                        "(target - A)/B. Example: --calibrate_response "
                        "2.38,0.638")
    p.add_argument("--data_parallel", action="store_true",
                   help="Shard each batch over all ranks: the process "
                        "group's, or one spawned per visible card")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda[:N] (the kernel) or cpu (its plain version)")
    # Model shape flags. Default: inferred from the checkpoint's parameter
    # shapes; pass explicitly only to assert a shape (mismatch = hard error).
    p.add_argument("--vocab_size", type=int, default=None)
    p.add_argument("--embedding_dim", type=int, default=None)
    p.add_argument("--hidden_dim", type=int, default=None)
    p.add_argument("--latent_dim", type=int, default=None)
    p.add_argument("--num_conditions", type=int, default=None)
    p.add_argument("--num_layers", type=int, default=None)
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    add_cache_flags(p)
    return p


def infer_model_shape(dec_params: dict) -> dict:
    """Model dims from decoder parameter shapes (the checkpoint is the
    source of truth; MLX-style key layout, see ``train/checkpoint.py``)."""
    V, E = dec_params["embedding"]["weight"].shape
    H = dec_params["fc_out"]["weight"].shape[1]
    latent = dec_params["z_to_hidden"]["weight"].shape[1]
    C = dec_params["condition_to_hidden"]["weight"].shape[1]
    n = sum(1 for k in dec_params if k.startswith("lstm_layer_"))
    return {"vocab_size": V, "embedding_dim": E, "hidden_dim": H,
            "latent_dim": latent, "num_conditions": C, "num_layers": n}


def make_generate_fn(mcfg, dec_params: dict, max_length: int, temperature: float,
                     greedy: bool, top_k: int = 0, top_p: float = 1.0):
    """Batch decoder ``(z, cond, generator) -> tokens [B, max_length]``
    (``models/vae.py:decode_latents``) on the device of ``dec_params``, the
    decoder tree as tensors; the fused sampler's weights are prepared once
    here. The counterpart of ``mlx_vae_tpu/cli/generate.py:make_generate_fn``
    on one device, the route chosen by ``generation_sampler(mcfg)``."""
    from mlx_vae_tpu_torch.models.vae import decode_latents, generation_sampler
    from mlx_vae_tpu_torch.ops.fused_decoder import prepare_weights

    params = {"decoder": dec_params}
    weights = None
    if generation_sampler(mcfg) == "fused":
        weights = prepare_weights(dec_params, mcfg, dec_params["fc_out"]["weight"].device)

    def generate(z, cond, generator):
        return decode_latents(params, mcfg, z, cond, generator, max_length=max_length,
                              temperature=temperature, greedy=greedy, top_k=top_k,
                              top_p=top_p, weights=weights)

    return generate


def parse_calibration(spec):
    """``"A,B"`` -> (A, B) floats with B != 0; ValueError otherwise."""
    ca, cb = (float(v) for v in spec.split(","))
    if cb == 0.0:
        raise ValueError("B must be non-zero")
    return ca, cb


def main(argv=None):
    import sys

    from mlx_vae_tpu_torch.cli.common import cli_ranks

    parser = build_parser()
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(argv)
    if args.top_k < 0:
        parser.error(f"--top_k must be >= 0 (0 disables), got {args.top_k}")
    if not 0.0 < args.top_p <= 1.0:
        parser.error(f"--top_p must be in (0, 1] (1.0 disables), got {args.top_p}")
    calib = None
    if args.calibrate_response is not None:
        try:
            calib = parse_calibration(args.calibrate_response)
        except ValueError:
            parser.error("--calibrate_response must be 'A,B' (floats, "
                         "B != 0), the fitted response line "
                         "achieved = A + B*request")
    with cli_ranks("mlx_vae_tpu_torch.cli.generate", argv, args.device, args.data_parallel,
                   sources=("fused_generate", "fused_generate_steps")) as device:
        return None if device is None else _generate(args, calib, device)


def _generate(args, calib, device):
    """Generate, report and write; returns rank 0's output keys without the
    tokens, with the host's seconds for the metrics (``metrics_s``), or
    None on the other ranks."""
    from mlx_vae_tpu_torch.cli.common import (data_parallel_mesh, normalized_targets,
                                              resolve_property_stats)
    from mlx_vae_tpu_torch.config import ModelConfig
    from mlx_vae_tpu_torch.data.metrics import molecule_metrics, novelty, uniqueness
    from mlx_vae_tpu_torch.data.prepare import (chemistry_backend, decode_tokens,
                                                selfies_validity)
    from mlx_vae_tpu_torch.models.vae import decode_latents, generation_sampler
    from mlx_vae_tpu_torch.ops.fused_decoder import prepare_weights
    from mlx_vae_tpu_torch.parallel.comm import host_gather_rows
    from mlx_vae_tpu_torch.parallel.mesh import fold_seed, rank
    from mlx_vae_tpu_torch.train.checkpoint import load_checkpoint
    from mlx_vae_tpu_torch.utils.tree import params_from_numpy

    mesh = data_parallel_mesh(args, "generation")
    ckpt = load_checkpoint(args.checkpoint)
    shape = infer_model_shape(ckpt["params"]["decoder"])
    for name, inferred in shape.items():
        given = getattr(args, name)
        if given is not None and given != inferred:
            raise SystemExit(
                f"ERROR: --{name} {given} contradicts the checkpoint "
                f"(parameter shapes imply {name}={inferred})")
    # the fused sampler where it takes the config, else the scan sampler (the
    # JAX CLI's route on its support gate)
    mcfg = ModelConfig(compute_dtype=args.compute_dtype, use_pallas=True, **shape)

    mean, std, alphabet, train_ds = resolve_property_stats(
        args.data, args.no_normalize, ckpt, mcfg.num_conditions)
    model_target = list(args.target)
    if calib is not None:
        ca, cb = calib
        model_target[0] = (model_target[0] - ca) / cb
        print(f"Calibrated conditioning: target {args.target[0]:g} -> "
              f"model request {model_target[0]:.1f} "
              f"(inverting achieved = {ca:g} + {cb:g}*request)")
    target = normalized_targets(model_target, mean, std, mcfg.num_conditions)

    params = {"decoder": params_from_numpy(ckpt["params"]["decoder"], device)}
    weights = None
    if generation_sampler(mcfg) == "fused":
        weights = prepare_weights(params["decoder"], mcfg, device)
        print("Using fused CUDA generation kernel" if device.type == "cuda"
              else "Using the fused sampler's plain version")
    else:
        print("Using the scan sampler (the fused kernel does not take this model)")
    rows = args.batch_size // (mesh.data if mesh else 1)
    first = mesh.data_rank * rows if mesh else 0
    cond = torch.as_tensor(target, device=device).expand(
        rows, mcfg.num_conditions).contiguous()
    gen_z = torch.Generator(device=device)
    gen_z.manual_seed(0)
    gen = torch.Generator(device=device)
    gen.manual_seed(fold_seed(0, mesh.data_rank if mesh else 0))
    small_vocab = mcfg.vocab_size < 256

    def one_batch():
        # every rank draws the whole batch's z, then decodes its own rows
        z = torch.randn((args.batch_size, mcfg.latent_dim), generator=gen_z, device=device)
        toks = decode_latents(params, mcfg, z[first:first + rows], cond, gen,
                              max_length=args.max_length, temperature=args.temperature,
                              greedy=args.greedy, top_k=args.top_k, top_p=args.top_p,
                              weights=weights)
        # Quarter the device->host transfer when token ids fit in a byte.
        return toks.to(torch.uint8) if small_vocab else toks

    # Warm-up (kernel build and first launch) on one batch, then enqueue ALL
    # batches on the stream and read back afterwards.
    one_batch().cpu()
    n_batches = -(-args.num_molecules // args.batch_size)
    t0 = time.perf_counter()
    device_toks = [one_batch() for _ in range(n_batches)]
    if mesh is None:
        tokens = torch.cat(device_toks).cpu().numpy()
    else:
        tokens = np.concatenate(host_gather_rows(mesh, [t.cpu().numpy() for t in device_toks]))
    dt = time.perf_counter() - t0
    tokens = tokens[: args.num_molecules]
    rate = len(tokens) / dt
    if rank() != 0:  # rank 0 alone reports and writes
        return None
    t_metrics = time.perf_counter()
    validity = selfies_validity(tokens, alphabet or [])
    print(f"Generated {len(tokens):,} molecules in {dt:.2f}s "
          f"({rate:,.0f} mols/sec on {device}, warm-up excluded)")
    print(f"Validity: {100 * validity:.1f}%")
    # Sample-quality metrics (MOSES conventions; see data/metrics.py).
    # Novelty needs the training token matrix, so it reports only with --data.
    uniq = uniqueness(tokens)
    print(f"Uniqueness: {100 * uniq:.1f}%")
    nov = None
    if train_ds is not None:
        nov = novelty(tokens, train_ds.molecules)
        print(f"Novelty vs training set: {100 * nov:.1f}%")

    meta = {
        "mols_per_sec": rate,
        "validity": validity,
        "uniqueness": uniq,
        "temperature": args.temperature,
        "target": args.target,
        "device": str(device),
    }
    if nov is not None:
        meta["novelty"] = nov

    # Molecule-level metrics when a chemistry alphabet is present:
    # canonical-SMILES uniqueness and decoded Ertl-TPSA fidelity against
    # the first conditioning target.
    mm = molecule_metrics(tokens, alphabet or [], target_tpsa=args.target[0])
    if mm is not None:
        meta["molecule_metrics"] = mm
        meta["chemistry_backend"] = chemistry_backend()
        print(f"Molecule-level (sample {mm['sampled']:,}, "
              f"{chemistry_backend()} backend): "
              f"unique {100 * mm['mol_uniqueness']:.1f}%"
              + (f", TPSA {mm['tpsa_mean']:.1f}±{mm['tpsa_std']:.1f} "
                 f"(target {mm['tpsa_target']:.0f}, "
                 f"MAE {mm['tpsa_mae']:.1f})" if "tpsa_mae" in mm else ""))
    meta["metrics_s"] = time.perf_counter() - t_metrics
    if args.top_k or args.top_p < 1.0:
        meta["top_k"], meta["top_p"] = args.top_k, args.top_p
    selfies = ([decode_tokens(t, alphabet) for t in tokens[:1000]]
               if alphabet else None)
    if args.output.endswith(".npz"):
        arrays = dict(tokens=tokens, **meta)
        if selfies is not None:
            arrays["selfies_sample"] = np.asarray(selfies)
        np.savez_compressed(args.output, **arrays)
    else:
        out = {"tokens": tokens.tolist(), **meta}
        if selfies is not None:
            out["selfies"] = selfies
        with open(args.output, "w") as f:
            json.dump(out, f)
    print(f"Saved {args.output}")
    return meta


if __name__ == "__main__":
    main()
