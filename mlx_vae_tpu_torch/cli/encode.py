#!/usr/bin/env python3
"""Encode a dataset split to latent space and evaluate reconstruction
(counterpart of ``mlx_vae_tpu/cli/encode.py``).

``python -m mlx_vae_tpu_torch.cli.encode --checkpoint ck.npz --data d.json``
with the JAX CLI's flags, on one device. ``--device`` (default ``cuda``)
picks the card, where each part runs the kernels of the route its model
takes (:func:`route_sources`: for the default model the whole-stack
encoder, the training decoder's logits specialization and the fused
sampler; where those refuse the model, the sequence kernels and the
scans' gate kernel pair); ``--device cpu`` runs their plain versions.
Three parts, each over fixed-size batches (the last one padded by
repeating row 0, its outputs trimmed):

* **Embeddings**: ``(mu, logvar)`` of every molecule of the split
  (``models/encoder.py:encoder_apply``), written to one ``.npz`` with the
  raw and normalized properties.
* **Reconstruction**: the teacher-forced (TF=1) next-token accuracy (the
  argmax of ``decoder_apply`` taken on the device, one readback a batch)
  and the greedy decode from ``z = mu`` (``cli/generate.py:make_generate_fn``)
  scored by ``models/latent_eval.py:reconstruction_metrics``.
* **Latent health**: per-dim KL, active units and MI over the whole split
  (``latent_statistics``).

The ``.npz`` keys and the report's JSON keys are the JAX CLI's.
``--data_parallel`` over more than one rank (a process group the caller or
torchrun set up, or one rank spawned per visible card) gives each rank its
contiguous block of every batch's rows; the blocks are gathered on the host
(gloo) and rank 0 prints the metrics and writes the outputs.
``--data_parallel`` on one device encodes there, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from mlx_vae_tpu_torch.cli.common import add_cache_flags


def build_parser():
    p = argparse.ArgumentParser(
        description="Encode molecules to latent space and evaluate "
                    "reconstruction fidelity")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="Path to a .npz checkpoint")
    p.add_argument("--data", type=str, required=True,
                   help="Dataset JSON (the molecules to encode)")
    p.add_argument("--split", choices=["train", "val", "test", "all"],
                   default="test",
                   help="Which seed-67 split to encode (default: test)")
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--no_reconstruct", action="store_true",
                   help="Skip the greedy reconstruction decode (embeddings "
                        "and latent stats only)")
    p.add_argument("--au_threshold", type=float, default=0.01,
                   help="Active-unit threshold on Var_x(mu_d)")
    p.add_argument("--output", type=str, default="latents.npz",
                   help="Embeddings output (.npz)")
    p.add_argument("--report", type=str, default="encode_report.json",
                   help="Metrics report output (JSON)")
    p.add_argument("--data_parallel", action="store_true",
                   help="Shard each batch over all ranks: the process "
                        "group's, or one spawned per visible card")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda[:N] (the kernels) or cpu (their plain versions)")
    add_cache_flags(p)
    return p


def _batched(fn, arrays, batch_size: int, device, mesh=None):
    """Apply ``fn(*batch_tensors)`` over N rows in batches of ``batch_size``
    on ``device``; the last batch is padded by repeating row 0 and trimmed
    after. Under ``mesh`` this rank computes its data block of each batch
    and the blocks are gathered. Returns stacked numpy outputs (a tuple if
    fn returns one)."""
    from mlx_vae_tpu_torch.parallel.comm import host_gather_rows

    n = arrays[0].shape[0]
    rows = batch_size // (mesh.data if mesh else 1)
    first = mesh.data_rank * rows if mesh else 0
    outs, pads = [], []
    for s in range(0, n, batch_size):
        chunk = [a[s:s + batch_size] for a in arrays]
        pad = batch_size - chunk[0].shape[0]
        if pad:
            chunk = [np.concatenate([c, np.repeat(c[:1], pad, axis=0)])
                     for c in chunk]
        out = fn(*[torch.from_numpy(np.ascontiguousarray(c[first:first + rows])).to(device)
                   for c in chunk])
        out = out if isinstance(out, tuple) else (out,)
        outs.append([o.cpu().numpy() for o in out])
        pads.append(pad)
    cols = []
    for j in range(len(outs[0])):
        blocks = [o[j] for o in outs]
        if mesh is not None:
            blocks = host_gather_rows(mesh, blocks)
        cols.append(np.concatenate([b[: batch_size - pad or None]
                                    for b, pad in zip(blocks, pads)]))
    return tuple(cols) if len(cols) > 1 else cols[0]


def route_sources(mcfg) -> dict:
    """{part: the kernel sources (``csrc/<name>.cu``) it launches on the
    card}, from the routes the config takes (``models/encoder.py:
    encoder_route``, ``models/decoder.py:train_decoder_route``,
    ``models/vae.py:generation_sampler``); a scan's gate kernel pair runs
    under ``use_pallas``."""
    from mlx_vae_tpu_torch.models.decoder import train_decoder_route
    from mlx_vae_tpu_torch.models.encoder import encoder_route
    from mlx_vae_tpu_torch.models.vae import generation_sampler
    from mlx_vae_tpu_torch.ops.fused_decoder import fused_generate_route

    gates = ["fused_lstm_gates"] if mcfg.use_pallas else []
    kernels = {"fused": ["fused_encoder"], "seq": ["fused_seq_lstm"]}
    decoder = {"fused": ["fused_train_decoder"], "cvp": ["fused_train_decoder"], "cv": []}
    sampler = gates
    if generation_sampler(mcfg) == "fused":
        steps = fused_generate_route(mcfg) == "steps"
        sampler = ["fused_generate_steps" if steps else "fused_generate"]
    return {"encode": kernels.get(encoder_route(mcfg), gates),
            "next_token": decoder.get(train_decoder_route(mcfg), gates),
            "greedy": sampler}


def kernels_note(device, sources) -> str:
    """The kernels a timed span on ``device`` launches (``sources``), and
    whether the span includes loading (and, where this checkout has not
    built them, compiling) them."""
    if device.type != "cuda":
        return "plain versions, no kernel build"
    if not sources:
        return "no kernel on this route"
    from mlx_vae_tpu_torch.ops.build import is_loaded

    names = f"csrc/{', '.join(sources)}.cu"
    missing = [s for s in sources if not is_loaded(s)]
    if not missing:
        return f"{names}, loaded before, no build inside"
    return (f"{names}; the first call loads {', '.join(missing)}, and builds what this "
            f"checkout has not, inside the time")


def encode_split(params: dict, mcfg, device, tokens: np.ndarray, cond: np.ndarray,
                 batch_size: int, reconstruct: bool = True, mesh=None) -> dict:
    """The three device parts over a split: ``mu``, ``logvar``, and with
    ``reconstruct`` the TF=1 argmax tokens (``next_tokens``) and the greedy
    decode from ``z = mu`` (``decoded``), all numpy, with each part's
    seconds under ``seconds`` and its kernels' note under ``notes``.
    ``params`` holds the encoder and decoder trees as tensors on
    ``device``; ``mcfg.use_pallas`` picks the kernels or the plain route.
    ``mesh``: each rank takes its block of every batch (see ``_batched``)."""
    from mlx_vae_tpu_torch.cli.generate import make_generate_fn
    from mlx_vae_tpu_torch.models.decoder import decoder_apply
    from mlx_vae_tpu_torch.models.encoder import encoder_apply

    L = tokens.shape[1]
    out = {"seconds": {}, "notes": {}}
    sources = route_sources(mcfg)

    def timed(part, fn, arrays):
        out["notes"][part] = kernels_note(device, sources[part])
        t0 = time.perf_counter()
        res = _batched(fn, arrays, batch_size, device, mesh)
        out["seconds"][part] = time.perf_counter() - t0
        return res

    with torch.no_grad():
        out["mu"], out["logvar"] = timed(
            "encode", lambda x, c: encoder_apply(params["encoder"], mcfg, x, c), [tokens, cond])
        if not reconstruct:
            return out
        tf_on = torch.ones((L,), dtype=torch.bool, device=device)
        out["next_tokens"] = timed(
            "next_token",
            lambda z, c, x: torch.argmax(decoder_apply(params["decoder"], mcfg, z, c,
                                                       target_seq=x, tf_mask=tf_on), dim=-1),
            [out["mu"], cond, tokens])
        gen = make_generate_fn(mcfg, params["decoder"], L, 1.0, greedy=True)
        g = torch.Generator(device=device)
        g.manual_seed(0)  # greedy is deterministic; a fixed generator
        out["decoded"] = timed("greedy", lambda z, c: gen(z, c, g), [out["mu"], cond])
    return out


def main(argv=None):
    """Run the CLI; returns the report with the arrays behind it (``mu``,
    ``logvar``, ``next_tokens``, ``decoded``) and the parts' seconds (on
    every rank of a ``--data_parallel`` run; None where it spawned them)."""
    import sys

    from mlx_vae_tpu_torch.cli.common import cli_ranks

    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    with cli_ranks("mlx_vae_tpu_torch.cli.encode", argv, args.device, args.data_parallel,
                   sources=("fused_encoder", "fused_train_decoder", "fused_seq_lstm",
                            "fused_lstm_gates", "fused_generate",
                            "fused_generate_steps")) as device:
        return None if device is None else _encode(args, device)


def _encode(args, device) -> dict:
    from mlx_vae_tpu_torch.cli.common import data_parallel_mesh
    from mlx_vae_tpu_torch.cli.generate import infer_model_shape
    from mlx_vae_tpu_torch.config import ModelConfig
    from mlx_vae_tpu_torch.data.split import load_and_split
    from mlx_vae_tpu_torch.models.latent_eval import (latent_statistics,
                                                      reconstruction_metrics)
    from mlx_vae_tpu_torch.models.vae import generation_sampler
    from mlx_vae_tpu_torch.parallel.mesh import rank
    from mlx_vae_tpu_torch.train.checkpoint import load_checkpoint
    from mlx_vae_tpu_torch.utils.tree import params_from_numpy

    mesh = data_parallel_mesh(args, "encoding")
    ckpt = load_checkpoint(args.checkpoint)
    params = {k: params_from_numpy(ckpt["params"][k], device) for k in ("encoder", "decoder")}
    mcfg = ModelConfig(compute_dtype=args.compute_dtype, use_pallas=True,
                       **infer_model_shape(ckpt["params"]["decoder"]))

    train_ds, val_ds, test_ds, _ = load_and_split(
        args.data,
        property_keys=tuple(["tpsa", "logp", "mw"][:mcfg.num_conditions]))
    splits = {"train": [train_ds], "val": [val_ds], "test": [test_ds],
              "all": [train_ds, val_ds, test_ds]}[args.split]
    tokens = np.concatenate([d.molecules for d in splits])
    cond = np.concatenate([d.properties_normalized for d in splits])
    props = np.concatenate([d.properties for d in splits])
    n, L = tokens.shape
    print(f"Encoding {n:,} molecules ({args.split} split, max_length {L}) on {device}, "
          f"batches of {args.batch_size}")
    if not args.no_reconstruct:
        print("Greedy reconstruction: " + (
            "fused sampler" if generation_sampler(mcfg) == "fused" else
            "scan sampler (the fused kernel does not take this model)"))

    res = encode_split(params, mcfg, device, tokens, cond, args.batch_size,
                       reconstruct=not args.no_reconstruct, mesh=mesh)
    mu, logvar, secs, notes = res["mu"], res["logvar"], res["seconds"], res["notes"]
    print(f"Encoded in {secs['encode']:.4f}s ({n / secs['encode']:,.0f} mols/sec; "
          f"{notes['encode']})")

    stats = latent_statistics(mu, logvar, au_threshold=args.au_threshold)
    print(f"Latent: KL {stats['kl_total']:.3f} nats | active units "
          f"{stats['active_units']}/{mcfg.latent_dim} "
          f"({100 * stats['active_fraction']:.0f}%) | MI "
          f"{stats['mutual_information']:.3f}")

    report = {
        "split": args.split,
        "num_molecules": int(n),
        "kl_total": stats["kl_total"],
        "kl_per_dim": stats["kl_per_dim"].tolist(),
        "active_units": stats["active_units"],
        "active_fraction": stats["active_fraction"],
        "au_threshold": stats["au_threshold"],
        "mutual_information": stats["mutual_information"],
    }

    if not args.no_reconstruct:
        mask = tokens != mcfg.pad_token
        next_tok = float((res["next_tokens"] == tokens)[mask].sum() / max(1, mask.sum()))
        rec = reconstruction_metrics(res["decoded"], tokens, pad_token=mcfg.pad_token)
        print(f"TF=1 decode in {secs['next_token']:.4f}s "
              f"({n / secs['next_token']:,.0f} mols/sec; {notes['next_token']})")
        print(f"Greedy decode in {secs['greedy']:.4f}s "
              f"({n / secs['greedy']:,.0f} mols/sec; {notes['greedy']})")
        print(f"Reconstruction: next-token accuracy (TF=1) "
              f"{100 * next_tok:.1f}% | free-running greedy from z=mu: token accuracy "
              f"{100 * rec['token_accuracy']:.1f}%, exact molecule match "
              f"{100 * rec['exact_match']:.1f}%")
        report["next_token_accuracy"] = next_tok
        report.update(rec)

    if rank() == 0:  # rank 0 alone writes
        np.savez(args.output, mu=mu, logvar=logvar, properties=props,
                 properties_normalized=cond, split=args.split)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)
        print(f"Saved embeddings to {args.output}, report to {args.report}")
    return {"report": report, **res}


if __name__ == "__main__":
    main()
