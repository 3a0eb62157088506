"""Conditioning-fidelity study: does conditional generation obey the
property target? (counterpart of ``benchmarks/conditioning_fidelity.py``).

From a trained checkpoint it generates ``--batch_size`` rows at each of
``--targets`` and scores what the rows achieve, in the JAX script's three
modes with its row schemas key for key:

* synthetic (default): the synthetic corpus's noise-free TPSA formula on
  the tokens (``data/prepare.py:synthetic_tpsa``);
* ``--chem``: the Ertl TPSA of the decoded molecules
  (``data/metrics.py:molecule_metrics``), for a checkpoint trained on a
  chemistry corpus;
* ``--chem`` with several ``--properties``: the first key is swept over
  the targets, the rest are held at their corpus means (z-score 0), and
  every conditioned descriptor is scored (``data/metrics.py:decoded_mols``,
  ``chem/descriptors.py``).

The mean and std are the train split's (``data/split.py:load_and_split``,
split seed 67). Tokens come from ``cli/generate.py:make_generate_fn`` in
bf16, as the JAX script sets it: on the card the fused route
(``models/vae.py:generation_sampler``), whose kernel for the default model
is ``tc::gen_tc_kernel``; ``--device cpu`` runs its plain version.
``--compute_dtype float32`` and ``--sampler scan`` (``use_pallas`` off)
rerun generation on the same checkpoint another way, to tell the sampler
apart from training. At each target, ``z`` and the sampler's seeds come from
one ``torch.Generator`` seeded with ``--seed``; the JAX script draws them
from threefry keys 0 and 1, so the two packages' rows differ by design.

The model shape is read from the checkpoint; the JAX script's shape flags
are accepted and must agree with it. Usage::

    python -m mlx_vae_tpu_torch.studies.conditioning_fidelity \\
        --checkpoint ck/checkpoint_best.npz --data d.json

The output (``mlx_vae_tpu_torch/studies/conditioning_fidelity_torch.json``
by default) is never written under ``benchmarks/``, where the JAX records
live.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

STUDY_DIR = Path(__file__).resolve().parent
SHAPE_FLAGS = ("vocab_size", "embedding_dim", "hidden_dim", "latent_dim", "num_layers")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--targets", type=float, nargs="+", default=[50.0, 90.0, 130.0])
    ap.add_argument("--batch_size", type=int, default=2048)
    ap.add_argument("--max_length", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--chem", action="store_true",
                    help="score decoded molecules with the vendored chemistry backend "
                         "(Ertl TPSA) instead of the synthetic token formula")
    ap.add_argument("--properties", default="tpsa",
                    help="comma-separated condition keys the checkpoint was trained with "
                         "(--chem multi-property sweeps: the FIRST key is swept over "
                         "--targets, the rest are held at their corpus means, and ALL "
                         "achieved descriptors are scored)")
    ap.add_argument("--output", default=str(STUDY_DIR / "conditioning_fidelity_torch.json"),
                    help="results JSON; never under benchmarks/")
    for name in SHAPE_FLAGS:
        ap.add_argument(f"--{name}", type=int, default=None,
                        help="asserted against the checkpoint (default: read from it)")
    add_sampling_flags(ap)
    return ap


def add_sampling_flags(ap: argparse.ArgumentParser) -> None:
    """The flags both studies add to the JAX scripts'."""
    ap.add_argument("--device", default="cuda",
                    help="cuda[:N] (the kernels) or cpu (their plain versions)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the generator that draws z and the sampler's seeds")
    ap.add_argument("--compute_dtype", default="bfloat16", choices=["bfloat16", "float32"],
                    help="the sampler's compute dtype (the JAX script's is bfloat16)")
    ap.add_argument("--sampler", default="fused", choices=["fused", "scan"],
                    help="fused: the route generation_sampler picks with use_pallas on; "
                         "scan: use_pallas off, the plain scan sampler")


def load_model(path: str, device, compute_dtype: str, sampler: str, num_conditions=None,
               asserted: dict = None):
    """``(ckpt, params on device, mcfg)`` of a checkpoint: the shape read
    from its decoder (``cli/generate.py:infer_model_shape``), every entry of
    ``asserted`` that is not None checked against it."""
    from mlx_vae_tpu_torch.cli.generate import infer_model_shape
    from mlx_vae_tpu_torch.config import ModelConfig
    from mlx_vae_tpu_torch.train.checkpoint import load_checkpoint
    from mlx_vae_tpu_torch.utils.tree import params_from_numpy

    ckpt = load_checkpoint(path)
    shape = infer_model_shape(ckpt["params"]["decoder"])
    want = dict(asserted or {})
    if num_conditions is not None:
        want["num_conditions"] = num_conditions
    for name, given in want.items():
        if given is not None and given != shape[name]:
            raise SystemExit(f"ERROR: --{name} {given} contradicts the checkpoint "
                             f"(parameter shapes imply {name}={shape[name]})")
    params = {k: params_from_numpy(v, device) for k, v in ckpt["params"].items()}
    mcfg = ModelConfig(compute_dtype=compute_dtype, use_pallas=sampler == "fused", **shape)
    return ckpt, params, mcfg


def route(mcfg, device) -> dict:
    """The sampler the config takes and, on the card, its kernel."""
    from mlx_vae_tpu_torch.models.vae import generation_sampler
    from mlx_vae_tpu_torch.ops.fused_decoder import fused_generate_route

    sampler = generation_sampler(mcfg)
    if sampler != "fused":
        kernel = None
    elif device.type == "cuda":
        kernel = {"tc": "tc::gen_tc_kernel", "steps": "fused_generate_steps.cu (step route)",
                  "cuda_core": "fused_generate_kernel"}[fused_generate_route(mcfg)]
    else:
        kernel = "plain version (CPU)"
    return {"sampler": sampler, "kernel": kernel, "compute_dtype": mcfg.compute_dtype}


def draw(seed: int, rows: int, latent: int, device):
    """``(z [rows, latent], generator)``: z drawn first from a generator
    seeded with ``seed``, which then gives the sampler its seeds."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randn((rows, latent), generator=g, device=device), g


def synthetic_achieved(toks: np.ndarray, vocab_size: int) -> np.ndarray:
    from mlx_vae_tpu_torch.data.prepare import synthetic_tpsa

    return np.array([synthetic_tpsa(t, vocab_size) for t in toks])


def achieved_descriptors(toks, alphabet, prop_keys):
    """Decode rows -> ``(decoded rows, {key: values})`` for every
    conditioned property (the shared decode-and-perceive pass,
    ``data/metrics.py:decoded_mols``)."""
    from mlx_vae_tpu_torch.chem.descriptors import clogp, mol_weight, tpsa
    from mlx_vae_tpu_torch.data.metrics import decoded_mols

    fns = {"tpsa": tpsa, "logp": clogp, "mw": mol_weight}
    vals = {k: [] for k in prop_keys}
    n_dec = 0
    for mol in decoded_mols(toks, alphabet):
        n_dec += 1
        for k in prop_keys:
            vals[k].append(fns[k](mol))
    return n_dec, {k: np.asarray(v) for k, v in vals.items()}


def score(toks: np.ndarray, target: float, vocab_size: int, chem: bool, prop_keys,
          alphabet, mean) -> dict:
    """One target's row, in the JAX script's mode and schema."""
    if chem and len(prop_keys) > 1:
        n_dec, desc = achieved_descriptors(toks, alphabet, prop_keys)
        if n_dec == 0:
            raise SystemExit("nothing decoded — wrong checkpoint/corpus pairing?")
        swept = desc[prop_keys[0]]
        row = {"target": target,
               "swept_property": prop_keys[0],
               "decoded": n_dec,
               "decode_rate": n_dec / len(toks),
               "achieved_mean": float(swept.mean()),
               "achieved_std": float(swept.std()),
               "mae": float(np.abs(swept - target).mean()),
               "held_properties": {},
               "backend": "vendored-ertl"}
        for i, k in enumerate(prop_keys[1:], start=1):
            held_target = float(mean[0, i])  # z-score 0 = corpus mean
            row["held_properties"][k] = {
                "held_at": held_target,
                "achieved_mean": float(desc[k].mean()),
                "achieved_std": float(desc[k].std()),
                "mae": float(np.abs(desc[k] - held_target).mean()),
            }
        return row
    if chem:
        from mlx_vae_tpu_torch.data.metrics import molecule_metrics

        mm = molecule_metrics(toks, alphabet, target_tpsa=target, sample=len(toks))
        if mm is None or "tpsa_mean" not in mm:
            raise SystemExit("chemistry backend unavailable or nothing decoded")
        return {"target": target,
                "decoded": mm["decoded"],
                "decode_rate": mm["decoded"] / mm["sampled"],
                "achieved_mean": mm.get("tpsa_mean"),
                "achieved_std": mm.get("tpsa_std"),
                "mae": mm.get("tpsa_mae"),
                "backend": "vendored-ertl"}
    achieved = synthetic_achieved(toks, vocab_size)
    return {"target": target,
            "achieved_mean": float(achieved.mean()),
            "achieved_std": float(achieved.std()),
            "mae": float(np.abs(achieved - target).mean())}


def corpus_alphabet(path: str):
    with open(path) as f:
        alphabet = json.load(f).get("alphabet")
    if not alphabet:
        raise SystemExit("--chem needs a corpus JSON with an 'alphabet' "
                         "(prepare.py --drug_like / --smiles)")
    return alphabet


def write_output(path: str, doc: dict) -> None:
    from mlx_vae_tpu_torch.studies.elbo_compare import _write_json

    _write_json(path, doc)
    print(f"wrote {path}")


def main(argv=None) -> dict:
    """Run the study; returns the written document: ``results`` (the JAX
    script's rows), ``route`` (sampler, kernel, dtype), ``tokens_device``
    and ``config``."""
    from mlx_vae_tpu_torch.cli.common import resolve_device
    from mlx_vae_tpu_torch.cli.generate import make_generate_fn
    from mlx_vae_tpu_torch.data.split import load_and_split
    from mlx_vae_tpu_torch.studies.elbo_compare import refuse_benchmarks_path

    args = build_parser().parse_args(argv)
    refuse_benchmarks_path(args.output)
    device = resolve_device(args.device)
    prop_keys = tuple(k.strip() for k in args.properties.split(",") if k.strip())
    _, params, mcfg = load_model(args.checkpoint, device, args.compute_dtype, args.sampler,
                                 len(prop_keys), {k: getattr(args, k) for k in SHAPE_FLAGS})
    train_ds, _, _, _ = load_and_split(args.data, property_keys=prop_keys)
    mean, std = train_ds.properties_mean, train_ds.properties_std
    alphabet = corpus_alphabet(args.data) if args.chem else None

    gen = make_generate_fn(mcfg, params["decoder"], args.max_length, args.temperature,
                           greedy=False)
    results, devices = [], set()
    for target in args.targets:
        # sweep property 0; hold the rest at their corpus means (z-score 0)
        cond = torch.zeros((args.batch_size, len(prop_keys)), device=device)
        cond[:, 0] = float((target - mean[0, 0]) / std[0, 0])
        z, g = draw(args.seed, args.batch_size, mcfg.latent_dim, device)
        out = gen(z, cond, g)
        devices.add(str(out.device))
        toks = out.cpu().numpy()
        results.append(score(toks, target, mcfg.vocab_size, args.chem, prop_keys, alphabet,
                             mean))
        r = results[-1]
        print(f"target {target:6.1f}: achieved {r['achieved_mean']:6.1f} "
              f"± {r['achieved_std']:5.1f} (MAE {r['mae']:.1f})")

    doc = {"results": results, "route": route(mcfg, device),
           "tokens_device": sorted(devices),
           "config": {"checkpoint": args.checkpoint, "targets": args.targets,
                      "batch_size": args.batch_size, "max_length": args.max_length,
                      "temperature": args.temperature, "chem": args.chem,
                      "properties": list(prop_keys), "seed": args.seed,
                      "device": str(device), "torch": torch.__version__}}
    write_output(args.output, doc)
    return doc


if __name__ == "__main__":
    main()
