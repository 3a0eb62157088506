"""The readings the limits of ``correct`` are set from, for one cell, in one
process (the build and the first launches paid once):

* ``program``: the cell as committed, on each seed of ``--seeds``, with a
  short window (``--seconds``): the lower readings;
* ``tf32``: the reference in the program's place at TF32, the nearest
  precision below the configuration's f32 with TF32 off (train: the
  reference's step as the window's step; generation: the reference's
  TF32 scores choose each position's token);
* ``bf16``: the program with its own lower precision switched on
  (``compute_dtype=bfloat16``);
* ``half_batch`` (train): the program's step on the first half of each
  batch, its mean taken over those rows.

The controls run on the first ``--controls`` seeds. Their smallest reading
of each number is its upper reading.

    python -m portbench.control --workload train-default --seeds 1,2,3 \\
        --controls 3 --seconds 0.5 --output chiprun_out/control.json
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from portbench import harness
from portbench import run as R
from portbench.reference import arcvae as ref


@contextlib.contextmanager
def tf32():
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def reference_train_step(params, opt, mcfg, tcfg, tokens_all, props_all, idx, generator, beta,
                         tf_ratio, noise=None):
    """The reference's step at TF32 with ``train_step_gather``'s signature,
    on the program's params and Adam state."""
    from portbench.traffic.train_steps import LOSS_KEYS

    x, c = tokens_all[idx].to(torch.int32), props_all[idx]
    state = {f"{part}.{key}.{name}": (opt[part]["m"][key][name], opt[part]["v"][key][name])
             for part, keys in params.items() for key, names in keys.items() for name in names}
    tdict = {k: getattr(tcfg, k) for k in ("learning_rate", "adam_b1", "adam_b2", "adam_eps",
                                           "grad_clip", "free_bits", "target_mi",
                                           "lambda_collapse", "lambda_mi", "lambda_prop")}
    with tf32():
        ls, _ = ref.train_step(params, state, mcfg_dict(mcfg), tdict, x, c, noise["eps"],
                               noise["tf_mask"], beta)
    m = {k: torch.tensor(ls[k], device=x.device) for k in LOSS_KEYS}
    return params, opt, m


def mcfg_dict(mcfg) -> dict:
    return {k: getattr(mcfg, k) for k in ("vocab_size", "embedding_dim", "hidden_dim",
                                          "latent_dim", "num_conditions", "num_layers")}


def half_batch_step(params, opt, mcfg, tcfg, tokens_all, props_all, idx, generator, beta,
                    tf_ratio, noise=None):
    """The program's step on the first half of the batch."""
    from mlx_vae_tpu_torch.train.steps import train_step_gather

    h = idx.shape[0] // 2
    return train_step_gather(params, opt, mcfg, tcfg, tokens_all, props_all, idx[:h], generator,
                             beta, tf_ratio, noise={"eps": noise["eps"][:h],
                                                    "tf_mask": noise["tf_mask"]})


def readings(c, seed, seconds, dev, hooks=None, compute_dtype=None, gen_control=False):
    """The check's numbers of one run (``gen_control``: also the TF32
    control's generation gap on the same requests)."""
    if compute_dtype:
        c.cfg = {**c.cfg, "compute_dtype": compute_dtype}
    ctx = R.context(c, seed, seconds, False, dev, hooks)
    kind = harness.load_module(harness.ROOT / "traffic" / f"{c.mix['kind']}.py")
    out = kind.run(ctx)
    got = {k: v["value"] for k, v in out["checks"].items()}
    if not gen_control:
        return got

    def control(*a):
        with tf32():
            return ref.perturbed_logits(*a)

    return got, {"logit_gap": kind.check(ctx, out["kept"], control=control)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--seconds", type=float, default=0.5)
    p.add_argument("--output", default=None)
    args = p.parse_args(argv)
    R.set_cache_dirs()
    if not torch.cuda.is_available():
        harness.log("control: no CUDA card")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    base = R.cell(args.workload)
    kind = base.mix["kind"]
    res = {"workload": args.workload, "device": R.power_limit(), "program": {}, "tf32": {},
           "bf16": {}, "half_batch": {}}

    def fresh():
        return R.cell(args.workload)

    for i, seed in enumerate(seeds):
        ctl = i < args.controls
        if kind == "gen_requests" and ctl:
            res["program"][seed], res["tf32"][seed] = readings(fresh(), seed, args.seconds, dev,
                                                               gen_control=True)
        else:
            res["program"][seed] = readings(fresh(), seed, args.seconds, dev)
        harness.log(f"program seed {seed}: {res['program'][seed]}")
        if not ctl:
            continue
        if kind == "train_steps":
            res["tf32"][seed] = readings(fresh(), seed, args.seconds, dev,
                                         hooks={"train_step_gather": reference_train_step})
            res["half_batch"][seed] = readings(fresh(), seed, args.seconds, dev,
                                               hooks={"train_step_gather": half_batch_step})
        res["bf16"][seed] = readings(fresh(), seed, args.seconds, dev,
                                     compute_dtype="bfloat16")
        harness.log(f"controls seed {seed}: tf32 {res['tf32'][seed]} bf16 {res['bf16'][seed]} "
                    f"half {res['half_batch'].get(seed)}")
    names = list(next(iter(res["program"].values())))
    summary = {n: {"lower": max(r[n] for r in res["program"].values())} for n in names}
    for ctl in ("tf32", "bf16", "half_batch"):
        for n in names:
            vals = [r[n] for r in res[ctl].values() if n in r]
            if vals:
                summary[n][ctl] = min(vals)
    res["summary"] = summary
    harness.log(json.dumps(summary))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
