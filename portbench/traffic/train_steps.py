"""Traffic kind ``train_steps``: training on a device-resident corpus, as the
port's trainer (``train/trainer.py:ARCVAETrainer``) drives
``train/steps.py:train_step_gather``: index batches from a shuffled epoch,
the noise passed in, each step's metrics read ``lag`` steps late through
pinned memory.

The mix's parameters: ``corpus`` sequences of ``seq_len`` tokens, each
START (1), tokens drawn from [3, V), END (2), padded with 0, of a length
drawn from [``min_len``, ``max_len``]; conditions N(0, 1); ``batch`` rows a
step; ``beta`` and ``teacher_forcing``; ``train`` (the trainer's
hyperparameters); ``lag``; ``checked_steps`` (the first steps, which the
reference follows); ``trace_seconds`` (the profiled stretch).

Set-up builds the params, Adam's state and the corpus from the seed and
drives the first ``checked_steps`` steps through the window's own call and
feed, keeping their losses, Adam's first moment after step 1 and the params
after the last; the window then goes on with the same objects. The check
(:func:`check`) runs the reference over the same steps once the program's
state is freed.
"""

from __future__ import annotations

import collections
import statistics
import time

import torch

from portbench import harness
from portbench.reference import arcvae as ref

LOSS_KEYS = ("total_loss", "recon_loss", "kl_loss", "collapse_penalty", "prop_loss",
             "mi_penalty")


def make_corpus(cfg: dict, mix: dict, seed: int, device):
    """``(tokens [N, L] uint8, conditions [N, C] f32)`` from the seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(ref.sub_seed(seed, "corpus"))
    N, L, V = mix["corpus"], mix["seq_len"], cfg["vocab_size"]
    lens = torch.randint(mix["min_len"], mix["max_len"] + 1, (N, 1), generator=gen,
                         device=device)
    body = torch.randint(3, V, (N, L), generator=gen, device=device)
    pos = torch.arange(L, device=device)[None]
    toks = torch.where(pos < lens - 1, body, 0)
    toks = torch.where(pos == lens - 1, 2, toks)
    toks[:, 0] = 1
    cond = torch.randn((N, cfg["num_conditions"]), generator=gen, device=device)
    return toks.to(torch.uint8), cond


class Feed:
    """Index batches of shuffled epochs and each step's noise, from the
    seed: ``next() -> (idx [B], {"eps", "tf_mask"})``."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(ref.sub_seed(seed, "feed"))
        self.cfg, self.mix, self.device = cfg, mix, device
        self.per_epoch = mix["corpus"] // mix["batch"]
        self.k = self.per_epoch
        self.perm = None

    def next(self):
        B, L = self.mix["batch"], self.mix["seq_len"]
        if self.k == self.per_epoch:
            self.perm = torch.randperm(self.mix["corpus"], generator=self.gen,
                                       device=self.device)
            self.k = 0
        idx = self.perm[self.k * B:(self.k + 1) * B]
        self.k += 1
        noise = {"eps": torch.randn((B, self.cfg["latent_dim"]), generator=self.gen,
                                    device=self.device),
                 "tf_mask": torch.rand((L,), generator=self.gen, device=self.device)
                 < self.mix["teacher_forcing"]}
        return idx, noise


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def run(ctx) -> dict:
    from mlx_vae_tpu_torch.config import TrainConfig
    from mlx_vae_tpu_torch.train.optim import adam_init
    from mlx_vae_tpu_torch.train.steps import train_step_gather

    cfg, mix, dev, spans = ctx.cfg, ctx.mix, ctx.device, ctx.spans
    split = harness.SetupSplit(ctx.t_start, dev)
    step_fn = ctx.hooks.get("train_step_gather", train_step_gather)
    mcfg = ctx.model_config()
    tcfg = TrainConfig(batch_size=mix["batch"], **mix["train"])
    beta, tf = mix["beta"], mix["teacher_forcing"]
    params = ref.make_params(cfg, ctx.seed, dev)
    opt = {name: adam_init(p) for name, p in params.items()}
    tokens, conds = make_corpus(cfg, mix, ctx.seed, dev)
    feed = Feed(cfg, mix, ctx.seed, dev)
    split("params, Adam state, corpus")
    pending = collections.deque()
    failed = [0]
    readings = []

    def read_one():
        vals = pending.popleft().get()
        if not all(map(lambda v: v == v and abs(v) != float("inf"), vals.values())):
            failed[0] += 1
        return vals

    def one_step():
        with spans("draw_batch"):
            idx, noise = feed.next()
        with spans("train_step_gather"):
            _, _, m = step_fn(params, opt, mcfg, tcfg, tokens, conds, idx, None, beta, tf,
                              noise=noise)
        pending.append(harness.Readback(m, LOSS_KEYS))
        return idx, noise

    # set-up: the checked steps, through the window's call and feed
    checked = []
    for k in range(mix["checked_steps"]):
        checked.append(one_step())
        if k == 0:
            m1 = {name: _clone(st["m"]) for name, st in opt.items()}
            split("first step")
    p_last = _clone(params)
    while pending:
        readings.append(read_one())
    split("later checked steps")
    setup_s = time.perf_counter() - ctx.t_start

    # the window
    spans.reset()
    t0 = time.perf_counter()
    steps = 0
    while True:
        one_step()
        steps += 1
        with spans("metrics_readback"):
            while len(pending) > mix["lag"]:
                read_one()
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    with spans("metrics_readback"):
        while pending:
            read_one()
        harness.sync(dev)
    window_s = time.perf_counter() - t0
    B, L = mix["batch"], mix["seq_len"]
    out = {"e2e": {"train_tokens_per_s": steps * B * L / window_s, "setup_s": setup_s},
           "window": {"seconds": window_s, "units": steps,
                      "spans": {k: (v, spans.count[k]) for k, v in spans.total.items()}},
           "attempted": steps, "failed": failed[0], "trace": None}

    if ctx.trace:
        done = [0]

        def stretch():
            t_end = time.perf_counter() + mix["trace_seconds"]
            while done[0] < 2 or time.perf_counter() < t_end:
                one_step()
                done[0] += 1
                with spans("metrics_readback"):
                    while len(pending) > mix["lag"]:
                        read_one()
            with spans("metrics_readback"):
                while pending:
                    read_one()

        out["trace"] = harness.profile_stretch(stretch, spans, dev)
        out["trace"]["units"] = done[0]

    out["device"] = harness.device_record(dev, out["trace"])
    harness.log(f"train: {steps} steps in {window_s:.3f} s, setup {setup_s:.3f} s; "
                f"losses of the checked steps {[r['total_loss'] for r in readings]}")
    del params, opt, feed
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = check(ctx, tokens, conds, checked, readings, m1, p_last, tcfg)
    return out


def leaf_gap(prog: dict, refs: dict, paths) -> float:
    """The worst leaf's gap of norms, ``|‖prog‖ - ‖ref‖|`` over the larger of
    the reference leaf's norm and the median leaf's."""
    norms = {p: float(refs[p].norm()) for p in paths}
    med = statistics.median(norms.values())
    return max(abs(float(prog[p].norm()) - norms[p]) / max(norms[p], med, 1e-30)
               for p in paths)


def check(ctx, tokens, conds, checked, readings, m1, p_last, tcfg) -> dict:
    """The reference over the checked steps, against the program's
    readings: ``loss_gap`` (every step's loss components and total, each
    gap over the reference's total), ``grad_gap`` (the first step's clipped
    gradient as Adam got it), ``change_gap`` (the params' change over the
    checked steps, leaves the reference does not move left out)."""
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    tdict = {k: getattr(tcfg, k) for k in ("learning_rate", "adam_b1", "adam_b2", "adam_eps",
                                           "grad_clip", "free_bits", "target_mi",
                                           "lambda_collapse", "lambda_mi", "lambda_prop")}
    params = ref.make_params(cfg, ctx.seed, dev)
    p0 = _clone(params)
    state = ref.adam_state(params)
    ref_losses, g1 = [], None
    for k, (idx, noise) in enumerate(checked):
        x, c = tokens[idx].to(torch.int32), conds[idx]
        ls, grads = ref.train_step(params, state, cfg, tdict, x, c, noise["eps"],
                                   noise["tf_mask"], mix["beta"])
        ref_losses.append(ls)
        if k == 0:
            g1 = grads
    # each component's gap over the step's total: the mutual-information
    # penalties are small differences of large sums, whose own relative
    # rounding is far above the loss's
    gaps = {(step + 1, k): abs(r[k] - rl[k]) / max(abs(rl["total_loss"]), 1e-30)
            for step, (r, rl) in enumerate(zip(readings, ref_losses)) for k in LOSS_KEYS}
    worst = max(gaps, key=gaps.get)
    loss_gap = gaps[worst]
    step, key = worst
    harness.log(f"loss_gap at step {step}, {key}: program {readings[step - 1][key]!r}, "
                f"reference {ref_losses[step - 1][key]!r}")
    b1 = tcfg.adam_b1
    prog_g = {p: t / (1 - b1) for p, t in ref.leaves(m1)}
    paths = list(g1)
    grad_gap = leaf_gap(prog_g, g1, paths)
    gnorm = {p: float(g1[p].norm()) for p in paths}
    gmed = statistics.median(gnorm.values())
    moved = [p for p in paths if gnorm[p] >= 1e-3 * gmed]
    start = dict(ref.leaves(p0))
    d_prog = {p: t - start[p] for p, t in ref.leaves(p_last)}
    d_ref = {p: t.detach() - start[p] for p, t in ref.leaves(params)}
    change_gap = leaf_gap(d_prog, d_ref, moved)
    harness.log(f"reference losses {[r['total_loss'] for r in ref_losses]}; "
                f"{len(paths) - len(moved)} leaves left out of the change")
    lim = ctx.limits
    return {"loss_gap": {"value": loss_gap, "limit": lim["loss_gap"]},
            "grad_gap": {"value": grad_gap, "limit": lim["grad_gap"]},
            "change_gap": {"value": change_gap, "limit": lim["change_gap"]}}
