"""Traffic kind ``gen_requests``: bulk generation in a closed loop with one
client, as a design pipeline waits on ``cli.generate``: each request draws
z for ``batch`` molecules at one target condition, runs
``cli/generate.py:make_generate_fn``'s ``generate(z, cond, generator)`` and
brings the tokens to the host as uint8; the next request is issued when
they are there. Every request of the window samples at ``temperature``.

The mix's parameters: ``batch``, ``seq_len``, ``temperature``, ``top_k``,
``top_p``; ``warmup_requests`` (set-up; the last one greedy, the rest
sampled); ``checked_requests`` (how many of the window's requests the
reference judges, drawn from the seed by reservoir sampling, and how many
greedy requests of the same size run through the greedy twin of the
window's ``generate`` once the window has closed, judged too);
``trace_seconds`` (the profiled stretch). The targets are N(0, 1), drawn on
the host from the seed; z and the sampler's generator are on the device,
seeded from the seed.

The greedy requests are what lets the check see a precision: at the logits
of a random-init model, a sampled token changes only where the Gumbel noise
leaves two scores within the error, while an argmax does so wherever two
logits do. They run outside the window, so that the window holds the
sampled traffic alone.
"""

from __future__ import annotations

import random
import statistics
import time

import torch

from portbench import harness
from portbench.reference import arcvae as ref


def run(ctx) -> dict:
    from mlx_vae_tpu_torch.cli.generate import make_generate_fn

    cfg, mix, dev, spans = ctx.cfg, ctx.mix, ctx.device, ctx.spans
    split = harness.SetupSplit(ctx.t_start, dev)
    mcfg = ctx.model_config()
    B, L, Z, C = mix["batch"], mix["seq_len"], cfg["latent_dim"], cfg["num_conditions"]
    dec = ref.make_params(cfg, ctx.seed, dev, parts=("decoder",))["decoder"]
    split("params")
    make = ctx.hooks.get("make_generate_fn", make_generate_fn)
    fns = [make(mcfg, dec, L, mix["temperature"], greedy, mix["top_k"], mix["top_p"])
           for greedy in (False, True)]
    split("make_generate_fn (prepare_weights)")
    targets = random.Random(ref.sub_seed(ctx.seed, "targets"))
    pick = random.Random(ref.sub_seed(ctx.seed, "sample"))
    gz = torch.Generator(device=dev)
    gz.manual_seed(ref.sub_seed(ctx.seed, "z"))
    gs = torch.Generator(device=dev)
    gs.manual_seed(ref.sub_seed(ctx.seed, "sampler"))
    kept = {}  # slot -> (z, target, sampler state, tokens, greedy); window's < k <= greedy's
    k = mix["checked_requests"]

    def request(greedy: bool, slot=None):
        """One request; one given a ``slot`` is kept for the check."""
        target = targets.gauss(0.0, 1.0)
        with spans("draw_z"):
            z = torch.randn((B, Z), generator=gz, device=dev)
            cond = torch.full((B, C), target, dtype=torch.float32, device=dev)
        state = gs.get_state() if slot is not None else None
        with spans("generate"):
            toks = fns[greedy](z, cond, gs)
        with spans("tokens_to_host"):
            host = toks.to(torch.uint8).cpu().numpy()
        if slot is not None:
            kept[slot] = (z, target, state, host, greedy)

    for i in range(mix["warmup_requests"]):
        request(i == mix["warmup_requests"] - 1)
        split(f"warm-up request {i + 1}")
    setup_s = time.perf_counter() - ctx.t_start

    spans.reset()
    lat = []
    t0 = time.perf_counter()
    while True:
        n = len(lat)
        slot = n if n < k else pick.randrange(n + 1)
        ts = time.perf_counter()
        request(False, slot if slot < k else None)
        lat.append(time.perf_counter() - ts)
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    n = len(lat)
    p95 = (statistics.quantiles(lat, n=20, method="inclusive")[18] if n > 1 else lat[0])
    out = {"e2e": {"gen_mols_per_s": n * B / window_s, "gen_p95_ms": p95 * 1e3,
                   "setup_s": setup_s},
           "window": {"seconds": window_s, "units": n,
                      "spans": {k_: (v, spans.count[k_]) for k_, v in spans.total.items()}},
           "attempted": n, "failed": 0, "trace": None}
    for i in range(k):
        request(True, k + i)

    if ctx.trace:
        done = [0]

        def stretch():
            t_end = time.perf_counter() + mix["trace_seconds"]
            while done[0] < 2 or time.perf_counter() < t_end:
                request(False)
                done[0] += 1

        out["trace"] = harness.profile_stretch(stretch, spans, dev)
        out["trace"]["units"] = done[0]

    out["device"] = harness.device_record(dev, out["trace"])
    harness.log(f"gen: {n} requests of {B} in {window_s:.3f} s, setup {setup_s:.3f} s, "
                f"p50 {statistics.median(lat) * 1e3:.3f} ms, p95 {p95 * 1e3:.3f} ms")
    del fns
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    del dec
    out["kept"] = [kept[s] for s in sorted(kept)]
    gap = check(ctx, out["kept"])
    out["checks"] = {"logit_gap": {"value": gap, "limit": ctx.limits["logit_gap"]}}
    return out


def request_seeds(state, B: int, device) -> torch.Tensor:
    """The block seeds the sampler drew first from its generator, in
    ``state``: one int32 in [0, 2**31 - 1) per ``min(256, B)`` rows."""
    g = torch.Generator(device=device)
    g.set_state(state)
    nb = -(-B // min(256, B))
    return torch.randint(0, 2**31 - 1, (nb,), generator=g, device=device, dtype=torch.int32)


def served_gap(scores: torch.Tensor, tokens: torch.Tensor, chosen=None) -> float:
    """The widest gap by which a served token's score lies below the best
    score of its position, over every position up to and including the
    row's end token (``chosen``, when given, replaces the served tokens as
    the judged choice: a control's picks). Inf where a token lies outside
    the vocabulary or a position after the end is not the pad token."""
    V = scores.shape[-1]
    tokens = tokens.long()
    if bool(((tokens < 0) | (tokens >= V)).any()):
        return float("inf")
    is_end = tokens == ref.END
    after = (torch.cumsum(is_end.int(), dim=1) - is_end.int()) > 0
    if bool((tokens[after] != ref.PAD).any()):
        return float("inf")
    pick = tokens if chosen is None else chosen.long()
    gap = scores.max(dim=-1).values - scores.gather(-1, pick[..., None])[..., 0]
    return float(gap[~after].max())


def check(ctx, kept: list, control=None) -> float:
    """The reference's scores along each kept request's served tokens (a
    greedy request's: the logits over T, no noise); the widest gap
    (:func:`served_gap`). ``control``, when given, is a function of the
    same arguments as ``ref.perturbed_logits`` whose argmax is judged in
    place of the served tokens."""
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    dec = ref.make_params(cfg, ctx.seed, dev, parts=("decoder",))["decoder"]
    C = cfg["num_conditions"]
    worst = 0.0
    for z, target, state, host, greedy in kept:
        B = z.shape[0]
        cond = torch.full((B, C), target, dtype=torch.float32, device=dev)
        tokens = torch.as_tensor(host, device=dev).long()
        seeds = None if greedy else request_seeds(state, B, dev)
        args = (dec, cfg, z, cond, tokens, seeds, mix["temperature"])
        scores = ref.perturbed_logits(*args)
        chosen = None if control is None else control(*args).argmax(dim=-1)
        worst = max(worst, served_gap(scores, tokens, chosen))
    return worst
