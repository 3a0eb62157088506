"""CPU tests of the benchmark's files, work counts, traffic, reference and
faults; the one test that needs the card is marked ``cuda`` and skips
without one.

    python -m pytest portbench/tests -q          # here
    python -m pytest portbench/tests -q -m cuda  # on the card
"""

from __future__ import annotations

import ast
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness
from portbench import run as R
from portbench.reference import arcvae as ref
from portbench.traffic import gen_requests, train_steps
from portbench.work import arcvae as work

ROOT = harness.ROOT
BENCH = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TINY = {"vocab_size": 24, "embedding_dim": 16, "hidden_dim": 32, "latent_dim": 8,
        "num_layers": 2}
CPU = torch.device("cpu")


def tiny(name: str):
    c = R.cell(name)
    c.cfg = {**c.cfg, **TINY}
    if c.mix["kind"] == "train_steps":
        c.mix = {**c.mix, "corpus": 200, "batch": 32, "seq_len": 12, "min_len": 4,
                 "max_len": 11, "trace_seconds": 0.2}
    else:
        c.mix = {**c.mix, "batch": 40, "seq_len": 12, "trace_seconds": 0.2}
    return c


def drive(name: str, hooks=None, trace=False, seed=2**31 + 7):
    c = tiny(name)
    return R.drive(c, R.context(c, seed, 0.3, trace, CPU, hooks))


# ---------------------------------------------------------------- files


def test_benchmark_names_units_and_files():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        cfg = harness.load_json(harness.CHECKOUT / c["file"])
        assert (ROOT / "work" / f"{cfg['family']}.py").exists()
        assert (ROOT / "reference" / f"{cfg['family']}.py").exists()
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        mix = harness.load_json(ROOT / "mixes" / f"{w['traffic']}.json")
        assert (ROOT / "traffic" / f"{mix['kind']}.py").exists()
        assert harness.load_json(ROOT / "limits" / f"{w['name']}.json")
        c = R.cell(w["name"], BENCH)
        assert "setup_s" in {m["name"] for m in c.e2e} and len(c.e2e) >= 2 and c.per_layer
        for m in c.per_layer:
            assert w["name"] in e2e[m["moves"]].get("workloads", [w["name"]])
    for m in BENCH["per_layer"]:
        assert (ROOT / "metrics" / f"{m['name']}.py").exists()


# ----------------------------------------------------------- work counts


def test_train_work_equals_counted_forward():
    cfg = {**harness.load_json(ROOT / "configs" / "arcvae-default.json"), **TINY,
           "num_layers": 3}
    B, L = 6, 7
    p = ref.make_params(cfg, 3, CPU)
    x = torch.randint(0, cfg["vocab_size"], (B, L))
    cond = torch.randn(B, cfg["num_conditions"])
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        mu, logvar = ref.encode(p["encoder"], cfg, x, cond)
        ref.decode_teacher_forced(p["decoder"], cfg, mu, cond, x, torch.ones(L, dtype=torch.bool))
    assert fc.get_total_flops() == work.train_forward_flops(cfg, B, L)
    assert work.train_step_flops(cfg, B, L) == 3 * work.train_forward_flops(cfg, B, L)
    n = sum(t.numel() for _, t in ref.leaves(p))
    assert n == work.n_params(cfg)
    assert sum(t.numel() for _, t in ref.leaves({"decoder": p["decoder"]})) == \
        work.n_params(cfg, ("decoder",))


def test_gen_work_equals_counted_pass():
    cfg = {**harness.load_json(ROOT / "configs" / "arcvae-scaled.json"), **TINY}
    B, L = 5, 9
    dec = ref.make_params(cfg, 4, CPU, ("decoder",))["decoder"]
    z = torch.randn(B, cfg["latent_dim"])
    cond = torch.randn(B, 1)
    toks = torch.randint(0, cfg["vocab_size"], (B, L))
    with FlopCounterMode(display=False) as fc:
        ref.perturbed_logits(dec, cfg, z, cond, toks, torch.arange(1, dtype=torch.int32), 1.0)
    assert fc.get_total_flops() == work.gen_request_flops(cfg, B, L)


# ---------------------------------------------------------------- traffic


def test_traffic_repeats_from_a_seed():
    c = tiny("train-default")
    seed = 2**31 + 99
    a, b = (train_steps.make_corpus(c.cfg, c.mix, seed, CPU) for _ in range(2))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    toks = a[0].long()
    assert bool((toks[:, 0] == 1).all())
    lens = (toks == 2).int().argmax(dim=1) + 1
    assert int(lens.min()) >= c.mix["min_len"] and int(lens.max()) <= c.mix["max_len"]
    f1, f2 = (train_steps.Feed(c.cfg, c.mix, seed, CPU) for _ in range(2))
    seen = []
    for _ in range(8):
        (i1, n1), (i2, n2) = f1.next(), f2.next()
        assert torch.equal(i1, i2) and torch.equal(n1["eps"], n2["eps"])
        assert torch.equal(n1["tf_mask"], n2["tf_mask"])
        seen.append(i1)
    epoch = torch.cat(seen[:c.mix["corpus"] // c.mix["batch"]])
    assert len(set(epoch.tolist())) == epoch.numel()  # rows of an epoch all differ
    assert not torch.equal(train_steps.make_corpus(c.cfg, c.mix, seed + 1, CPU)[0], a[0])


def test_gen_requests_repeat_from_a_seed():
    outs = [drive("gen-default", seed=2**32 + 5) for _ in range(2)]
    assert outs[0]["checks"] == outs[1]["checks"]


# -------------------------------------------------------------- reference


def test_reference_matches_the_ports_plain_train_route():
    from mlx_vae_tpu_torch.config import ModelConfig
    from mlx_vae_tpu_torch.losses.complete import complete_vae_loss

    c = tiny("train-default")
    mcfg = ModelConfig(**{k: c.cfg[k] for k in R.MODEL_KEYS})
    tcfg = c.mix["train"]
    p = ref.make_params(c.cfg, 11, CPU)
    toks, conds = train_steps.make_corpus(c.cfg, c.mix, 11, CPU)
    idx, noise = train_steps.Feed(c.cfg, c.mix, 11, CPU).next()
    x, cond = toks[idx].int(), conds[idx]
    got = complete_vae_loss(p["encoder"], p["decoder"], None, mcfg, x, cond, noise["eps"],
                            noise["tf_mask"], beta=0.05, lambda_prop=tcfg["lambda_prop"],
                            lambda_collapse=tcfg["lambda_collapse"],
                            free_bits=tcfg["free_bits"], lambda_mi=tcfg["lambda_mi"],
                            target_mi=tcfg["target_mi"])
    want = ref.losses(p, c.cfg, tcfg, x, cond, noise["eps"], noise["tf_mask"], 0.05)
    for k in train_steps.LOSS_KEYS:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5, abs=1e-7), k


def test_reference_scores_the_ports_plain_sampler():
    from mlx_vae_tpu_torch.cli.generate import make_generate_fn

    c = tiny("gen-scaled")
    mcfg = R.context(c, 1, 1, False, CPU).model_config()
    dec = ref.make_params(c.cfg, 12, CPU, ("decoder",))["decoder"]
    B, L = 300, 10
    generate = make_generate_fn(mcfg, dec, L, 0.7, False)
    z = torch.randn(B, c.cfg["latent_dim"])
    cond = torch.full((B, 1), 0.3)
    g = torch.Generator().manual_seed(5)
    state = g.get_state()
    toks = generate(z, cond, g)
    seeds = gen_requests.request_seeds(state, B, CPU)
    scores = ref.perturbed_logits(dec, c.cfg, z, cond, toks, seeds, 0.7)
    assert gen_requests.served_gap(scores, toks) < 1e-5
    assert bool((scores.argmax(-1) == toks)[:, 0].all())


# --------------------------------------------------------------- imports


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module)
    return out


def test_no_jax_and_a_reference_free_of_the_program():
    for path in ROOT.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path
        if "reference" in path.relative_to(ROOT).parts:
            assert "mlx_vae_tpu_torch" not in tops, path
            assert tops <= {"__future__", "hashlib", "math", "torch", "portbench"}, path
    assert "mlx_vae_tpu_torch" not in harness.FORBIDDEN  # whole names, not prefixes


def test_run_exits_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "train-default",
                        "--seed", "1", "--seconds", "1"], cwd=harness.CHECKOUT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


# ---------------------------------------------------------- sound, faults


@pytest.mark.parametrize("name", ["train-default", "gen-default"])
def test_sound_tiny_run_is_correct(name):
    out = drive(name, trace=True)
    assert out["correct"], out["checks"]
    assert json.loads(json.dumps(out)) == out
    assert out["breakdown"]["idle_gaps"] and set(out["device"]) >= {"busy_s", "window_s"}


def _unchanged(params, opt, mcfg, tcfg, tokens_all, props_all, idx, generator, beta, tf, noise):
    from mlx_vae_tpu_torch.train.steps import train_step_gather

    saved = {n: {k: v.clone() for k, v in ref.leaves({n: p})} for n, p in params.items()}
    m_saved = {n: [t.clone() for _, t in ref.leaves({n: s["m"]})] for n, s in opt.items()}
    out = train_step_gather(params, opt, mcfg, tcfg, tokens_all, props_all, idx, generator,
                            beta, tf, noise=noise)
    with torch.no_grad():
        for n, p in params.items():
            for k, t in ref.leaves({n: p}):
                t.copy_(saved[n][k])
            for t, s in zip((t for _, t in ref.leaves({n: opt[n]["m"]})), m_saved[n]):
                t.copy_(s)
    return out


def _half(params, opt, mcfg, tcfg, tokens_all, props_all, idx, generator, beta, tf, noise):
    from portbench.control import half_batch_step
    return half_batch_step(params, opt, mcfg, tcfg, tokens_all, props_all, idx, generator,
                           beta, tf, noise)


def _altered(mcfg, dec, L, temperature, greedy, top_k, top_p):
    from mlx_vae_tpu_torch.cli.generate import make_generate_fn

    gen = make_generate_fn(mcfg, dec, L, temperature, greedy, top_k, top_p)

    def generate(z, cond, g):
        toks = gen(z, cond, g).clone()
        toks[3, 0] = (toks[3, 0] + 1) % 3 + 3  # another token where the first is produced
        return toks

    return generate


@pytest.mark.parametrize("name,hooks", [
    ("train-default", {"train_step_gather": _unchanged}),
    ("train-default", {"train_step_gather": _half}),
    ("gen-default", {"make_generate_fn": _altered}),
], ids=["state-unchanged", "half-batch", "token-altered"])
def test_a_broken_timed_path_is_not_correct(name, hooks):
    out = drive(name, hooks=hooks)
    assert not out["correct"], out["checks"]


# ------------------------------------------------------------- on the card


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["train-default", "gen-default"])
def test_control_fails_on_the_card(name):
    """The lower-precision controls at the cell's own size fail the cell's
    limits, and the program passes them, on one seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import control as K

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    c = R.cell(name)
    lim = c.limits
    if c.mix["kind"] == "train_steps":
        prog = K.readings(R.cell(name), 31, 0.2, dev)
        ctl = K.readings(R.cell(name), 31, 0.2, dev,
                         hooks={"train_step_gather": K.reference_train_step})
    else:
        prog, ctl = K.readings(R.cell(name), 31, 0.2, dev, gen_control=True)
    assert all(v <= lim[k] for k, v in prog.items()), prog
    assert any(v > lim[k] for k, v in ctl.items()), ctl
    assert all(math.isfinite(v) for v in prog.values())
