"""The port's latent helpers against the JAX package's on the same seeded
numpy inputs: ``models/latent_eval.py`` (``latent_statistics`` within 1e-6
relative with ``active_units`` exact; ``reconstruction_metrics`` and
``latent_path`` within 1e-6) and ``models/latent_opt.py``
(``optimize_latent`` from one shared ``z0``, target and predictor: z, the
objective trajectory and both predictions within 1e-5 in f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_vae_tpu.config import ModelConfig as JaxConfig
from mlx_vae_tpu.models import latent_eval as jeval
from mlx_vae_tpu.models import latent_opt as jopt
from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.models import latent_eval as teval
from mlx_vae_tpu_torch.models import latent_opt as topt

TINY = dict(vocab_size=24, embedding_dim=16, hidden_dim=32, latent_dim=8, num_conditions=2,
            num_layers=1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _latents(case: str):
    rng = np.random.default_rng({"random": 0, "prior": 1, "collapsed": 2}[case])
    if case == "prior":  # q(z|x) = N(0, I): KL 0, MI 0, no active unit
        return np.zeros((64, 8), np.float32), np.zeros((64, 8), np.float32)
    mu = rng.normal(0, 1, (300, 8)).astype(np.float32)
    logvar = rng.normal(-1, 0.4, (300, 8)).astype(np.float32)
    if case == "collapsed":  # dims 3-7 constant over x
        mu[:, 3:] = 0.25
    return mu, logvar


@pytest.mark.parametrize("case", ["random", "prior", "collapsed"])
@pytest.mark.parametrize("threshold", [0.01, 0.5])
def test_latent_statistics_matches_jax(case, threshold):
    mu, logvar = _latents(case)
    got = teval.latent_statistics(mu, logvar, au_threshold=threshold)
    want = jeval.latent_statistics(mu, logvar, au_threshold=threshold)
    assert got.keys() == want.keys()
    assert got["active_units"] == want["active_units"]
    assert got["au_threshold"] == want["au_threshold"]
    for k in ("kl_per_dim", "kl_total", "mu_variance_per_dim", "active_fraction"):
        assert _rel(got[k], want[k]) <= 1e-6, k
    assert isinstance(got["mutual_information"], float)
    assert got["mutual_information"] == pytest.approx(want["mutual_information"],
                                                      rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("seed", [0, 1])
def test_reconstruction_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    tgt = rng.integers(0, 12, (40, 16)).astype(np.int32)
    tgt[:, 10:] = 0  # pad tails
    gen = np.where(rng.random(tgt.shape) < 0.8, tgt, rng.integers(0, 12, tgt.shape))
    gen[:5] = tgt[:5]  # exact rows
    got, want = teval.reconstruction_metrics(gen, tgt), jeval.reconstruction_metrics(gen, tgt)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == pytest.approx(want[k], abs=1e-6)
    with pytest.raises(ValueError, match="shape mismatch"):
        teval.reconstruction_metrics(gen[:, :5], tgt)


def _endpoints(case: str):
    rng = np.random.default_rng(5)
    za, zb = rng.normal(0, 1, 8), rng.normal(0, 1, 8)
    if case == "parallel":
        zb = -2.5 * za
    elif case == "zero":
        za = np.zeros(8)
    return za.astype(np.float32), zb.astype(np.float32)


@pytest.mark.parametrize("mode", ["slerp", "lerp"])
@pytest.mark.parametrize("case", ["general", "parallel", "zero"])
def test_latent_path_matches_jax(mode, case):
    za, zb = _endpoints(case)
    got = teval.latent_path(za, zb, 9, mode=mode)
    want = jeval.latent_path(za, zb, 9, mode=mode)
    assert got.shape == (9, 8) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[0], za, atol=1e-6)
    np.testing.assert_allclose(got[-1], zb, atol=1e-6)


def test_latent_path_refusals_match_jax():
    for kw in ({"steps": 1}, {"steps": 3, "mode": "cubic"}):
        for mod in (teval, jeval):
            with pytest.raises(ValueError):
                mod.latent_path(np.zeros(4), np.ones(4), **kw)
    with pytest.raises(ValueError, match="endpoint shape"):
        teval.latent_path(np.zeros(4), np.ones(5), 3)


def _predictor(seed: int, scale: float):
    rng = np.random.default_rng(seed)
    H, D, C = TINY["hidden_dim"], TINY["latent_dim"], TINY["num_conditions"]
    return {"fc_hidden": {"weight": (scale * rng.normal(0, 1, (H, D))).astype(np.float32),
                          "bias": rng.normal(0, 0.5, H).astype(np.float32)},
            "fc_out": {"weight": (scale * rng.normal(0, 1, (C, H))).astype(np.float32),
                       "bias": rng.normal(0, 0.5, C).astype(np.float32)}}


def _both(pp, z0, target, **kw):
    jz, jinfo = jopt.optimize_latent(
        {"predictor": {k: {n: jnp.asarray(a) for n, a in v.items()} for k, v in pp.items()}},
        JaxConfig(**TINY), jnp.asarray(z0), jnp.asarray(target), **kw)
    tz, tinfo = topt.optimize_latent(
        {"predictor": {k: {n: torch.from_numpy(a) for n, a in v.items()}
                       for k, v in pp.items()}},
        ModelConfig(**TINY), torch.from_numpy(z0), torch.from_numpy(target), **kw)
    return (tz.numpy(), {k: v.numpy() for k, v in tinfo.items()},
            np.asarray(jz), {k: np.asarray(v) for k, v in jinfo.items()})


# (prior_weight, z_clip, lr, steps): the default descent, no prior term, and
# a clip that binds (a coarse step and a tight bound)
OPT_CASES = {"default": (0.01, 3.0, 0.05, 120), "no_prior": (0.0, 3.0, 0.05, 120),
             "clip_active": (0.01, 0.4, 0.2, 60)}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimize_latent_matches_jax(case):
    prior_weight, z_clip, lr, steps = OPT_CASES[case]
    rng = np.random.default_rng(21)
    z0 = rng.normal(0, 1, (32, TINY["latent_dim"])).astype(np.float32)
    target = np.array([1.5, -0.5], np.float32)
    pp = _predictor(3, 0.3)
    tz, tinfo, jz, jinfo = _both(pp, z0, target, steps=steps, lr=lr,
                                 prior_weight=prior_weight, z_clip=z_clip)
    assert tinfo["objective"].shape == (steps + 1,)
    assert np.abs(tz - jz).max() <= 1e-5
    for k in ("objective", "pred_init", "pred_final"):
        assert np.abs(tinfo[k] - jinfo[k]).max() <= 1e-5 * max(1.0, np.abs(jinfo[k]).max()), k
    assert tinfo["objective"][-1] < tinfo["objective"][0]
    assert np.abs(tz).max() <= z_clip
    if case == "clip_active":
        assert np.isclose(np.abs(tz), z_clip).mean() > 0.05  # the bound binds


def test_latent_objective_matches_jax_and_broadcasts():
    pp = _predictor(4, 0.3)
    z = np.random.default_rng(8).normal(0, 1, (6, TINY["latent_dim"])).astype(np.float32)
    for target in (np.array([0.5, 1.0], np.float32),
                   np.random.default_rng(9).normal(0, 1, (6, 2)).astype(np.float32)):
        got = topt.latent_objective({k: {n: torch.from_numpy(a) for n, a in v.items()}
                                     for k, v in pp.items()}, ModelConfig(**TINY),
                                    torch.from_numpy(z), torch.from_numpy(target), 0.05)
        want = jopt.latent_objective(pp, JaxConfig(**TINY), jnp.asarray(z),
                                     jnp.asarray(target), 0.05)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_missing_predictor_raises_the_jax_message():
    with pytest.raises(ValueError, match="use_property_predictor") as got:
        topt.optimize_latent({"decoder": {}}, ModelConfig(**TINY), torch.zeros(2, 8),
                             torch.zeros(2), steps=1)
    with pytest.raises(ValueError) as want:
        jopt.optimize_latent({"decoder": {}}, JaxConfig(**TINY), jnp.zeros((2, 8)),
                             jnp.zeros((2,)), steps=1)
    assert str(got.value) == str(want.value)
