"""Port losses vs the JAX package on the same inputs.

Every loss of ``losses/``: unmasked CE, KL with its clips and free bits,
both MI epsilon variants (the loss's and the monitor's), the collapse
penalty, the property MSE, the stable variants, the stage-wise encoder and
decoder losses, and ``complete_vae_loss``'s 12-key dict on both routes
(the scan decoder, and the fused decoder + CE) with the noise the JAX key
draws. Tolerance: float32 1e-5 (sums in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_vae_tpu import losses as jl
from mlx_vae_tpu.config import ModelConfig as JaxConfig
from mlx_vae_tpu.models import ARCVAE
from mlx_vae_tpu_torch import losses as tl
from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.utils.tree import params_from_numpy

KEYS = ("total_loss", "recon_loss", "kl_loss", "weighted_kl", "collapse_penalty",
        "prop_loss", "weighted_prop_loss", "mutual_info", "mi_penalty", "mu", "logvar", "z")


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _latents(seed=0, B=16, D=8, scale=1.5):
    rng = np.random.default_rng(seed)
    mu = (scale * rng.standard_normal((B, D))).astype(np.float32)   # some beyond the clips
    logvar = (scale * rng.standard_normal((B, D)) - 1.0).astype(np.float32)
    return mu, logvar


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_reconstruction_loss(reduction):
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((4, 7, 11))).astype(np.float32)
    tgt = rng.integers(0, 11, (4, 7)).astype(np.int32)
    tgt[:, -2:] = 0  # pad positions count
    _close(tl.reconstruction_loss(torch.from_numpy(logits), torch.from_numpy(tgt), reduction),
           jl.reconstruction_loss(jnp.asarray(logits), jnp.asarray(tgt), reduction))


@pytest.mark.parametrize("free_bits", [0.0, 1.0, 8.0])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_kl_divergence_and_stable_variant(reduction, free_bits):
    mu, lv = _latents()
    t, j = (torch.from_numpy(mu), torch.from_numpy(lv)), (jnp.asarray(mu), jnp.asarray(lv))
    _close(tl.kl_divergence(*t, reduction, free_bits), jl.kl_divergence(*j, reduction, free_bits))
    kw = dict(mu_clip=2.0, logvar_clip_min=-4.0, logvar_clip_max=1.0)
    _close(tl.kl_divergence_stable(*t, reduction, free_bits, **kw),
           jl.kl_divergence_stable(*j, reduction, free_bits, **kw))


@pytest.mark.parametrize("eps", [0.0, 1e-8])
def test_mutual_information_both_epsilons_and_collapse(eps):
    for seed, scale in ((2, 1.5), (3, 0.05)):  # spread-out and collapsed posteriors
        mu, lv = _latents(seed, scale=scale)
        t, j = (torch.from_numpy(mu), torch.from_numpy(lv)), (jnp.asarray(mu), jnp.asarray(lv))
        _close(tl.mutual_information(*t, eps=eps), jl.mutual_information(*j, eps=eps))
        _close(tl.posterior_collapse(*t, target_mi=4.85, weight=0.3),
               jl.posterior_collapse(*j, target_mi=4.85, weight=0.3))


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_property_prediction_loss(reduction):
    rng = np.random.default_rng(4)
    p, t = rng.standard_normal((2, 9, 3)).astype(np.float32)
    scales = np.array([1.0, 25.0, 0.5], np.float32)
    for s in (None, scales):
        _close(tl.property_prediction_loss(torch.from_numpy(p), torch.from_numpy(t),
                                           None if s is None else torch.from_numpy(s),
                                           reduction),
               jl.property_prediction_loss(jnp.asarray(p), jnp.asarray(t),
                                           None if s is None else jnp.asarray(s), reduction))


@pytest.mark.parametrize("case", ["ok", "nan", "big_recon", "mu_out", "logvar_out", "kl_high"])
def test_check_loss_sanity_agrees(case):
    mu, lv = np.zeros((4, 8), np.float32), np.full((4, 8), -1.0, np.float32)
    total, recon, kl = 3.0, 2.5, 4.0
    if case == "nan":
        total = float("nan")
    elif case == "big_recon":
        recon = 950.0
    elif case == "mu_out":
        mu[0, 0] = 6.0
    elif case == "logvar_out":
        lv[1, 1] = -7.0
    elif case == "kl_high":
        kl = 81.0
    want = jl.check_loss_sanity(total, recon, kl, jnp.asarray(mu), jnp.asarray(lv))
    assert tl.check_loss_sanity(total, recon, kl, torch.from_numpy(mu),
                                torch.from_numpy(lv)) == want
    assert want == (case == "ok")


def _model(with_predictor, n=2, use_pallas=False):
    kw = dict(vocab_size=24, embedding_dim=16, hidden_dim=32, latent_dim=8,
              num_conditions=1, num_layers=n)
    jcfg = JaxConfig(**kw)
    vae = ARCVAE(jcfg, jax.random.PRNGKey(7), with_predictor=with_predictor)
    npp = jax.tree_util.tree_map(np.asarray, vae.params)
    rng = np.random.default_rng(11)
    x = rng.integers(1, 24, (8, 10)).astype(np.int32)
    cond = rng.standard_normal((8, 1)).astype(np.float32)
    return jcfg, ModelConfig(**kw, use_pallas=use_pallas), vae.params, params_from_numpy(npp), \
        x, cond


def _jax_noise(key, B, L, latent, ratio):
    k_rep, k_tf, _ = jax.random.split(key, 3)
    return (torch.from_numpy(np.array(jax.random.normal(k_rep, (B, latent)))),
            torch.from_numpy(np.array(jax.random.uniform(k_tf, (L,)) < ratio)))


@pytest.mark.parametrize("with_predictor,use_pallas", [(True, False), (False, True),
                                                       (True, True)])
def test_complete_vae_loss_dict(with_predictor, use_pallas):
    jcfg, tcfg, jp, tp, x, cond = _model(with_predictor, use_pallas=use_pallas)
    key = jax.random.PRNGKey(5)
    hyp = dict(beta=0.05, lambda_prop=0.1, lambda_collapse=0.001, free_bits=1.0,
               lambda_mi=0.01, target_mi=4.85)
    want = jl.complete_vae_loss(jp["encoder"], jp["decoder"], jp.get("predictor"), jcfg,
                                jnp.asarray(x), jnp.asarray(cond), key,
                                teacher_forcing_ratio=0.7, **hyp)
    eps, tf = _jax_noise(key, 8, 10, 8, 0.7)
    got = tl.complete_vae_loss(tp["encoder"], tp["decoder"], tp.get("predictor"), tcfg,
                               torch.from_numpy(x), torch.from_numpy(cond), eps, tf, **hyp)
    assert set(got) == set(want) == set(KEYS)
    for k in KEYS:
        _close(got[k], want[k])


def test_stage_losses_match_jax():
    jcfg, tcfg, jp, tp, x, cond = _model(False)
    key = jax.random.PRNGKey(6)
    want = jl.encoder_loss(jp["encoder"], jcfg, jnp.asarray(x), jnp.asarray(cond), key,
                           beta=0.3, free_bits=1.0)
    eps = torch.from_numpy(np.array(jax.random.normal(key, (8, 8))))
    got = tl.encoder_loss(tp["encoder"], tcfg, torch.from_numpy(x), torch.from_numpy(cond),
                          eps, beta=0.3, free_bits=1.0)
    for a, b in zip(got, want):
        _close(a, b)
    z = np.array(want[3])
    want = jl.decoder_loss(jp["decoder"], jcfg, jnp.asarray(z), jnp.asarray(cond),
                           jnp.asarray(x), key, teacher_forcing_ratio=0.6)
    tf = torch.from_numpy(np.array(jax.random.uniform(key, (10,)) < 0.6))
    _close(tl.decoder_loss(tp["decoder"], tcfg, torch.from_numpy(z), torch.from_numpy(cond),
                           torch.from_numpy(x), tf), want)
