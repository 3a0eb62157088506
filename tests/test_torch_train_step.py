"""Port train step vs the JAX package: same params, batch and noise.

``train_step`` over 3 consecutive steps (scalars, ``grad_norm``, params
after Adam) with and without a predictor, ``grad_clip`` 0 and 1, Adam bias
correction on and off, on both routes (``use_pallas``: the fused kernels'
plain versions on CPU tensors; without it the scan path); JAX Adam states
carried into the port, directly and through ``.npz`` checkpoints in both
directions; ``multi_train_step``, ``eval_step``, ``monitor_step`` and the
gather-fed variants; and the ``reference_zero_state`` step against the
independent torch oracle (``tests/reference_oracle.py``) in f32.

Noise comes from the JAX key exactly as the JAX step draws it
(``k_rep, k_tf, k_drop = split(key, 3)``; ``eps = normal(k_rep)``;
``tf_mask = uniform(k_tf, (L,)) < ratio``) and is handed to the port.
Tolerances (float32): loss scalars 1e-5 relative, ``grad_norm`` 1e-4
relative, params after Adam 1e-5 absolute (the oracle trajectory test's
envelope); the frameworks sum in different orders.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_vae_tpu.config import ModelConfig as JaxConfig
from mlx_vae_tpu.config import TrainConfig as JaxTrainConfig
from mlx_vae_tpu.models import ARCVAE
from mlx_vae_tpu.train import checkpoint as jck
from mlx_vae_tpu.train import steps as jsteps
from mlx_vae_tpu.train.optim import adam_init as jadam_init
from mlx_vae_tpu_torch.config import ModelConfig, TrainConfig
from mlx_vae_tpu_torch.train import checkpoint as tck
from mlx_vae_tpu_torch.train import steps as tsteps
from mlx_vae_tpu_torch.train.optim import adam_init
from mlx_vae_tpu_torch.utils.tree import params_from_numpy, params_to_numpy

sys.path.insert(0, str(Path(__file__).resolve().parent))
from reference_oracle import oracle_train_step  # noqa: E402

SCALARS = ("total_loss", "recon_loss", "kl_loss", "weighted_kl", "collapse_penalty",
           "prop_loss", "weighted_prop_loss", "mutual_info", "mi_penalty")
B, L = 8, 10
MODEL = dict(vocab_size=24, embedding_dim=16, hidden_dim=32, latent_dim=8,
             num_conditions=1, num_layers=2)


def _setup(with_predictor=True, seed=7, **model):
    kw = {**MODEL, **model}
    jcfg = JaxConfig(**kw)
    vae = ARCVAE(jcfg, jax.random.PRNGKey(seed), with_predictor=with_predictor)
    npp = jax.tree_util.tree_map(np.array, vae.params)
    return jcfg, ModelConfig(**kw), npp


def _batch(step, vocab=24):
    rng = np.random.default_rng(100 + step)
    return (rng.integers(1, vocab, (B, L)).astype(np.int32),
            rng.standard_normal((B, 1)).astype(np.float32))


def _noise(key, tf_ratio, latent=8):
    k_rep, k_tf, _ = jax.random.split(key, 3)
    return {"eps": torch.from_numpy(np.array(jax.random.normal(k_rep, (B, latent)))),
            "tf_mask": torch.from_numpy(np.array(jax.random.uniform(k_tf, (L,)) < tf_ratio))}


def _jax_tree(npp):
    return jax.tree_util.tree_map(jnp.array, npp)


def _assert_metrics(tm, jm, what):
    for k in SCALARS:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=f"{what}: {k}")
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4,
                               err_msg=f"{what}: grad_norm")


def _assert_params(tp, jp, what, atol=1e-5):
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(params_to_numpy(tp)),
                                 jax.tree_util.tree_leaves_with_path(
                                     jax.tree_util.tree_map(np.asarray, jp))):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=f"{what}: {path}")


def test_config_schedules_match_jax():
    j, t = JaxTrainConfig(), TrainConfig()
    for epoch in (0, 7, 19, 20, 29):
        assert t.compute_beta(epoch) == j.compute_beta(epoch)
        assert t.compute_teacher_forcing_ratio(epoch, 30) == \
            j.compute_teacher_forcing_ratio(epoch, 30)


# (with_predictor, grad_clip, adam_bias_correction, use_pallas): each
# option both ways across the four cases
CASES = [(True, 1.0, False, True), (False, 0.0, False, False),
         (True, 0.0, True, False), (False, 1.0, True, True)]


@pytest.mark.parametrize("with_predictor,grad_clip,bias_correction,use_pallas", CASES)
def test_three_steps_match_jax(with_predictor, grad_clip, bias_correction, use_pallas):
    jcfg, tcfg, npp = _setup(with_predictor)
    tcfg = tcfg.replace(use_pallas=use_pallas)
    hyp = dict(grad_clip=grad_clip, adam_bias_correction=bias_correction, learning_rate=1e-3)
    jt, tt = JaxTrainConfig(**hyp), TrainConfig(**hyp)
    jp = _jax_tree(npp)
    jo = {n: jadam_init(p) for n, p in jp.items()}
    tp = params_from_numpy(npp)
    to = {n: adam_init(p) for n, p in tp.items()}
    for s in range(3):
        x, c = _batch(s)
        key = jax.random.PRNGKey(40 + s)
        jp, jo, jm = jsteps.train_step(jp, jo, jcfg, jt, jnp.asarray(x), jnp.asarray(c), key,
                                       jnp.float32(0.05), jnp.float32(0.8))
        tp, to, tm = tsteps.train_step(tp, to, tcfg, tt, torch.from_numpy(x),
                                       torch.from_numpy(c), None, 0.05, 0.8,
                                       noise=_noise(key, 0.8))
        _assert_metrics(tm, jm, f"step {s}")
    _assert_params(tp, jp, "params after 3 steps")
    for name in jo:
        assert int(to[name]["step"]) == int(jo[name]["step"]) == 3
        _assert_params(to[name]["m"], jo[name]["m"], f"{name} Adam m", atol=1e-6)
        _assert_params(to[name]["v"], jo[name]["v"], f"{name} Adam v", atol=1e-7)


def _jax_steps(jcfg, jt, jp, jo, steps):
    for s in steps:
        x, c = _batch(s)
        jp, jo, jm = jsteps.train_step(jp, jo, jcfg, jt, jnp.asarray(x), jnp.asarray(c),
                                       jax.random.PRNGKey(60 + s), jnp.float32(0.05),
                                       jnp.float32(0.9))
    return jp, jo, jm


def _port_step(tcfg, tt, tp, to, s):
    x, c = _batch(s)
    return tsteps.train_step(tp, to, tcfg, tt, torch.from_numpy(x), torch.from_numpy(c), None,
                             0.05, 0.9, noise=_noise(jax.random.PRNGKey(60 + s), 0.9))


def test_jax_adam_state_resumes_identically_in_the_port(tmp_path):
    """Two JAX steps, then the state (params + {step, m, v}) moves to the
    port, directly and through a JAX-written checkpoint; step 3 on each
    side agrees. Then a port-written checkpoint resumes in JAX."""
    jcfg, tcfg, npp = _setup(True)
    jt, tt = JaxTrainConfig(learning_rate=1e-3), TrainConfig(learning_rate=1e-3)
    jp = _jax_tree(npp)
    jp, jo, _ = _jax_steps(jcfg, jt, jp, {n: jadam_init(p) for n, p in jp.items()}, [0, 1])
    path = tmp_path / "checkpoint_epoch_002.npz"
    jck.save_checkpoint(path, 2, jp, jo, {"train_loss": [1.0]})
    direct = (params_from_numpy(jax.tree_util.tree_map(np.array, jp)),
              params_from_numpy(jax.tree_util.tree_map(np.array, jo)))
    loaded = tck.train_state_from_checkpoint(tck.load_checkpoint(path))
    jp3, jo3, jm = _jax_steps(jcfg, jt, jp, jo, [2])
    for what, (tp, to) in (("direct", direct), ("checkpoint", loaded)):
        assert to["encoder"]["step"].dtype == torch.int32 and int(to["encoder"]["step"]) == 2
        tp, to, tm = _port_step(tcfg, tt, tp, to, 2)
        _assert_metrics(tm, jm, what)
        _assert_params(tp, jp3, what)
    # the port's state after step 3, written by the port, resumes step 4 in JAX
    back = tmp_path / "port.npz"
    tck.write_checkpoint(back, tck.build_checkpoint_host(3, tp, to, {"train_loss": [1.0]}))
    ck = jck.load_checkpoint(back)
    jp4, _, jm = _jax_steps(jcfg, jt, _jax_tree(ck["params"]), _jax_tree(ck["opt_states"]), [3])
    tp4, _, tm = _port_step(tcfg, tt, tp, to, 3)
    _assert_metrics(tm, jm, "port checkpoint in JAX")
    _assert_params(tp4, jp4, "port checkpoint in JAX")


def test_multi_train_step_matches_jax():
    jcfg, tcfg, npp = _setup(False)
    jt, tt = JaxTrainConfig(), TrainConfig()
    xs, cs = zip(*(_batch(s) for s in range(2)))
    xs, cs = np.stack(xs), np.stack(cs)
    key = jax.random.PRNGKey(9)
    jp = _jax_tree(npp)
    jp, _, jm = jsteps.multi_train_step(jp, {n: jadam_init(p) for n, p in jp.items()}, jcfg,
                                        jt, jnp.asarray(xs), jnp.asarray(cs), key,
                                        jnp.float32(0.05), jnp.float32(0.9))
    noise, k = [], key
    for _ in range(2):  # the JAX scan body's key schedule
        k, sub = jax.random.split(k)
        noise.append(_noise(sub, 0.9))
    tp = params_from_numpy(npp)
    tp, _, tm = tsteps.multi_train_step(tp, {n: adam_init(p) for n, p in tp.items()}, tcfg, tt,
                                        torch.from_numpy(xs), torch.from_numpy(cs), None, 0.05,
                                        0.9, noise=noise)
    assert tm["total_loss"].shape == (2,)
    for k_ in SCALARS + ("grad_norm", "mu_abs_max", "logvar_min", "logvar_max"):
        np.testing.assert_allclose(tm[k_].numpy(), np.asarray(jm[k_]), rtol=1e-4, atol=1e-6,
                                   err_msg=k_)
    _assert_params(tp, jp, "after multi_train_step")


@pytest.mark.parametrize("use_pallas", [False, True])
def test_eval_and_monitor_steps_match_jax(use_pallas):
    jcfg, tcfg, npp = _setup(True)
    tcfg = tcfg.replace(use_pallas=use_pallas)
    jt, tt = JaxTrainConfig(), TrainConfig()
    x, c = _batch(5)
    key = jax.random.PRNGKey(12)
    jm = jsteps.eval_step(_jax_tree(npp), jcfg, jt, jnp.asarray(x), jnp.asarray(c), key,
                          jnp.float32(0.05), jnp.float32(0.0))
    tm = tsteps.eval_step(params_from_numpy(npp), tcfg, tt, torch.from_numpy(x),
                          torch.from_numpy(c), None, 0.05, 0.0, noise=_noise(key, 0.0))
    for k in SCALARS + ("mu_abs_max", "logvar_min", "logvar_max"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    js = jsteps.monitor_step(_jax_tree(npp)["encoder"], jcfg, jnp.asarray(x), jnp.asarray(c))
    ts = tsteps.monitor_step(params_from_numpy(npp)["encoder"], tcfg, torch.from_numpy(x),
                             torch.from_numpy(c))
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_allclose(float(ts[k]), float(js[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def test_gather_variants_equal_the_plain_steps():
    """The device-resident-corpus variants are the plain steps on
    ``tokens_all[idx]`` (uint8 corpus widened to int32)."""
    _, tcfg, npp = _setup(False)
    tt = TrainConfig()
    rng = np.random.default_rng(3)
    tokens_all = torch.from_numpy(rng.integers(1, 24, (40, L)).astype(np.uint8))
    props_all = torch.from_numpy(rng.standard_normal((40, 1)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 40, (2, B)))
    noise = [_noise(jax.random.PRNGKey(20 + k), 0.9) for k in range(2)]
    a, b = params_from_numpy(npp), params_from_numpy(npp)
    _, _, ma = tsteps.multi_train_step_gather(a, {n: adam_init(p) for n, p in a.items()}, tcfg,
                                              tt, tokens_all, props_all, idx, None, 0.05, 0.9,
                                              noise=noise)
    ob = {n: adam_init(p) for n, p in b.items()}
    for k in range(2):
        _, _, mb = tsteps.train_step_gather(b, ob, tcfg, tt, tokens_all, props_all, idx[k], None,
                                            0.05, 0.9, noise=noise[k])
    assert float(ma["total_loss"][1]) == float(mb["total_loss"])
    for (_, x), (_, y) in zip(jax.tree_util.tree_leaves_with_path(params_to_numpy(a)),
                              jax.tree_util.tree_leaves_with_path(params_to_numpy(b))):
        np.testing.assert_array_equal(x, y)
    em = tsteps.eval_step_gather(b, tcfg, tt, tokens_all, props_all, idx[0], None, 0.05, 0.0,
                                 noise=noise[0])
    ev = tsteps.eval_step(b, tcfg, tt, tokens_all[idx[0]].int(), props_all[idx[0]], None, 0.05,
                          0.0, noise=noise[0])
    assert float(em["total_loss"]) == float(ev["total_loss"])


def test_drawn_noise_has_the_jax_shapes():
    tcfg = ModelConfig(**MODEL, apply_dropout=True)
    g = torch.Generator().manual_seed(0)
    n = tsteps.draw_noise(g, tcfg, 512, 40, 0.9)
    assert n["eps"].shape == (512, 8) and n["tf_mask"].dtype == torch.bool
    assert n["tf_mask"].shape == (40,) and len(n["keep_masks"]) == 1
    assert abs(n["eps"].std().item() - 1.0) < 0.05
    m = tsteps.draw_noise(torch.Generator().manual_seed(0), tcfg, 512, 40, 0.9)
    assert torch.equal(m["eps"], n["eps"]) and torch.equal(m["tf_mask"], n["tf_mask"])


@pytest.mark.parametrize("tf_ratio", [1.0, 0.0])
def test_reference_zero_state_step_matches_oracle(tf_ratio):
    """``reference_zero_state=True`` (every step from zero LSTM state, the
    reference's quirk) against the from-scratch torch oracle, f32."""
    jcfg, tcfg, npp = _setup(True, reference_zero_state=True)
    tt = TrainConfig(learning_rate=2e-4, lambda_prop=0.1, lambda_collapse=0.001, free_bits=1.0,
                     lambda_mi=0.01, grad_clip=1.0)
    x, c = _batch(7)
    tf = np.full((L,), tf_ratio >= 0.5)
    eps = np.random.default_rng(8).standard_normal((B, 8)).astype(np.float32)
    o_loss, _, o_new = oracle_train_step(npp, x, c, eps, tf, 2, beta=0.05)
    tp = params_from_numpy(npp)
    tp, _, tm = tsteps.train_step(tp, {n: adam_init(p) for n, p in tp.items()}, tcfg, tt,
                                  torch.from_numpy(x), torch.from_numpy(c), None, 0.05, tf_ratio,
                                  noise={"eps": torch.from_numpy(eps),
                                         "tf_mask": torch.from_numpy(tf)})
    for k in SCALARS:
        np.testing.assert_allclose(float(tm[k]), o_loss[k], rtol=3e-5, atol=1e-6, err_msg=k)
    _assert_params(tp, o_new, "post-Adam vs oracle", atol=6e-5)


def test_trajectory_matches_oracle():
    """30 consecutive ``reference_zero_state`` steps against the oracle
    trajectory (``tests/test_oracle_parity.py``'s TF=0.6 case): Adam
    moments carry across steps and couple with an active clip. Envelope as
    there: losses 1e-5 + 2e-6 per step relative, final params 1e-5."""
    from reference_oracle import oracle_train_trajectory

    S, clip, lr = 30, 0.05, 1e-3
    jcfg, tcfg, npp = _setup(True, reference_zero_state=True)
    tt = TrainConfig(learning_rate=lr, grad_clip=clip)
    rng = np.random.default_rng(11)
    data_x = rng.integers(1, 24, (3, 16, 12)).astype(np.int32)
    data_c = rng.normal(size=(3, 16, 1)).astype(np.float32)
    epses, masks = [], []
    for s in range(S):
        k_rep, k_tf, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(3), s), 3)
        epses.append(np.array(jax.random.normal(k_rep, (16, 8), jnp.float32)))
        masks.append(np.array(jax.random.uniform(k_tf, (12,)) < 0.6))
    betas = [0.05 * s / S for s in range(S)]
    o_losses, o_final, o_norms = oracle_train_trajectory(
        npp, [data_x[s % 3] for s in range(S)], [data_c[s % 3] for s in range(S)], epses,
        masks, 2, beta=betas, lambda_prop=0.1, lambda_collapse=0.001, free_bits=1.0,
        lambda_mi=0.01, target_mi=4.85, lr=lr, grad_clip=clip)
    assert sum(n > clip for n in o_norms) >= S // 2
    tp = params_from_numpy(npp)
    to = {n: adam_init(p) for n, p in tp.items()}
    for s in range(S):
        tp, to, m = tsteps.train_step(
            tp, to, tcfg, tt, torch.from_numpy(data_x[s % 3]), torch.from_numpy(data_c[s % 3]),
            None, betas[s], 0.6, noise={"eps": torch.from_numpy(epses[s]),
                                        "tf_mask": torch.from_numpy(masks[s])})
        want = o_losses[s]["total_loss"]
        assert abs(float(m["total_loss"]) - want) / abs(want) < 1e-5 + 2e-6 * s, s
        assert abs(float(m["grad_norm"]) - o_norms[s]) / max(o_norms[s], 1e-9) < 1e-4 + 2e-5 * s
    _assert_params(tp, o_final, "final params vs oracle trajectory")
