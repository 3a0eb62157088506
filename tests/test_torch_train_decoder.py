"""Port training decoder vs the JAX package on the same numpy params, inputs
and teacher-forcing flips.

``decoder_apply`` (teacher-forced scan, argmax feedback, free-running and
``reference_zero_state``) against the JAX scan with the same ``tf_mask``,
and both fused specializations' plain path against
``decoder_train_ce_pallas`` / ``decoder_train_pallas`` in interpret mode:
forward values and the gradients of every param leaf, ``h_init`` and the
conditions, n = 1, 2, 3, at the JAX kernel tests' shapes.

Tolerances: float32 forward values 1e-5; float32 gradients 1e-4 (the JAX
package's kernel-vs-autodiff tolerance). bfloat16 fused vs fused: both
store activated gates in bf16 and round the same operands, within 2e-2 of
each leaf's largest magnitude. bfloat16 fused vs the JAX scan's autodiff:
the scan differentiates exact pre-activation gates while the fused contract
flushes a saturated gate's a(1-a) to 0, so this is
``TestBf16GradParity``'s calibrated comparison (scaled error < 4e-2 and
cosine > 0.99 per leaf), with and without gates pushed into saturation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_vae_tpu.config import ModelConfig as JaxConfig
from mlx_vae_tpu.models import decoder as jdec
from mlx_vae_tpu.ops.pallas_train_decoder import decoder_train_ce_pallas, decoder_train_pallas
from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.models import decoder as tdec
from mlx_vae_tpu_torch.ops import fused_train_decoder as fd
from mlx_vae_tpu_torch.utils.tree import params_from_numpy

TF = np.array([1, 0, 1, 1, 0, 1, 0, 1, 1], bool)  # test_pallas.py's flips


def _cfgs(n=2, dtype="float32", H=128, **kw):
    kw = dict(vocab_size=24, embedding_dim=16, hidden_dim=H, latent_dim=8,
              num_conditions=1, num_layers=n, compute_dtype=dtype, **kw)
    return JaxConfig(**kw), ModelConfig(**kw)


def _setup(jcfg, B=8, L=9, bias_boost=0.0):
    jp = jdec.init_decoder_params(jax.random.PRNGKey(0), jcfg)
    npp = jax.tree_util.tree_map(np.array, jp)
    if bias_boost:  # input/forget gates toward saturation (sigmoid(10) is 1.0 in bf16)
        for i in range(jcfg.num_layers):
            npp[f"lstm_layer_{i}"]["bias"][: 2 * jcfg.hidden_dim] += bias_boost
    rng = np.random.default_rng(1)
    z = rng.standard_normal((B, jcfg.latent_dim)).astype(np.float32)
    cond = rng.standard_normal((B, jcfg.num_conditions)).astype(np.float32)
    tok = rng.integers(0, jcfg.vocab_size, (B, L)).astype(np.int32)
    return npp, z, cond, tok


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=what)


def _scaled(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-3)
    denom = float(np.linalg.norm(got) * np.linalg.norm(want))
    cos = float(np.sum(got * want)) / denom if denom > 1e-8 else 1.0
    return err, cos


def _jax_tree(npp):
    return jax.tree_util.tree_map(jnp.asarray, npp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_decoder_apply_matches_jax_scan(n, dtype):
    """Teacher-forced decode with the flips the JAX key draws."""
    jcfg, tcfg = _cfgs(n, dtype, H=32)
    npp, z, cond, tok = _setup(jcfg)
    key = jax.random.PRNGKey(3)
    tf = np.array(jax.random.uniform(key, (tok.shape[1],)) < 0.6)
    want = jdec.decoder_apply(_jax_tree(npp), jcfg, jnp.asarray(z), jnp.asarray(cond),
                              target_seq=jnp.asarray(tok), teacher_forcing_ratio=0.6, key=key)
    got = tdec.decoder_apply(params_from_numpy(npp), tcfg, torch.from_numpy(z),
                             torch.from_numpy(cond), target_seq=torch.from_numpy(tok),
                             tf_mask=torch.from_numpy(tf))
    _close(got, want, 1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("zero_state", [False, True])
def test_decoder_apply_free_running_and_zero_state_match_jax(zero_state):
    jcfg, tcfg = _cfgs(2, H=32, reference_zero_state=zero_state)
    npp, z, cond, tok = _setup(jcfg)
    want = jdec.decoder_apply(_jax_tree(npp), jcfg, jnp.asarray(z), jnp.asarray(cond),
                              max_length=7)
    got = tdec.decoder_apply(params_from_numpy(npp), tcfg, torch.from_numpy(z),
                             torch.from_numpy(cond), max_length=7)
    _close(got, want, 1e-5)
    key = jax.random.PRNGKey(5)
    tf = np.array(jax.random.uniform(key, (tok.shape[1],)) < 0.5)
    want = jdec.decoder_apply(_jax_tree(npp), jcfg, jnp.asarray(z), jnp.asarray(cond),
                              target_seq=jnp.asarray(tok), teacher_forcing_ratio=0.5, key=key)
    got = tdec.decoder_apply(params_from_numpy(npp), tcfg.replace(use_pallas=True),
                             torch.from_numpy(z), torch.from_numpy(cond),
                             target_seq=torch.from_numpy(tok), tf_mask=torch.from_numpy(tf))
    _close(got, want, 1e-5)


def test_decoder_apply_custom_vjp_width_is_not_ported_yet():
    """``custom_vjp`` (and H >= 768) once raised here; the teacher-forced
    decode now runs ``decoder_train_cv``, as the JAX decoder does (off the
    TPU), and its logits and gradients equal the JAX package's."""
    jcfg, tcfg = _cfgs(2, H=32, custom_vjp=True)
    npp, z, cond, tok = _setup(jcfg)
    key = jax.random.PRNGKey(3)
    tf = np.array(jax.random.uniform(key, (tok.shape[1],)) < 0.6)
    w = np.random.default_rng(2).standard_normal((9, 24)).astype(np.float32)

    def jloss(p, zz, cc):
        logits = jdec.decoder_apply(p, jcfg, zz, cc, target_seq=jnp.asarray(tok),
                                    teacher_forcing_ratio=0.6, key=key)
        return jnp.sum(logits * w[None])

    jv, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(_jax_tree(npp), jnp.asarray(z),
                                                           jnp.asarray(cond))
    tp = params_from_numpy(npp)
    for v in tp.values():
        for t in v.values():
            t.requires_grad_(True)
    tz, tc = torch.from_numpy(z).requires_grad_(True), torch.from_numpy(cond).requires_grad_(True)
    logits = tdec.decoder_apply(tp, tcfg, tz, tc, target_seq=torch.from_numpy(tok),
                                tf_mask=torch.from_numpy(tf))
    tv = (logits * torch.from_numpy(w)[None]).sum()
    tv.backward()
    _close(tv.detach(), jv, 1e-5)
    _close(tz.grad, jg[1], 1e-4, "z")
    _close(tc.grad, jg[2], 1e-4, "conditions")
    for name, v in tp.items():
        for k, leaf in v.items():
            _close(leaf.grad, jg[0][name][k], 1e-4, f"{name}.{k}")


def _pallas(jcfg, npp, z, cond, tok, with_ce, weight):
    """JAX value and grads (params, h_init, cond) of sum(out * weight)."""
    fn = decoder_train_ce_pallas if with_ce else decoder_train_pallas

    def loss(p, h, c):
        return jnp.sum(fn(p, jcfg, h, c, jnp.asarray(tok), True, jnp.asarray(TF)) * weight)

    h0 = jdec.hidden_init_row(_jax_tree(npp), jcfg, jnp.asarray(z), jnp.asarray(cond))
    v, g = jax.value_and_grad(loss, argnums=(0, 1, 2))(_jax_tree(npp), h0, jnp.asarray(cond))
    return np.asarray(h0), v, g


def _port(tcfg, npp, h0, cond, tok, with_ce, weight):
    tp = params_from_numpy(npp)
    for v in tp.values():
        for t in v.values():
            t.requires_grad_(True)
    h = torch.from_numpy(np.array(h0)).requires_grad_(True)
    c = torch.from_numpy(cond).requires_grad_(True)
    fn = fd.decoder_train_ce if with_ce else fd.decoder_train
    out = fn(tp, tcfg, h, c, torch.from_numpy(tok), torch.from_numpy(TF))
    val = (out * torch.from_numpy(weight)).sum()
    val.backward()
    return out.detach(), val.detach(), tp, h.grad, c.grad


def _kernel_leaves(n):
    return ["embedding", "fc_out"] + [f"lstm_layer_{i}" for i in range(n)]


@pytest.mark.parametrize("with_ce", [True, False])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_fused_plain_path_matches_pallas_interpret(n, with_ce):
    jcfg, tcfg = _cfgs(n)
    npp, z, cond, tok = _setup(jcfg)
    rng = np.random.default_rng(9)
    weight = rng.standard_normal((8,) if with_ce else (8, 9, 24)).astype(np.float32)
    h0, jv, (jgp, jgh, jgc) = _pallas(jcfg, npp, z, cond, tok, with_ce, weight)
    out, tv, tp, th, tc = _port(tcfg, npp, h0, cond, tok, with_ce, weight)
    fn = decoder_train_ce_pallas if with_ce else decoder_train_pallas
    _close(out, fn(_jax_tree(npp), jcfg, jnp.asarray(h0), jnp.asarray(cond),
                   jnp.asarray(tok), True, jnp.asarray(TF)), 1e-5)
    _close(tv, jv, 1e-5)
    _close(th, jgh, 1e-4, "h_init")
    _close(tc, jgc, 1e-4, "conditions")
    for name in _kernel_leaves(n):
        for k, leaf in tp[name].items():
            _close(leaf.grad, jgp[name][k], 1e-4, f"{name}.{k}")


@pytest.mark.parametrize("with_ce", [True, False])
def test_fused_plain_path_matches_pallas_interpret_bf16(with_ce):
    jcfg, tcfg = _cfgs(2, "bfloat16")
    npp, z, cond, tok = _setup(jcfg)
    weight = np.random.default_rng(9).standard_normal(
        (8,) if with_ce else (8, 9, 24)).astype(np.float32)
    h0, jv, (jgp, jgh, jgc) = _pallas(jcfg, npp, z, cond, tok, with_ce, weight)
    _, tv, tp, th, tc = _port(tcfg, npp, h0, cond, tok, with_ce, weight)
    pairs = [(tv, jv, "value"), (th, jgh, "h_init"), (tc, jgc, "conditions")]
    pairs += [(leaf.grad, jgp[name][k], f"{name}.{k}")
              for name in _kernel_leaves(2) for k, leaf in tp[name].items()]
    for got, want, what in pairs:
        err, _ = _scaled(got, want)
        assert err < 2e-2, f"{what}: scaled err {err:.3e}"


@pytest.mark.parametrize("bias_boost", [0.0, 10.0])
def test_bf16_fused_gradients_match_scan_autodiff(bias_boost):
    """TestBf16GradParity for the port: the fused route's bf16 gradients
    (activated-gate residuals) against the JAX scan decoder's autodiff, from
    z and the conditions through ``h_init``."""
    jcfg, tcfg = _cfgs(2, "bfloat16")
    npp, z, cond, tok = _setup(jcfg, bias_boost=bias_boost)
    w = np.random.default_rng(9).standard_normal((9, 24)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    tf = np.array(jax.random.uniform(key, (9,)) < 0.6)

    def loss_scan(p, zz, cc):
        logits = jdec.decoder_apply(p, jcfg, zz, cc, target_seq=jnp.asarray(tok),
                                    teacher_forcing_ratio=0.6, key=key)
        return jnp.sum(logits * w[None])

    jg = jax.grad(loss_scan, argnums=(0, 1, 2))(_jax_tree(npp), jnp.asarray(z),
                                                jnp.asarray(cond))
    tp = params_from_numpy(npp)
    for v in tp.values():
        for t in v.values():
            t.requires_grad_(True)
    tz = torch.from_numpy(z).requires_grad_(True)
    tcnd = torch.from_numpy(cond).requires_grad_(True)
    logits = tdec.decoder_apply(tp, tcfg.replace(use_pallas=True), tz, tcnd,
                                target_seq=torch.from_numpy(tok), tf_mask=torch.from_numpy(tf))
    (logits * torch.from_numpy(w)[None]).sum().backward()
    pairs = [(tz.grad, jg[1], "z"), (tcnd.grad, jg[2], "conditions")]
    pairs += [(t.grad, jg[0][name][k], f"{name}.{k}")
              for name, v in tp.items() for k, t in v.items()]
    for got, want, what in pairs:
        err, cos = _scaled(got, want)
        assert err < 4e-2, f"{what} (bias_boost={bias_boost}): scaled err {err:.3e}"
        assert cos > 0.99, f"{what} (bias_boost={bias_boost}): cos {cos:.4f}"


@pytest.mark.parametrize("use_pallas", [False, True])
def test_vae_forward_matches_jax(use_pallas):
    """encode -> reparameterize -> teacher-forced decode; with ``use_pallas``
    the port runs the fused encoder and the logits specialization."""
    from mlx_vae_tpu.models import ARCVAE
    from mlx_vae_tpu.models.vae import vae_forward as jax_vae_forward
    from mlx_vae_tpu_torch.models.vae import vae_forward

    jcfg, tcfg = _cfgs(2, H=32)
    vae = ARCVAE(jcfg, jax.random.PRNGKey(2))
    npp = jax.tree_util.tree_map(np.array, vae.params)
    rng = np.random.default_rng(4)
    x = rng.integers(1, 24, (8, 9)).astype(np.int32)
    cond = rng.standard_normal((8, 1)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    want = jax_vae_forward(vae.params, jcfg, jnp.asarray(x), jnp.asarray(cond), key, 0.7)
    k_rep, k_tf = jax.random.split(key)
    eps = torch.from_numpy(np.array(jax.random.normal(k_rep, (8, jcfg.latent_dim))))
    tf = torch.from_numpy(np.array(jax.random.uniform(k_tf, (9,)) < 0.7))
    got = vae_forward(params_from_numpy(npp), tcfg.replace(use_pallas=use_pallas),
                      torch.from_numpy(x), torch.from_numpy(cond), eps, tf)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
