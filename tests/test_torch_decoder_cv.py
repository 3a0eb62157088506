"""Port custom-VJP training decoders vs the JAX package on the same numpy
params, inputs and teacher-forcing flips.

* ``decoder_train_cv`` against the JAX ``decoder_train_cv``.
* ``decoder_train_cvp`` (on CPU tensors: the plain twins of the fused
  forward's logits specialization and of the per-layer sequence backward)
  against the JAX ``decoder_train_cvp`` with ``use_pallas=True,
  interpret=True`` (the gate-blocked fused forward and the per-layer Pallas
  backward, as ``TestDecoderPallasBackward`` runs them).

Logits and the gradients of every param leaf, ``h_init`` and the conditions,
n = 1, 2, 3, V = 24, E = 128 (E + C = 129: the JAX side pads layer 0's
input to 256 lanes, the port does not), H = 128, B = 8, L = 9. Tolerances:
float32 logits 1e-5, gradients 1e-4. bfloat16: both sides store activated
gates and c in bf16 and round the same operands, so each leaf agrees within
2e-2 of its largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_vae_tpu.config import ModelConfig as JaxConfig
from mlx_vae_tpu.models import decoder as jdec
from mlx_vae_tpu.ops import decoder_cv as jcv
from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.ops import decoder_cv as tcv
from mlx_vae_tpu_torch.utils.tree import params_from_numpy

TF = np.array([1, 0, 1, 1, 0, 1, 0, 1, 1], bool)  # test_pallas.py's flips


def _cfgs(n, dtype="float32", **kw):
    kw = dict(vocab_size=24, embedding_dim=128, hidden_dim=128, latent_dim=8, num_conditions=1,
              num_layers=n, compute_dtype=dtype, **kw)
    return JaxConfig(**kw), ModelConfig(**kw)


def _setup(jcfg, B=8, L=9):
    npp = jax.tree_util.tree_map(np.array, jdec.init_decoder_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)
    h0 = (0.5 * rng.standard_normal((B, jcfg.hidden_dim))).astype(np.float32)
    cond = rng.standard_normal((B, jcfg.num_conditions)).astype(np.float32)
    tok = rng.integers(0, jcfg.vocab_size, (B, L)).astype(np.int32)
    w = rng.standard_normal((B, L, jcfg.vocab_size)).astype(np.float32)
    return npp, h0, cond, tok, w


def _close(got, want, dtype, tol, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)
    else:
        err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-3)
        assert err < 2e-2, f"{what}: scaled err {err:.3e}"


def _compare(jfn, tfn, n, dtype):
    jcfg, tcfg = _cfgs(n, dtype, use_pallas=True)
    npp, h0, cond, tok, w = _setup(jcfg)

    def jloss(p, h, c):
        return jnp.sum(jfn(p, jcfg, h, c) * w)

    jlog = jfn(jax.tree_util.tree_map(jnp.asarray, npp), jcfg, jnp.asarray(h0), jnp.asarray(cond))
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jax.tree_util.tree_map(jnp.asarray, npp),
                                            jnp.asarray(h0), jnp.asarray(cond))
    tp = params_from_numpy(npp)
    for v in tp.values():
        for t in v.values():
            t.requires_grad_(True)
    th = torch.from_numpy(h0).requires_grad_(True)
    tc = torch.from_numpy(cond).requires_grad_(True)
    logits = tfn(tp, tcfg, th, tc)
    (logits * torch.from_numpy(w)).sum().backward()
    _close(logits.detach(), jlog, dtype, 1e-5, "logits")
    _close(th.grad, jg[1], dtype, 1e-4, "h_init")
    _close(tc.grad, jg[2], dtype, 1e-4, "conditions")
    names = ["embedding", "fc_out"] + [f"lstm_layer_{i}" for i in range(n)]
    for name in names:
        for k, leaf in tp[name].items():
            _close(leaf.grad, jg[0][name][k], dtype, 1e-4, f"{name}.{k}")


def _tok():
    return torch.from_numpy(_setup(_cfgs(1)[0])[3])


@pytest.mark.parametrize("dtype,n", [("float32", 1), ("float32", 2), ("float32", 3),
                                     ("bfloat16", 2)])
def test_decoder_train_cv_matches_jax(n, dtype):
    tok = _tok()
    _compare(lambda p, c, h, cd: jcv.decoder_train_cv(p, c, h, cd, jnp.asarray(tok.numpy()),
                                                      jnp.asarray(TF)),
             lambda p, c, h, cd: tcv.decoder_train_cv(p, c, h, cd, tok, torch.from_numpy(TF)),
             n, dtype)


@pytest.mark.parametrize("dtype,n", [("float32", 1), ("float32", 2), ("float32", 3),
                                     ("bfloat16", 2)])
def test_decoder_train_cvp_matches_pallas_interpret(n, dtype):
    tok = _tok()
    _compare(lambda p, c, h, cd: jcv.decoder_train_cvp(p, c, h, cd, jnp.asarray(tok.numpy()),
                                                       jnp.asarray(TF), True),
             lambda p, c, h, cd: tcv.decoder_train_cvp(p, c, h, cd, tok, torch.from_numpy(TF)),
             n, dtype)


def test_cvp_and_cv_agree_in_f32():
    """The two port decoders are one function (f32, argmax feedback on)."""
    _, tcfg = _cfgs(2)
    npp, h0, cond, tok, _ = _setup(_cfgs(2)[0])
    tf = torch.zeros((9,), dtype=torch.bool)
    args = (params_from_numpy(npp), tcfg, torch.from_numpy(h0), torch.from_numpy(cond),
            torch.from_numpy(tok), tf)
    torch.testing.assert_close(tcv.decoder_train_cvp(*args), tcv.decoder_train_cv(*args),
                               rtol=1e-5, atol=1e-5)


def test_cvp_gate():
    """The fused forward and every per-layer backward take the scaled
    configuration; shapes the forward refuses are refused."""
    scaled = dict(hidden_dim=1024, num_layers=4, latent_dim=512)
    assert tcv.decoder_cvp_supported(ModelConfig(compute_dtype="bfloat16", **scaled))
    assert tcv.decoder_cvp_supported(ModelConfig(**scaled))
    assert not tcv.decoder_cvp_supported(ModelConfig(vocab_size=600))
    assert not tcv.decoder_cvp_supported(ModelConfig(num_layers=9))
