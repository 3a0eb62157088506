"""The port's per-layer routes through ``train_step`` vs the JAX package:
same params, batch and noise.

* The scaled configuration's routes (hidden 1024 / 4 layers on the card):
  with ``L2_BYTES`` patched down, a 4-layer H=128 model's stack no longer
  fits L2, so the encoder runs layer by layer through
  ``lstm_sequence_fused`` and the decoder through ``decoder_train_cvp``
  (``custom_vjp`` stands in for H >= 768). Unpatched, the same model takes
  the whole-stack routes. Calls to each kernel wrapper are counted.
* ``bidirectional`` with ``apply_dropout`` (keep-masks drawn from the JAX
  key as the JAX encoder draws them) on the per-layer route.
* ``reference_zero_state`` with ``use_pallas``: the decoder's scan runs the
  gate kernel pair once per layer and step, forward and backward.

On CPU tensors every wrapper runs its plain version. Tolerances (float32,
``tests/test_torch_train_step.py``'s): loss scalars 1e-5 relative,
``grad_norm`` 1e-4 relative, params after Adam 1e-5 absolute.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_vae_tpu.config import ModelConfig as JaxConfig
from mlx_vae_tpu.config import TrainConfig as JaxTrainConfig
from mlx_vae_tpu.models import ARCVAE
from mlx_vae_tpu.train import steps as jsteps
from mlx_vae_tpu.train.optim import adam_init as jadam_init
from mlx_vae_tpu_torch.config import ModelConfig, TrainConfig
from mlx_vae_tpu_torch.ops import decoder_cv as dcv
from mlx_vae_tpu_torch.ops import fused_encoder as fe
from mlx_vae_tpu_torch.ops import fused_lstm as fl
from mlx_vae_tpu_torch.ops import fused_seq_lstm as fs
from mlx_vae_tpu_torch.ops import fused_train_decoder as fd
from mlx_vae_tpu_torch.ops import train_common as tc
from mlx_vae_tpu_torch.train import steps as tsteps
from mlx_vae_tpu_torch.train.optim import adam_init
from mlx_vae_tpu_torch.utils.tree import params_from_numpy, params_to_numpy

SCALARS = ("total_loss", "recon_loss", "kl_loss", "weighted_kl", "collapse_penalty",
           "prop_loss", "weighted_prop_loss", "mutual_info", "mi_penalty")
B, L = 8, 10


def _spy(monkeypatch) -> collections.Counter:
    """Count calls of every kernel wrapper the train routes can reach."""
    counts = collections.Counter()
    for mod, name in ((fs, "seq_lstm_fwd"), (fs, "seq_lstm_bwd_tm"), (dcv, "seq_lstm_bwd_tm"),
                      (fe, "encoder_fwd"), (fe, "encoder_bwd"), (fl, "gates_fwd"),
                      (fl, "gates_bwd"), (fd, "decoder_bwd")):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _key=name, **k):
            counts[_key] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    for mod in (fd, dcv):
        fn = mod.decoder_fwd

        def wrapped(w, h, c, t, tf, with_ce, _fn=fn):
            counts["decoder_fwd_ce" if with_ce else "decoder_fwd_logits"] += 1
            return _fn(w, h, c, t, tf, with_ce)
        monkeypatch.setattr(mod, "decoder_fwd", wrapped)
    return counts


def _one_step(seed=7, steps=1, **model):
    kw = {**dict(vocab_size=24, embedding_dim=16, hidden_dim=32, latent_dim=8,
                 num_conditions=1, num_layers=2, use_pallas=True), **model}
    jcfg, tcfg = JaxConfig(**kw), ModelConfig(**kw)
    vae = ARCVAE(jcfg, jax.random.PRNGKey(seed), with_predictor=True)
    npp = jax.tree_util.tree_map(np.array, vae.params)
    jt = JaxTrainConfig(learning_rate=1e-3)
    tt = TrainConfig(learning_rate=1e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, npp)
    jo = {n: jadam_init(p) for n, p in jp.items()}
    tp = params_from_numpy(npp)
    to = {n: adam_init(p) for n, p in tp.items()}
    for s in range(steps):
        rng = np.random.default_rng(100 + s)
        x = rng.integers(1, 24, (B, L)).astype(np.int32)
        c = rng.standard_normal((B, 1)).astype(np.float32)
        key = jax.random.PRNGKey(40 + s)
        jp, jo, jm = jsteps.train_step(jp, jo, jcfg, jt, jnp.asarray(x), jnp.asarray(c), key,
                                       jnp.float32(0.05), jnp.float32(0.8))
        k_rep, k_tf, k_drop = jax.random.split(key, 3)
        noise = {"eps": torch.from_numpy(np.array(jax.random.normal(k_rep, (B, 8)))),
                 "tf_mask": torch.from_numpy(np.array(jax.random.uniform(k_tf, (L,)) < 0.8))}
        if tcfg.apply_dropout:
            out_dim = tcfg.hidden_dim * (2 if tcfg.bidirectional else 1)
            masks, k = [], k_drop
            for _ in range(tcfg.num_layers - 1):
                k, dk = jax.random.split(k)
                masks.append(torch.from_numpy(np.array(jax.random.bernoulli(
                    dk, 1.0 - tcfg.dropout, (B, L, out_dim)))))
            noise["keep_masks"] = masks
        tp, to, tm = tsteps.train_step(tp, to, tcfg, tt, torch.from_numpy(x),
                                       torch.from_numpy(c), None, 0.05, 0.8, noise=noise)
        for k_ in SCALARS:
            np.testing.assert_allclose(float(tm[k_]), float(jm[k_]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {s}: {k_}")
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(params_to_numpy(tp)),
            jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, jp))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=str(path))


@pytest.mark.parametrize("l2_fits", [False, True])
def test_scaled_routes_step_matches_jax(l2_fits, monkeypatch):
    if not l2_fits:
        monkeypatch.setattr(tc, "L2_BYTES", 1024)
    cfg = ModelConfig(vocab_size=24, embedding_dim=16, hidden_dim=128, num_layers=4)
    assert tc.stack_fits_l2(cfg) == l2_fits
    counts = _spy(monkeypatch)
    _one_step(hidden_dim=128, num_layers=4, custom_vjp=True)
    if l2_fits:
        want = {"encoder_fwd": 1, "encoder_bwd": 1, "decoder_fwd_ce": 1, "decoder_bwd": 1}
    else:  # per-layer encoder, decoder_train_cvp
        want = {"seq_lstm_fwd": 4, "seq_lstm_bwd_tm": 8, "decoder_fwd_logits": 1}
    assert dict(counts) == want


def test_bidirectional_dropout_step_matches_jax(monkeypatch):
    counts = _spy(monkeypatch)
    _one_step(num_layers=3, bidirectional=True, apply_dropout=True)
    assert counts["seq_lstm_fwd"] == 6 and counts["seq_lstm_bwd_tm"] == 6
    assert counts["encoder_fwd"] == 0 and counts["decoder_fwd_ce"] == 1


def test_reference_zero_state_with_use_pallas_matches_jax(monkeypatch):
    counts = _spy(monkeypatch)
    _one_step(steps=2, reference_zero_state=True)
    n = 2
    assert counts["gates_fwd"] == counts["gates_bwd"] == 2 * L * n
    assert counts["encoder_fwd"] == 2 and counts["decoder_fwd_ce"] == 0
