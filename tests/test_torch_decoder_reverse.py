"""The bf16 decoder backward's launch-order twins against the plain reverse
and the JAX package.

``decoder_reverse_steps_reference`` composes the plain twins of the bf16
backward's launches (the head pass over all steps, the first gate step, one
``dec_step_kernel`` twin per (step, layer), the sum of d(h_init)); it must
equal ``decoder_reverse_reference`` bit for bit, with and without the fused
CE, in float32 and bfloat16, n = 1, 2, 3, C = 1 and 3, a vocabulary of one
and of two 128-wide column tiles, and targets -1, V and 999 (no one-hot; a
zero embedding row where fed) mixed in. Its outputs, through the unchanged
weight-gradient sums (``decoder_grads``), match the VJP of
``decoder_train_ce_pallas`` / ``decoder_train_pallas`` in interpret mode:
within 1e-4 in float32 (the JAX package's kernel-vs-autodiff tolerance) and
2e-2 of each leaf's largest magnitude in bfloat16 (both sides store
activated gates in bf16 and round the same operands; one bf16 ulp is ~4e-3
relative, and a summation order can move a rounding).

The f32 kernels' twins (``split_tf32=True``: every product of the head pass
and the chain as ``split_tf32_matmul``, within ~2^-21 of each product) hold
the plain f32 reverse within 2e-6 of each output's largest magnitude, the
head pass alone within 1e-6, and through ``decoder_grads`` the same JAX VJP
within the f32 tolerance above.
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
from mlx_vae_tpu_torch.ops import fused_train_decoder as fd
from mlx_vae_tpu_torch.ops import train_common as tc
from mlx_vae_tpu_torch.utils.tree import params_from_numpy

B, L, E = 8, 9, 16
# (n, C, V, H): one, two and three layers; one and three conditions; a
# vocabulary of one column tile and one of two
SHAPES = [(1, 1, 24, 32), (2, 3, 200, 64), (3, 1, 24, 48)]


def _case(n, C, V, H, dtype, with_ce, seed=0):
    """JAX and port configs, numpy params, and the reverse's inputs: the
    plain forward's residuals under full teacher forcing and the cotangent
    (dce [B] or dlogits [B, L, V])."""
    kw = dict(vocab_size=V, embedding_dim=E, hidden_dim=H, latent_dim=8, num_conditions=C,
              num_layers=n, compute_dtype=dtype)
    jcfg, tcfg = JaxConfig(**kw), ModelConfig(**kw)
    npp = jax.tree_util.tree_map(np.array,
                                 jdec.init_decoder_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 1)
    h0 = (0.5 * rng.standard_normal((B, H))).astype(np.float32)
    cond = rng.standard_normal((B, C)).astype(np.float32)
    tok = rng.integers(0, V, (B, L)).astype(np.int32)
    tok[0, 0], tok[1, 3], tok[2, 5], tok[5, 8] = -1, V, 999, V
    din = rng.standard_normal((B,) if with_ce else (B, L, V)).astype(np.float32)
    w = tc.prepare_stack_weights(params_from_numpy(npp), tcfg, with_head=True)
    tf = torch.ones((L,), dtype=torch.bool)
    _, toks, hs, cs, gs = fd.decoder_fwd_reference(w, torch.from_numpy(h0),
                                                   torch.from_numpy(cond),
                                                   torch.from_numpy(tok), tf, with_ce)
    return jcfg, tcfg, npp, w, h0, cond, tok, din, toks, hs, cs, gs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_ce", [True, False])
@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_reverse_twins_compose_to_the_decoder_reference(shape, with_ce, dtype):
    """The launch-order twins equal decoder_reverse_reference bit for bit:
    dgates, dx0, dlog, d(h_init) and d(cond)."""
    *_, w, _, _, tok, din, _, hs, cs, gs = _case(*SHAPES[shape], dtype, with_ce, seed=shape)
    args = (w, torch.from_numpy(din), torch.from_numpy(tok), hs, cs, gs, with_ce)
    got = fd.decoder_reverse_steps_reference(*args)
    want = fd.decoder_reverse_reference(*args)
    for name, g, w_ in zip(("dgates", "dx0", "dlog", "dh_init", "dcond"), got, want):
        assert g.dtype == w_.dtype and torch.equal(g, w_), name


@pytest.mark.parametrize("with_ce", [True, False])
def test_head_twin_is_the_reference_head(with_ce):
    """decoder_head_bwd_reference's dlog is the reverse's; with CE each row
    sums to 0 where its target lies in [0, V) and to dce elsewhere (the
    softmax's sum, no one-hot), and dtop is bf16(dlog) fc_out^T."""
    n, C, V, H = SHAPES[1]
    *_, w, _, _, tok, din, _, hs, cs, gs = _case(n, C, V, H, "bfloat16", with_ce)
    dlog, dtop = fd.decoder_head_bwd_reference(w, torch.from_numpy(din),
                                               torch.from_numpy(tok), hs, with_ce)
    want = fd.decoder_reverse_reference(w, torch.from_numpy(din), torch.from_numpy(tok), hs, cs,
                                        gs, with_ce)[2]
    assert torch.equal(dlog, want)
    torch.testing.assert_close(dtop, dlog.to(torch.bfloat16).float() @ w.wout.float().T,
                               atol=1e-6, rtol=1e-6)
    if with_ce:
        t = torch.from_numpy(tok).T
        inside = (t >= 0) & (t < V)
        expect = torch.where(inside, 0.0, torch.from_numpy(din)[None].expand(L, B))
        torch.testing.assert_close(dlog.sum(-1), expect, atol=1e-5, rtol=0)
    else:
        assert torch.equal(dlog, torch.from_numpy(din).transpose(0, 1))


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-3)


# (shape, dtype, with_ce): each shape, dtype and specialization at least once
VJP_CASES = [(0, "float32", True), (1, "bfloat16", True), (1, "float32", False),
             (2, "bfloat16", False)]


@pytest.mark.parametrize("case", range(len(VJP_CASES)))
def test_twin_gradients_match_pallas_vjp(case):
    """The twins' reverse outputs through decoder_grads, and their d(h_init)
    and d(cond), against the VJP of decoder_train_ce_pallas /
    decoder_train_pallas (interpret mode) with the same cotangent."""
    shape, dtype, with_ce = VJP_CASES[case]
    n, C, V, H = SHAPES[shape]
    jcfg, tcfg, npp, w, h0, cond, tok, din, toks, hs, cs, gs = _case(n, C, V, H, dtype, with_ce,
                                                                     seed=shape)
    dgates, dx0, dlog, dh_init, dcond = fd.decoder_reverse_steps_reference(
        w, torch.from_numpy(din), torch.from_numpy(tok), hs, cs, gs, with_ce)
    dW, db, dwout, dbout, demb = fd.decoder_grads(w, toks, torch.from_numpy(h0),
                                                  torch.from_numpy(cond), hs, dgates, dx0, dlog)
    fn = decoder_train_ce_pallas if with_ce else decoder_train_pallas
    tf = jnp.ones((L,), bool)
    _, vjp = jax.vjp(lambda p, h, c: fn(p, jcfg, h, c, jnp.asarray(tok), True, tf),
                     jax.tree_util.tree_map(jnp.asarray, npp), jnp.asarray(h0),
                     jnp.asarray(cond))
    jgp, jgh, jgc = vjp(jnp.asarray(din))
    leaves = tc.layer_grads(dW, db, tcfg, E + C)
    pairs = [("h_init", dh_init, jgh), ("conditions", dcond, jgc),
             ("embedding.weight", demb, jgp["embedding"]["weight"]),
             ("fc_out.weight", dwout.T, jgp["fc_out"]["weight"]),
             ("fc_out.bias", dbout, jgp["fc_out"]["bias"])]
    pairs += [(f"lstm_layer_{l}.{k}", leaves[3 * l + i], jgp[f"lstm_layer_{l}"][k])
              for l in range(n) for i, k in enumerate(("Wx", "Wh", "bias"))]
    for name, mine, ref in pairs:
        if dtype == "float32":
            np.testing.assert_allclose(np.asarray(mine), np.asarray(ref, np.float32), atol=1e-4,
                                       rtol=1e-4, err_msg=name)
        else:
            err = _scaled_err(mine, ref)
            assert err < 2e-2, f"{name}: scaled err {err:.3e}"


@pytest.mark.parametrize("with_ce", [True, False])
@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_split_reverse_twins_hold_the_f32_reference(shape, with_ce):
    """The f32 kernels' twin launch by launch (split_tf32) against the plain
    f32 reverse: dgates, dx0, dlog, d(h_init) and d(cond) each within 2e-6
    of its largest magnitude (targets -1, V and 999 mixed in)."""
    *_, w, _, _, tok, din, _, hs, cs, gs = _case(*SHAPES[shape], "float32", with_ce, seed=shape)
    args = (w, torch.from_numpy(din), torch.from_numpy(tok), hs, cs, gs, with_ce)
    got = fd.decoder_reverse_steps_reference(*args, split_tf32=True)
    want = fd.decoder_reverse_reference(*args)
    errs = {name: _scaled_err(g, w_) for name, g, w_ in
            zip(("dgates", "dx0", "dlog", "dh_init", "dcond"), got, want)}
    print(f"split reverse twin vs plain f32, shape {shape}, ce={with_ce}: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    for name, err in errs.items():
        assert err <= 2e-6, (name, err)


@pytest.mark.parametrize("with_ce", [True, False])
@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_split_head_twin_holds_the_unsplit_head(shape, with_ce):
    """decoder_head_bwd_reference with split_tf32 (the f32 head pass's
    products) against the unsplit f32 head: dlog and dtop within 1e-6 of
    their largest magnitude; without CE dlog is the given dlogits as they
    are."""
    *_, w, _, _, tok, din, _, hs, _, _ = _case(*SHAPES[shape], "float32", with_ce, seed=shape)
    args = (w, torch.from_numpy(din), torch.from_numpy(tok), hs, with_ce)
    got = fd.decoder_head_bwd_reference(*args, split_tf32=True)
    want = fd.decoder_head_bwd_reference(*args)
    for name, g, w_ in zip(("dlog", "dtop"), got, want):
        err = _scaled_err(g, w_)
        assert err <= 1e-6, (name, err)
    if not with_ce:
        assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("with_ce", [True, False])
@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_split_twin_gradients_match_pallas_vjp(shape, with_ce):
    """The f32 kernels' twin (split_tf32) through decoder_grads, with its
    d(h_init) and d(cond), against the VJP of decoder_train_ce_pallas /
    decoder_train_pallas (interpret mode) within the f32 tolerance, 1e-4."""
    n, C, V, H = SHAPES[shape]
    jcfg, tcfg, npp, w, h0, cond, tok, din, toks, hs, cs, gs = _case(
        n, C, V, H, "float32", with_ce, seed=shape)
    dgates, dx0, dlog, dh_init, dcond = fd.decoder_reverse_steps_reference(
        w, torch.from_numpy(din), torch.from_numpy(tok), hs, cs, gs, with_ce, split_tf32=True)
    dW, db, dwout, dbout, demb = fd.decoder_grads(w, toks, torch.from_numpy(h0),
                                                  torch.from_numpy(cond), hs, dgates, dx0, dlog)
    fn = decoder_train_ce_pallas if with_ce else decoder_train_pallas
    tf = jnp.ones((L,), bool)
    _, vjp = jax.vjp(lambda p, h, c: fn(p, jcfg, h, c, jnp.asarray(tok), True, tf),
                     jax.tree_util.tree_map(jnp.asarray, npp), jnp.asarray(h0),
                     jnp.asarray(cond))
    jgp, jgh, jgc = vjp(jnp.asarray(din))
    leaves = tc.layer_grads(dW, db, tcfg, E + C)
    pairs = [("h_init", dh_init, jgh), ("conditions", dcond, jgc),
             ("embedding.weight", demb, jgp["embedding"]["weight"]),
             ("fc_out.weight", dwout.T, jgp["fc_out"]["weight"]),
             ("fc_out.bias", dbout, jgp["fc_out"]["bias"])]
    pairs += [(f"lstm_layer_{l}.{k}", leaves[3 * l + i], jgp[f"lstm_layer_{l}"][k])
              for l in range(n) for i, k in enumerate(("Wx", "Wh", "bias"))]
    for name, mine, ref in pairs:
        np.testing.assert_allclose(np.asarray(mine), np.asarray(ref, np.float32), atol=1e-4,
                                   rtol=1e-4, err_msg=name)
