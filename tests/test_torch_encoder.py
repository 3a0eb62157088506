"""Port encoder vs the JAX package on the same numpy params and inputs.

``encoder_apply`` (scan path, bidirectional and dropout included), the
bounded heads, ``reparameterize``, and the fused encoder's plain path
against ``encoder_stack_pallas`` in interpret mode (forward and every
gradient leaf, n = 1, 2, 3, at the JAX kernel tests' shapes). The bf16
kernels' step twins (the forward's step, the backward's reverse-chain
launch) composed in launch order equal the plain versions bit for bit.

Tolerances: float32 forward values 1e-5 (the frameworks sum in different
orders); float32 gradients 1e-4, the JAX package's own kernel-vs-autodiff
tolerance (``tests/test_pallas.py``). bfloat16: the fused paths on both
sides follow the same activated-gate residual contract and round the same
operands, so their leaves agree within 2e-2 of each leaf's largest
magnitude (one bf16 ulp is ~4e-3 relative, and summation order can move a
rounding); the scan path is held at 2e-2 on its values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_vae_tpu.config import ModelConfig as JaxConfig
from mlx_vae_tpu.models import encoder as jenc
from mlx_vae_tpu.ops.pallas_encoder import encoder_stack_pallas
from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.models import encoder as tenc
from mlx_vae_tpu_torch.ops import fused_encoder as fe
from mlx_vae_tpu_torch.utils.tree import params_from_numpy, params_to_numpy

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _cfgs(n=2, dtype="float32", H=128, **kw):
    kw = dict(dict(vocab_size=24, embedding_dim=16, hidden_dim=H, latent_dim=8,
                   num_conditions=1, num_layers=n, compute_dtype=dtype), **kw)
    return JaxConfig(**kw), ModelConfig(**kw)


def _setup(jcfg, B=8, L=9, seed=0):
    jp = jenc.init_encoder_params(jax.random.PRNGKey(seed), jcfg)
    npp = jax.tree_util.tree_map(np.asarray, jp)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, jcfg.vocab_size, (B, L)).astype(np.int32)
    cond = rng.standard_normal((B, jcfg.num_conditions)).astype(np.float32)
    return jp, npp, x, cond


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _scaled_close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-3)
    assert err < tol, f"{what}: scaled err {err:.3e}"


def test_init_tree_matches_jax_layout():
    jcfg, tcfg = _cfgs(2, bidirectional=True)
    _, npp, _, _ = _setup(jcfg)
    mine = params_to_numpy(tenc.init_encoder_params(torch.Generator().manual_seed(0), tcfg))
    assert jax.tree_util.tree_map(np.shape, mine) == jax.tree_util.tree_map(np.shape, npp)
    assert np.all(mine["fc_logvar"]["bias"] == 0.35)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_encoder_apply_scan_matches_jax(n, dtype):
    jcfg, tcfg = _cfgs(n, dtype, H=32)
    jp, npp, x, cond = _setup(jcfg)
    jmu, jlv = jenc.encoder_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(cond))
    tmu, tlv = tenc.encoder_apply(params_from_numpy(npp), tcfg, torch.from_numpy(x),
                                  torch.from_numpy(cond))
    _close(tmu, jmu, TOL[dtype])
    _close(tlv, jlv, TOL[dtype])
    assert float(tmu.abs().max()) <= 2.0 and -2.0 <= float(tlv.min()) <= float(tlv.max()) <= 0.0


def test_encoder_apply_bidirectional_and_dropout_match_jax():
    """The extension flags: reverse-direction layers and inter-layer
    dropout, with the keep-masks the JAX key draws handed to the port."""
    jcfg, tcfg = _cfgs(3, H=32, bidirectional=True, apply_dropout=True)
    jp, npp, x, cond = _setup(jcfg)
    key = jax.random.PRNGKey(4)
    jmu, jlv = jenc.encoder_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(cond), dropout_key=key)
    masks, k = [], key
    for _ in range(jcfg.num_layers - 1):
        k, dk = jax.random.split(k)
        masks.append(torch.from_numpy(np.array(jax.random.bernoulli(
            dk, 1.0 - jcfg.dropout, (x.shape[0], x.shape[1], 2 * jcfg.hidden_dim)))))
    tmu, tlv = tenc.encoder_apply(params_from_numpy(npp), tcfg, torch.from_numpy(x),
                                  torch.from_numpy(cond), keep_masks=masks)
    _close(tmu, jmu, 1e-5)
    _close(tlv, jlv, 1e-5)
    # drawn masks have the JAX shapes and keep rate
    drawn = tenc.dropout_masks(torch.Generator().manual_seed(0), tcfg, 64, 9)
    assert len(drawn) == 2 and drawn[0].shape == (64, 9, 64)
    assert abs(drawn[0].float().mean().item() - 0.8) < 0.02


def test_heads_and_reparameterize_match_jax():
    jcfg, tcfg = _cfgs(2, H=32)
    jp, npp, _, cond = _setup(jcfg)
    rng = np.random.default_rng(5)
    feat = (3.0 * rng.standard_normal((8, 32))).astype(np.float32)  # drives the bounds
    jmu, jlv = jenc._heads(jp, jcfg, jnp.asarray(feat), jnp.asarray(cond))
    tmu, tlv = tenc._heads(params_from_numpy(npp), tcfg, torch.from_numpy(feat),
                           torch.from_numpy(cond))
    _close(tmu, jmu, 1e-5)
    _close(tlv, jlv, 1e-5)
    key = jax.random.PRNGKey(6)
    eps = np.array(jax.random.normal(key, jmu.shape))
    _close(tenc.reparameterize(torch.from_numpy(eps), tmu, tlv),
           jenc.reparameterize(key, jmu, jlv), 1e-5)


def _fused_grads(jcfg, tcfg, npp, x, w):
    """(JAX value, JAX grads, port value, port grads) of sum(pooled * w)."""
    jv, jg = jax.value_and_grad(lambda p: jnp.sum(
        encoder_stack_pallas(p, jcfg, jnp.asarray(x), True) * w))(
        jax.tree_util.tree_map(jnp.asarray, npp))
    tp = params_from_numpy(npp)
    leaves = [tp["embedding"]["weight"]] + fe.layer_leaves(tp, tcfg)
    for leaf in leaves:
        leaf.requires_grad_(True)
    pooled = fe.encoder_stack(tp, tcfg, torch.from_numpy(x))
    tv = (pooled * torch.from_numpy(w)).sum()
    tv.backward()
    return jv, jg, tv.detach(), tp, pooled.detach()


@pytest.mark.parametrize("n", [1, 2, 3])
def test_fused_plain_path_matches_pallas_interpret(n):
    jcfg, tcfg = _cfgs(n)
    _, npp, x, _ = _setup(jcfg)
    w = np.random.default_rng(7).standard_normal((8, 128)).astype(np.float32)
    jv, jg, tv, tp, pooled = _fused_grads(jcfg, tcfg, npp, x, w)
    _close(pooled, encoder_stack_pallas(jax.tree_util.tree_map(jnp.asarray, npp), jcfg,
                                        jnp.asarray(x), True), 1e-5)
    _close(tv, jv, 1e-5)
    names = ["embedding"] + [f"lstm_layer_{i}" for i in range(n)]
    for name in names:
        for k, leaf in tp[name].items():
            _close(leaf.grad, jg[name][k], 1e-4)


def test_fused_plain_path_matches_pallas_interpret_bf16():
    """bf16: both sides store activated gates in bf16 and round the same
    operands, so they agree leaf by leaf within the scaled tolerance."""
    jcfg, tcfg = _cfgs(2, "bfloat16")
    _, npp, x, _ = _setup(jcfg)
    w = np.random.default_rng(7).standard_normal((8, 128)).astype(np.float32)
    jv, jg, tv, tp, _ = _fused_grads(jcfg, tcfg, npp, x, w)
    _scaled_close(tv, jv, 2e-2, "value")
    for name in ["embedding", "lstm_layer_0", "lstm_layer_1"]:
        for k, leaf in tp[name].items():
            _scaled_close(leaf.grad, jg[name][k], 2e-2, f"{name}.{k}")


def test_fused_route_matches_jax_encoder_apply():
    """``use_pallas`` on CPU tensors runs the fused encoder's plain version;
    it equals the JAX encoder (whose CPU backend takes the scan)."""
    jcfg, tcfg = _cfgs(2)
    jp, npp, x, cond = _setup(jcfg)
    jmu, jlv = jenc.encoder_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(cond))
    tmu, tlv = tenc.encoder_apply(params_from_numpy(npp), tcfg.replace(use_pallas=True),
                                  torch.from_numpy(x), torch.from_numpy(cond))
    _close(tmu, jmu, 1e-5)
    _close(tlv, jlv, 1e-5)


def test_custom_vjp_width_is_not_ported_yet():
    """``custom_vjp`` (and H >= 768) once raised here; the encoder now runs
    each layer through ``lstm_sequence_cv``, as the JAX encoder does, and
    its heads and gradients equal the JAX package's."""
    jcfg, tcfg = _cfgs(2, H=32, custom_vjp=True)
    jp, npp, x, cond = _setup(jcfg)
    w = np.random.default_rng(3).standard_normal((8, jcfg.latent_dim)).astype(np.float32)

    def jloss(p):
        mu, lv = jenc.encoder_apply(p, jcfg, jnp.asarray(x), jnp.asarray(cond))
        return jnp.sum(mu * w) + jnp.sum(lv * w * 0.5)

    jv, jg = jax.value_and_grad(jloss)(jp)
    tp = params_from_numpy(npp)
    for v in tp.values():
        for t in v.values():
            t.requires_grad_(True)
    mu, lv = tenc.encoder_apply(tp, tcfg, torch.from_numpy(x), torch.from_numpy(cond))
    tv = (mu * torch.from_numpy(w)).sum() + (lv * torch.from_numpy(w) * 0.5).sum()
    tv.backward()
    _close(tv.detach(), jv, 1e-5)
    for name, v in tp.items():
        for k, leaf in v.items():
            _close(leaf.grad, jg[name][k], 1e-4)


# ---- the bf16 forward's step kernel, layer by layer, through its plain twin ----

from mlx_vae_tpu_torch.ops import train_common as tc  # noqa: E402


def _encoder_by_steps(w, tokens):
    """The step twin, layer by layer: layer 0 gathers embedding rows by
    token, layer l > 0 reads rows t * n + l - 1 of hs; residuals at rows
    t * n + l; zero initial state. Returns (h_last, hs, cs, gs)."""
    cfg = w.cfg
    n, H, E = cfg.num_layers, cfg.hidden_dim, cfg.embedding_dim
    B, L = tokens.shape
    hs = torch.zeros((L * n, B, H), dtype=cfg.dtype)
    cs, gs = torch.zeros_like(hs), torch.zeros((L * n, B, 4 * H), dtype=cfg.dtype)
    c, h_last = torch.empty((B, H)), torch.empty((B, H))
    for l in range(n):
        I_ = E if l == 0 else H
        wt = tc.interleave_weight(w.layers[l], I_, H)
        for t in range(L):
            kw = dict(tokens=tokens) if l == 0 else dict(x_stride=n, x_offset=l - 1)
            tc.seq_fwd_step_reference(wt, w.bias[l], t, w.emb if l == 0 else hs, c, hs, cs, gs,
                                      I_, H, res_stride=n, res_offset=l,
                                      hf=h_last if (l == n - 1 and t == L - 1) else None, **kw)
    view = lambda a: a.view(L, n, B, -1)  # noqa: E731
    return h_last, view(hs), view(cs), view(gs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,H", [(1, 32), (2, 100), (3, 128)])
def test_fwd_steps_compose_to_the_encoder_reference(n, H, dtype):
    """The step twin composed layer by layer with the token gather (B = 19,
    H = 100 among the widths, and tokens outside [0, V), which read zeros)
    equals encoder_fwd_reference bit for bit and matches
    encoder_stack_pallas(interpret=True) within 1e-5 (f32) / 2e-2 (bf16)."""
    jcfg, tcfg = _cfgs(n, dtype, H=H)
    jp, npp, x, _ = _setup(jcfg, B=19, L=6, seed=n)
    x[0, 0], x[1, 1], x[2, 5] = -1, jcfg.vocab_size, 999
    w = tc.prepare_stack_weights(params_from_numpy(npp), tcfg, with_head=False)
    tok = torch.from_numpy(x)
    got = _encoder_by_steps(w, tok)
    want = fe.encoder_fwd_reference(w, tok)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    jv = encoder_stack_pallas(jp, jcfg, jnp.asarray(x), True)
    if dtype == "float32":
        _close(got[0], jv, 1e-5)
    else:
        _scaled_close(got[0], jv, 2e-2, "h_last")


# ---- the bf16 backward's reverse chain, launch by launch, through its plain twins ----

def _reverse_by_steps(w, dh_last, cs, gs):
    """The chain's launches in order: the gate step of (L-1, n-1) from
    dh_last, then the step twin at (t, l) for t = L-1 .. 0, l = n-1 .. 0.
    Returns (dgates, dx0)."""
    cfg = w.cfg
    L, n, B, H = cs.shape
    dgates = torch.empty((L, n, B, 4 * H), dtype=cfg.dtype)
    dx0 = torch.empty((L, B, cfg.embedding_dim), dtype=cfg.dtype)
    dh, dc = torch.zeros((2, n, B, H))
    tc.reverse_gate_reference(cfg, L - 1, n - 1, dh_last, cs, gs, dgates, dc)
    for t in range(L - 1, -1, -1):
        for l in range(n - 1, -1, -1):
            fe.encoder_reverse_step_reference(w, t, l, cs, gs, dgates, dx0, dh, dc)
    return dgates, dx0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,H,E", [(1, 32, 16), (2, 100, 20), (3, 128, 129)])
def test_reverse_steps_compose_to_the_encoder_reference(n, H, E, dtype):
    """The step twin composed in launch order (B = 19, H = 100 and E = 129
    among the widths, tokens outside [0, V)) equals encoder_reverse_reference
    bit for bit; its dW, db and demb match the VJP of
    encoder_stack_pallas(interpret=True) within 1e-4 (f32) / 2e-2 of each
    leaf's largest magnitude (bf16)."""
    jcfg, tcfg = _cfgs(n, dtype, H=H, embedding_dim=E)
    jp, npp, x, _ = _setup(jcfg, B=19, L=6, seed=n)
    x[0, 0], x[1, 1], x[2, 5] = -1, jcfg.vocab_size, 999
    w = tc.prepare_stack_weights(params_from_numpy(npp), tcfg, with_head=False)
    tok = torch.from_numpy(x)
    _, hs, cs, gs = fe.encoder_fwd_reference(w, tok)
    dh_np = np.random.default_rng(n + 10).standard_normal((19, H)).astype(np.float32)
    dh_last = torch.from_numpy(dh_np)
    got = _reverse_by_steps(w, dh_last, cs, gs)
    want = fe.encoder_reverse_reference(w, dh_last, hs, cs, gs)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    dW, db, demb = fe.encoder_grads(w, tok, hs, *got)
    _, vjp = jax.vjp(lambda p: encoder_stack_pallas(p, jcfg, jnp.asarray(x), True), jp)
    (jg,) = vjp(jnp.asarray(dh_np))
    leaves = fe.layer_grads(dW, db, tcfg, E)
    pairs = [("embedding.weight", demb, jg["embedding"]["weight"])]
    pairs += [(f"lstm_layer_{l}.{k}", leaves[3 * l + i], jg[f"lstm_layer_{l}"][k])
              for l in range(n) for i, k in enumerate(("Wx", "Wh", "bias"))]
    for name, mine, ref in pairs:
        if dtype == "float32":
            _close(mine, ref, 1e-4)
        else:
            _scaled_close(mine, ref, 2e-2, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reverse_step_zero_state_is_explicit_zeros(dtype):
    """c_prev=None (the encoder's step 0, which starts from zero state)
    gives what an explicit zero c_prev gives, bit for bit."""
    rng = np.random.default_rng(3)
    B, H = 7, 12
    gs = torch.from_numpy(rng.uniform(-1, 1, (B, 4 * H)).astype(np.float32)).to(dtype)
    c_t = torch.from_numpy(rng.standard_normal((B, H)).astype(np.float32)).to(dtype)
    dh, dc = (torch.from_numpy(rng.standard_normal((B, H)).astype(np.float32)) for _ in range(2))
    got = tc.reverse_step_reference(gs, c_t, None, dh, dc, dtype)
    want = tc.reverse_step_reference(gs, c_t, torch.zeros((B, H), dtype=dtype), dh, dc, dtype)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
