"""The bf16 training decoder forward's chain, launch by launch, through its
plain twins: per step one step-kernel twin per layer
(``train_common.seq_fwd_step_reference``, layer 0 over the fed token's
embedding row and the conditions) and one vocab-head twin
(``fused_train_decoder.decoder_head_step_reference``), composed as
``decoder_fwd_steps_reference``.

* Against the plain forward ``decoder_fwd_reference``: bit for bit (CE or
  logits, fed tokens, hs, cs, gs), in f32 and bf16, with and without CE,
  teacher forcing all on and a seeded 0.9 mask, targets outside [0, V)
  included.
* Against the JAX package's fused forwards in interpret mode on the same
  numpy params and inputs: ``_run_fwd`` (CE and logits) and, where
  ``fwd_blk_supported`` takes the shape, ``decoder_fwd_blk`` (logits).
  Tolerances as ``tests/test_torch_train_decoder.py``'s: f32 within 1e-5;
  bf16 within 2e-2 of each output's largest magnitude (both round the same
  operands; the sums run in other orders, which can move a stored bf16
  residual by one ulp). Under the 0.9 mask the fed tokens follow argmaxes,
  which can flip where two logits tie to ~1 ulp: >= 99.0% of the first
  argmax-fed tokens and >= 97.0% of rows agree (the JAX package's
  kernel/scan contract), and the outputs are held on the rows whose fed
  tokens agree.
* The f32 kernels' twin (``split_tf32=True``: the step's and the head's
  products as split-TF32): within 1e-6 of each output's largest magnitude
  of the plain f32 forward, and against ``_run_fwd`` and
  ``decoder_fwd_blk`` in interpret mode under the same contract and f32
  tolerance as the plain twin.
* The step kernel's plan with the condition segment: each weight row at
  its reduction column, and ``C = 0`` giving the plan and matrix of a step
  kernel without conditions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_vae_tpu.config import ModelConfig as JaxConfig
from mlx_vae_tpu.models import decoder as jdec
from mlx_vae_tpu.ops.pallas_train_decoder import _run_fwd, decoder_fwd_blk, fwd_blk_supported
from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.ops import fused_train_decoder as fd
from mlx_vae_tpu_torch.ops import train_common as tc
from mlx_vae_tpu_torch.utils.tree import params_from_numpy

# (n, E, C, H, V): ragged embedding widths, one and three conditions, hidden
# widths off the 64-column stage (100) and below it (32), both vocab layouts
SHAPES = [(1, 16, 1, 32, 80), (2, 20, 3, 100, 200), (3, 129, 1, 100, 80), (2, 129, 3, 32, 200)]
# shapes decoder_fwd_blk takes (H % 128 == 0, B % 8 == 0)
BLK_SHAPES = [(2, 16, 1, 128, 80), (1, 20, 3, 128, 200)]
B, L = 40, 6
TF = {"on": None, "0.9": 0.9}
AGREE_FIRST, AGREE_ROWS = 0.99, 0.97


def _case(shape, dtype, tf_name, seed=0):
    """(jax cfg, port cfg, numpy params, h0, cond, targets, tf) from one seed."""
    n, E, C, H, V = shape
    kw = dict(vocab_size=V, embedding_dim=E, hidden_dim=H, latent_dim=8, num_conditions=C,
              num_layers=n, compute_dtype=dtype)
    jcfg = JaxConfig(**kw)
    npp = jax.tree_util.tree_map(np.array, jdec.init_decoder_params(jax.random.PRNGKey(seed),
                                                                    jcfg))
    rng = np.random.default_rng(seed + 1)
    h0 = rng.standard_normal((B, H)).astype(np.float32)
    cond = rng.standard_normal((B, C)).astype(np.float32)
    tok = rng.integers(0, V, (B, L)).astype(np.int32)
    tf = np.ones(L, bool)
    if TF[tf_name] is not None:
        tf = rng.uniform(size=L) < TF[tf_name]
        tf[2] = False  # at least one argmax-fed step
    return jcfg, ModelConfig(**kw), npp, h0, cond, tok, tf


def _port(tcfg, npp, h0, cond, tok, tf, with_ce, steps=True, split_tf32=False):
    w = tc.prepare_stack_weights(params_from_numpy(npp), tcfg, with_head=True)
    args = (w, torch.from_numpy(h0), torch.from_numpy(cond), torch.from_numpy(tok),
            torch.from_numpy(tf), with_ce)
    if not steps:
        return fd.decoder_fwd_reference(*args)
    return fd.decoder_fwd_steps_reference(*args, split_tf32=split_tf32)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


def _hold(got, want, dtype, what):
    got, want = _f32(got), _f32(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5, err_msg=what)
    else:
        err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-3)
        assert err < 2e-2, f"{what}: scaled err {err:.3e}"


@pytest.mark.parametrize("tf_name", list(TF))
@pytest.mark.parametrize("with_ce", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES + BLK_SHAPES)
def test_steps_compose_to_the_decoder_reference(shape, dtype, with_ce, tf_name):
    """The chain's twins in launch order equal the plain forward bit for
    bit, targets outside [0, V) (fed as zero embedding rows, no CE target
    term) included."""
    _, tcfg, npp, h0, cond, tok, tf = _case(shape, dtype, tf_name)
    tok[0, 1], tok[1, 3], tok[2, 0] = -1, tcfg.vocab_size, 999
    got = _port(tcfg, npp, h0, cond, tok, tf, with_ce)
    want = _port(tcfg, npp, h0, cond, tok, tf, with_ce, steps=False)
    for name, g, w in zip(("out", "toks", "hs", "cs", "gs"), got, want):
        assert torch.equal(g, w), name


def _hold_against(got, want_out, want_toks, want_res, dtype, tf):
    """Fed tokens under the greedy contract, then out (and, with teacher
    forcing all on, the residuals) on the rows whose fed tokens agree."""
    toks = got[1].numpy()
    want_toks = np.asarray(want_toks)
    rows = (toks == want_toks).all(axis=0)
    if tf.all():
        assert rows.all()
    else:
        first = int(np.nonzero(~tf)[0][0]) + 1
        assert (toks[first] == want_toks[first]).mean() >= AGREE_FIRST
        assert rows.mean() >= AGREE_ROWS, rows.mean()
    out = _f32(got[0])[rows]
    _hold(out, np.asarray(want_out, np.float32)[rows], dtype, "out")
    if want_res is not None:
        for name, g, w in zip(("hs", "cs", "gs"), got[2:], want_res):
            _hold(g, w, dtype, name)


@pytest.mark.parametrize("tf_name", list(TF))
@pytest.mark.parametrize("with_ce", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_steps_match_jax_run_fwd(shape, dtype, with_ce, tf_name):
    """The chain's twins against ``_run_fwd(interpret=True)``: the CE
    ``[B]`` or logits ``[B, L, V]``, the fed tokens and (teacher forcing all
    on) the layer-stacked residuals."""
    jcfg, tcfg, npp, h0, cond, tok, tf = _case(shape, dtype, tf_name)
    got = _port(tcfg, npp, h0, cond, tok, tf, with_ce)
    p = jax.tree_util.tree_map(jnp.asarray, npp)
    out, res = _run_fwd(p, jcfg, jnp.asarray(h0), jnp.asarray(cond), jnp.asarray(tok), True,
                        jnp.asarray(tf), with_ce)
    _hold_against(got, out, res[4][:L], res[5:] if tf.all() else None, dtype, tf)


@pytest.mark.parametrize("tf_name", list(TF))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", BLK_SHAPES)
def test_steps_match_jax_fwd_blk(shape, dtype, tf_name):
    """The logits specialization against ``decoder_fwd_blk(interpret=True)``
    (the forward of ``decoder_train_cvp``) at shapes it takes."""
    jcfg, tcfg, npp, h0, cond, tok, tf = _case(shape, dtype, tf_name, seed=3)
    assert fwd_blk_supported(jcfg, B)
    got = _port(tcfg, npp, h0, cond, tok, tf, False)
    p = jax.tree_util.tree_map(jnp.asarray, npp)
    out, (toks, hs, cs, gs) = decoder_fwd_blk(p, jcfg, jnp.asarray(h0), jnp.asarray(cond),
                                              jnp.asarray(tok), jnp.asarray(tf), interpret=True)
    _hold_against(got, out, toks, (hs, cs, gs) if tf.all() else None, dtype, tf)


@pytest.mark.parametrize("tf_name", list(TF))
@pytest.mark.parametrize("with_ce", [True, False])
@pytest.mark.parametrize("shape", SHAPES + BLK_SHAPES)
def test_split_steps_match_the_plain_forward(shape, with_ce, tf_name):
    """The f32 kernels' twin (split-TF32 products) against the plain f32
    forward: the fed tokens under the greedy contract (equal under full
    teacher forcing), then on the rows whose fed tokens agree the CE or
    logits, and with teacher forcing all on hs, cs and gs, each within 1e-6
    of its largest magnitude (the split keeps ~2^-21 of each product),
    targets outside [0, V) included."""
    _, tcfg, npp, h0, cond, tok, tf = _case(shape, "float32", tf_name)
    tok[0, 1], tok[1, 3], tok[2, 0] = -1, tcfg.vocab_size, 999
    got = _port(tcfg, npp, h0, cond, tok, tf, with_ce, split_tf32=True)
    want = _port(tcfg, npp, h0, cond, tok, tf, with_ce, steps=False)
    rows = (got[1] == want[1]).all(dim=0).numpy()
    if tf.all():
        assert rows.all()
    else:
        first = int(np.nonzero(~tf)[0][0]) + 1
        assert (got[1][first] == want[1][first]).float().mean().item() >= AGREE_FIRST
        assert rows.mean() >= AGREE_ROWS
    pairs = [("out", got[0][rows], want[0][rows])]
    if tf.all():
        pairs += list(zip(("hs", "cs", "gs"), got[2:], want[2:]))
    for name, g, w in pairs:
        err = (g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
        assert err <= 1e-6, f"{name}: {err:.3e}"


@pytest.mark.parametrize("tf_name", list(TF))
@pytest.mark.parametrize("with_ce", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_split_steps_match_jax_run_fwd(shape, with_ce, tf_name):
    """The f32 kernels' twin against ``_run_fwd(interpret=True)``, with
    ``test_steps_match_jax_run_fwd``'s contract and f32 tolerance."""
    jcfg, tcfg, npp, h0, cond, tok, tf = _case(shape, "float32", tf_name)
    got = _port(tcfg, npp, h0, cond, tok, tf, with_ce, split_tf32=True)
    p = jax.tree_util.tree_map(jnp.asarray, npp)
    out, res = _run_fwd(p, jcfg, jnp.asarray(h0), jnp.asarray(cond), jnp.asarray(tok), True,
                        jnp.asarray(tf), with_ce)
    _hold_against(got, out, res[4][:L], res[5:] if tf.all() else None, "float32", tf)


@pytest.mark.parametrize("tf_name", list(TF))
@pytest.mark.parametrize("shape", BLK_SHAPES)
def test_split_steps_match_jax_fwd_blk(shape, tf_name):
    """The f32 kernels' twin, logits specialization, against
    ``decoder_fwd_blk(interpret=True)``."""
    jcfg, tcfg, npp, h0, cond, tok, tf = _case(shape, "float32", tf_name, seed=3)
    got = _port(tcfg, npp, h0, cond, tok, tf, False, split_tf32=True)
    p = jax.tree_util.tree_map(jnp.asarray, npp)
    out, (toks, hs, cs, gs) = decoder_fwd_blk(p, jcfg, jnp.asarray(h0), jnp.asarray(cond),
                                              jnp.asarray(tok), jnp.asarray(tf), interpret=True)
    _hold_against(got, out, toks, (hs, cs, gs) if tf.all() else None, "float32", tf)


# (I, C, H): conditions beside ragged and aligned input widths
PLANS = [(16, 1, 32), (20, 3, 100), (129, 1, 100), (129, 3, 32), (64, 64, 64), (128, 65, 1024)]


@pytest.mark.parametrize("case", range(len(PLANS)))
def test_interleave_places_every_row_at_its_column(case):
    """``interleave_weight`` with a condition segment: the input rows at
    columns 0..I-1, the conditions' at round_up(I, 64) + k, the h rows at
    Ixp + j (``fwd_step_plan``), gate column q * H + u at output row 128 (u
    // 32) + 32 q + u % 32, zeros everywhere else."""
    I, C, H = PLANS[case]
    ixp, kp, np_ = tc.fwd_step_plan(I, H, C)
    ix = -(-I // 64) * 64
    assert ixp == ix + -(-C // 64) * 64 and kp == ixp + -(-H // 64) * 64
    assert np_ == -(-H // 32) * 128
    w = torch.from_numpy(np.random.default_rng(case).standard_normal(
        (I + C + H, 4 * H)).astype(np.float32))
    wt = tc.interleave_weight(w, I, H, C)
    assert wt.shape == (np_, kp)
    cols = torch.cat([torch.arange(I), ix + torch.arange(C), ixp + torch.arange(H)])
    assert torch.equal(cols, tc.step_columns(I, H, C))
    rows = tc.gate_columns(H)
    assert torch.equal(wt[rows[:, None], cols[None]], w.T)
    rest = torch.ones_like(wt, dtype=torch.bool)
    rest[rows[:, None], cols[None]] = False
    assert not wt[rest].any()


def _interleave_without_conditions(w, I, H):
    """The step kernel's weight as it was built before the condition
    segment: input rows at k < I, h rows at round_up(I, 64) + j."""
    ixp = -(-I // 64) * 64
    out = w.new_zeros((-(-H // 32) * 128, ixp + -(-H // 64) * 64))
    n = tc.gate_columns(H)
    out[n, :I] = w[:I].T
    out[n, ixp:ixp + H] = w[I:].T
    return out


@pytest.mark.parametrize("I,H", [(16, 32), (129, 100), (1024, 1024), (3000, 64)])
def test_no_conditions_is_the_plan_without_them(I, H):
    """``C = 0`` (the sequence and encoder routes) gives the plan and the
    matrix those routes had, exactly."""
    w = torch.from_numpy(np.random.default_rng(I).standard_normal(
        (I + H, 4 * H)).astype(np.float32)).to(torch.bfloat16)
    ixp = -(-I // 64) * 64
    assert tc.fwd_step_plan(I, H) == tc.fwd_step_plan(I, H, 0) == \
        (ixp, ixp + -(-H // 64) * 64, -(-H // 32) * 128)
    assert torch.equal(tc.interleave_weight(w, I, H), _interleave_without_conditions(w, I, H))


def test_head_step_ties_and_targets_outside_the_vocab():
    """The head twin: an argmax tie goes to the lowest index; a target
    outside [0, V) adds no target term to the CE; the last step writes no
    next token."""
    V, H, Bh, Lh = 5, 4, 3, 2
    cfg = ModelConfig(vocab_size=V, hidden_dim=H, embedding_dim=4, latent_dim=8, num_layers=1)
    wout = torch.zeros((H, V))
    bout = torch.tensor([0.0, 2.0, 2.0, -1.0, 1.0])
    w = tc.StackWeights(cfg=cfg, emb=torch.zeros((V, 4)), wcat=torch.zeros(1), layers=(),
                        bias=torch.zeros(1), wout=wout, woutT=wout.T, bout=bout)
    hs = torch.zeros((Lh, 1, Bh, H))
    targets = torch.tensor([[4, 1], [-1, 0], [V, 2]], dtype=torch.int32)
    tf = torch.tensor([False, False])
    toks = torch.full((Lh, Bh), 7, dtype=torch.int32)
    out = torch.zeros((Bh,))
    fd.decoder_head_step_reference(w, 0, hs, targets, tf, toks, out, True)
    lse = float(torch.logsumexp(bout, 0))
    assert torch.allclose(out, torch.tensor([lse - 1.0, lse, lse]))
    assert toks[1].tolist() == [1, 1, 1]
    fd.decoder_head_step_reference(w, 1, hs, targets, tf, toks, out, True)
    assert toks[1].tolist() == [1, 1, 1]
