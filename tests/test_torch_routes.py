"""The routes a model takes on the card, against the JAX package's routing.

* The route grid: for each configuration (V 80 and 600, 2 and 9 layers,
  bf16 H=2048 with one layer, H=1024 with 4 layers, H=9000 with one layer,
  ``custom_vjp``, ``reference_zero_state``, ``bidirectional``; f32 and
  bf16), the JAX ``decoder_apply`` and ``encoder_apply`` run with the
  backend reported as a TPU, their kernels' predicates replaced by the
  port's (the TPU's VMEM limits are not the card's) and every route
  stubbed to record itself. The port's ``train_decoder_route`` and
  ``encoder_route`` must name the same routes, and every kernel they name
  must take the configuration. The dry run's own check
  (``parallel/dryrun.py:kernel_route_refusal``) refuses exactly the
  configurations whose encoder or decoder takes no train-kernel route.
* A V=600 model (which the whole-stack kernels refuse) and a 9-layer one,
  narrow: ``complete_vae_loss`` and its gradients on the route the card
  takes (the sequence kernels' and the gate pair's plain versions here)
  against the JAX ``complete_vae_loss`` on the same numpy params and noise.
  Tolerances: the loss scalars 1e-5 (``tests/test_torch_losses.py``), the
  gradients 1e-4 (``tests/test_torch_encoder.py``: the JAX package's own
  kernel-vs-autodiff tolerance).
* ``lstm_sequence`` and ``lstm_sequence_cv`` with ``use_pallas``: the gate
  update through the gate pair's wrappers, against the JAX functions.
* The package surface: ``__all__`` and ``__version__`` equal the JAX
  package's.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlx_vae_tpu
import mlx_vae_tpu_torch
from mlx_vae_tpu import losses as jl
from mlx_vae_tpu.config import ModelConfig as JaxConfig
from mlx_vae_tpu.models import ARCVAE
from mlx_vae_tpu.models import decoder as jdec
from mlx_vae_tpu.models import encoder as jenc
from mlx_vae_tpu.ops import decoder_cv as jdcv
from mlx_vae_tpu.ops import lstm as jlstm
from mlx_vae_tpu.ops import pallas_encoder as jpenc
from mlx_vae_tpu.ops import pallas_seq_lstm as jpseq
from mlx_vae_tpu.ops import pallas_train_decoder as jptd
from mlx_vae_tpu_torch import losses as tl
from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.models.decoder import train_decoder_route
from mlx_vae_tpu_torch.models.encoder import encoder_route, layer_input_widths
from mlx_vae_tpu_torch.ops import fused_lstm as fl
from mlx_vae_tpu_torch.ops import fused_seq_lstm as fs
from mlx_vae_tpu_torch.ops import fused_train_decoder as fd
from mlx_vae_tpu_torch.ops import lstm as tlstm
from mlx_vae_tpu_torch.ops.decoder_cv import decoder_cvp_supported
from mlx_vae_tpu_torch.ops.fused_encoder import fused_encoder_supported
from mlx_vae_tpu_torch.ops.train_common import stack_fits_l2
from mlx_vae_tpu_torch.parallel.dryrun import kernel_route_refusal
from mlx_vae_tpu_torch.utils.tree import params_from_numpy

# the configurations of the grid, each in f32 and bf16 with use_pallas
GRID = [dict(), dict(vocab_size=600), dict(num_layers=9), dict(vocab_size=600, num_layers=9),
        dict(hidden_dim=2048, num_layers=1), dict(hidden_dim=1024, num_layers=4),
        dict(hidden_dim=1024, num_layers=4, vocab_size=600),
        dict(hidden_dim=9000, num_layers=1), dict(custom_vjp=True),
        dict(custom_vjp=True, vocab_size=600), dict(reference_zero_state=True),
        dict(reference_zero_state=True, vocab_size=600), dict(bidirectional=True),
        dict(bidirectional=True, hidden_dim=4096)]
CASES = ([(kw, dt, True) for kw in GRID for dt in ("float32", "bfloat16")]
         + [(dict(), "float32", False), (dict(hidden_dim=1024), "float32", False)])
B, L = 2, 3


class _Took(Exception):
    pass


def _took(route):
    def stub(*a, **k):
        raise _Took(route)
    return stub


def _jax_routes(kw, dtype, use_pallas, monkeypatch):
    """(decoder route, [each encoder layer's route]) the JAX package takes
    on a TPU whose kernels take what the port's take."""
    jcfg = JaxConfig(compute_dtype=dtype, use_pallas=use_pallas, **kw)
    tcfg = ModelConfig(compute_dtype=dtype, use_pallas=use_pallas, **kw)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jptd, "pallas_train_decoder_supported",
                        lambda cfg, b: fd.fused_train_decoder_supported(tcfg)
                        and stack_fits_l2(tcfg))
    monkeypatch.setattr(jptd, "decoder_train_pallas", _took("fused"))
    monkeypatch.setattr(jdcv, "decoder_cvp_supported", lambda cfg, b: decoder_cvp_supported(tcfg))
    monkeypatch.setattr(jdcv, "decoder_train_cvp", _took("cvp"))
    monkeypatch.setattr(jdcv, "decoder_train_cv", _took("cv"))
    monkeypatch.setattr(jdec, "hidden_init_row", lambda *a, **k: None)
    monkeypatch.setattr(jdec, "initialize_hidden_state", _took("scan"))
    z = jnp.zeros((B, jcfg.latent_dim))
    cond = jnp.zeros((B, jcfg.num_conditions))
    x = jnp.ones((B, L), jnp.int32)
    with pytest.raises(_Took) as dec:
        jdec.decoder_apply({}, jcfg, z, cond, target_seq=x, key=jax.random.PRNGKey(0))

    layers = []

    def layer(route):
        def run(params, xs, h0, c0, *a, **k):
            layers.append(route)
            return jnp.zeros(xs.shape[:2] + h0.shape[-1:]), (h0, c0)
        return run

    monkeypatch.setattr(jpenc, "pallas_encoder_supported",
                        lambda cfg, b: fused_encoder_supported(tcfg) and stack_fits_l2(tcfg))
    monkeypatch.setattr(jpenc, "encoder_stack_pallas", _took("fused"))
    monkeypatch.setattr(jpseq, "pallas_seq_supported",
                        lambda i, h, b, wb: fs.fused_seq_supported(i, h, tcfg.dtype))
    monkeypatch.setattr(jpseq, "lstm_sequence_pallas", layer("seq"))
    monkeypatch.setattr(jenc, "lstm_sequence_cv", layer("cv"))
    monkeypatch.setattr(jenc, "lstm_sequence", layer("scan"))
    monkeypatch.setattr(jenc, "_heads", lambda *a, **k: None)
    params = collections.defaultdict(dict, embedding={
        "weight": jnp.zeros((jcfg.vocab_size, jcfg.embedding_dim))})
    try:
        jenc.encoder_apply(params, jcfg, x, cond)
    except _Took as e:
        layers.append(e.args[0])
    return dec.value.args[0], layers


@pytest.mark.parametrize("kw,dtype,use_pallas", CASES)
def test_routes_ask_the_kernels_as_jax_does(kw, dtype, use_pallas, monkeypatch):
    cfg = ModelConfig(compute_dtype=dtype, use_pallas=use_pallas, **kw)
    jax_dec, jax_enc = _jax_routes(kw, dtype, use_pallas, monkeypatch)
    dec = train_decoder_route(cfg, torch.device("cuda"))
    assert dec == jax_dec == train_decoder_route(cfg, torch.device("cpu"))
    if dec == "fused":
        assert fd.fused_train_decoder_supported(cfg) and stack_fits_l2(cfg)
    if dec == "cvp":
        assert decoder_cvp_supported(cfg)
    enc = encoder_route(cfg)
    if enc == "fused":
        assert jax_enc == ["fused"] and fused_encoder_supported(cfg) and stack_fits_l2(cfg)
    else:
        assert set(jax_enc) == {enc} and len(jax_enc) == cfg.num_layers * (1 + cfg.bidirectional)
    if enc == "seq":
        assert all(fs.fused_seq_supported(i, cfg.hidden_dim, cfg.dtype)
                   for i in layer_input_widths(cfg))
    # the dry run refuses exactly the configurations with no train-kernel route
    refusal = kernel_route_refusal(cfg)
    assert (refusal is None) == (use_pallas and enc in ("fused", "seq")
                                 and dec in ("fused", "cvp")), refusal


def test_grid_reaches_every_route():
    """The grid above holds every route of both parts, and the refused
    models the card used to raise on."""
    cfgs = [ModelConfig(compute_dtype=dt, use_pallas=p, **kw) for kw, dt, p in CASES]
    assert {train_decoder_route(c) for c in cfgs} == {"fused", "cvp", "cv", "scan"}
    assert {encoder_route(c) for c in cfgs} == {"fused", "seq", "cv", "scan"}
    v600 = ModelConfig(vocab_size=600, use_pallas=True)
    assert (train_decoder_route(v600), encoder_route(v600)) == ("scan", "seq")
    wide = ModelConfig(hidden_dim=2048, num_layers=1, compute_dtype="bfloat16", use_pallas=True)
    assert not fd.fused_train_decoder_supported(wide) and train_decoder_route(wide) == "cvp"


def _spy(monkeypatch) -> collections.Counter:
    """Count calls of the kernel wrappers the routes can reach."""
    counts = collections.Counter()
    for mod, name in ((fs, "seq_lstm_fwd"), (fs, "seq_lstm_bwd_tm"), (fl, "gates_fwd"),
                      (fl, "gates_bwd"), (fd, "decoder_fwd"), (fd, "decoder_bwd")):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _key=name, **k):
            counts[_key] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    return counts


@pytest.mark.parametrize("model", [dict(vocab_size=600), dict(vocab_size=40, num_layers=9)])
def test_refused_model_loss_and_grads_match_jax(model, monkeypatch):
    """The loss and every gradient leaf of a model the whole-stack kernels
    refuse, on the route the card takes for it (encoder: the sequence
    kernels, decoder: the scan with the gate pair), against JAX."""
    kw = {**dict(embedding_dim=16, hidden_dim=32, latent_dim=8, num_conditions=1,
                 num_layers=2), **model}
    jcfg, tcfg = JaxConfig(**kw), ModelConfig(use_pallas=True, **kw)
    assert not fd.fused_train_decoder_supported(tcfg)
    assert (encoder_route(tcfg), train_decoder_route(tcfg)) == ("seq", "scan")
    vae = ARCVAE(jcfg, jax.random.PRNGKey(3), with_predictor=True)
    npp = jax.tree_util.tree_map(np.asarray, vae.params)
    rng = np.random.default_rng(8)
    Bm, Lm = 8, 10
    x = rng.integers(1, kw["vocab_size"], (Bm, Lm)).astype(np.int32)
    cond = rng.standard_normal((Bm, 1)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    hyp = dict(beta=0.05, lambda_prop=0.1, lambda_collapse=0.001, free_bits=1.0,
               lambda_mi=0.01, target_mi=4.85)

    def jloss(p):
        out = jl.complete_vae_loss(p["encoder"], p["decoder"], p["predictor"], jcfg,
                                   jnp.asarray(x), jnp.asarray(cond), key,
                                   teacher_forcing_ratio=0.7, **hyp)
        return out["total_loss"], out

    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(vae.params)
    k_rep, k_tf, _ = jax.random.split(key, 3)
    eps = torch.from_numpy(np.array(jax.random.normal(k_rep, (Bm, kw["latent_dim"]))))
    tf = torch.from_numpy(np.array(jax.random.uniform(k_tf, (Lm,)) < 0.7))
    tp = params_from_numpy(npp)
    for tree in tp.values():
        for leaf in tree.values():
            for t in leaf.values():
                t.requires_grad_(True)
    counts = _spy(monkeypatch)
    got = tl.complete_vae_loss(tp["encoder"], tp["decoder"], tp["predictor"], tcfg,
                               torch.from_numpy(x), torch.from_numpy(cond), eps, tf, **hyp)
    got["total_loss"].backward()
    n = tcfg.num_layers
    assert dict(counts) == {"seq_lstm_fwd": n, "seq_lstm_bwd_tm": n, "gates_fwd": Lm * n,
                            "gates_bwd": Lm * n}
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    for part, tree in tp.items():
        for name, leaf in tree.items():
            for k, t in leaf.items():
                np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrads[part][name][k]),
                                           rtol=1e-4, atol=1e-4, err_msg=f"{part}.{name}.{k}")


@pytest.mark.parametrize("cv", [False, True])
def test_lstm_sequence_with_use_pallas_matches_jax(cv, monkeypatch):
    """The scan's gate update through the gate pair's wrappers (in
    ``lstm_sequence_cv`` its forward alone, under the hand-written
    backward): outputs and gradients against the JAX function."""
    I, H = 6, 8
    rng = np.random.default_rng(2)
    p = {"Wx": rng.uniform(-0.4, 0.4, (4 * H, I)), "Wh": rng.uniform(-0.4, 0.4, (4 * H, H)),
         "bias": rng.uniform(-0.4, 0.4, (4 * H,))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    xs = rng.standard_normal((B, 5, I)).astype(np.float32)
    h0, c0 = (0.5 * rng.standard_normal((B, H)).astype(np.float32) for _ in range(2))
    w = rng.standard_normal((B, 5, H)).astype(np.float32)
    jfn = jlstm.lstm_sequence_cv if cv else jlstm.lstm_sequence

    def jloss(pp, xx):
        hs, (h, c) = jfn(pp, xx, jnp.asarray(h0), jnp.asarray(c0), jnp.float32, True)
        return jnp.sum(hs * w) + jnp.sum(h * c), hs

    (_, jhs), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(xs))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(xs).requires_grad_(True)
    counts = _spy(monkeypatch)
    tfn = tlstm.lstm_sequence_cv if cv else tlstm.lstm_sequence
    hs, (h, c) = tfn(tp, tx, torch.from_numpy(h0), torch.from_numpy(c0), torch.float32,
                     use_pallas=True)
    ((hs * torch.from_numpy(w)).sum() + (h * c).sum()).backward()
    assert dict(counts) == ({"gates_fwd": 5} if cv else {"gates_fwd": 5, "gates_bwd": 5})
    np.testing.assert_allclose(hs.detach().numpy(), np.asarray(jhs), rtol=1e-5, atol=1e-5)
    for k, t in tp.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-4)


def test_package_surface_equals_jax():
    assert mlx_vae_tpu_torch.__all__ == mlx_vae_tpu.__all__
    assert mlx_vae_tpu_torch.__version__ == mlx_vae_tpu.__version__
    for name in ("ModelConfig", "TrainConfig"):
        port, ref = getattr(mlx_vae_tpu_torch, name), getattr(mlx_vae_tpu, name)
        assert port.__module__ == "mlx_vae_tpu_torch.config"
        assert set(port.__dataclass_fields__) >= set(ref.__dataclass_fields__)
