"""Port LSTM gate tail vs the JAX package on the same numpy inputs.

``fused_lstm_gates`` (on CPU tensors: the plain twins of the gate kernels)
against the JAX ``fused_lstm_gates(..., interpret=True)``, forward and VJP
(the shapes of ``tests/test_pallas.py``'s ``test_fused_forward_matches_jnp``
and ``test_fused_backward_matches_jnp``), and ``lstm_cell(use_pallas=True)``
against the JAX cell. Tolerances: float32 values 1e-5 and gradients 1e-4
(the JAX package's own; elementwise, so only the activations' rounding
differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_vae_tpu.ops import lstm as jlstm
from mlx_vae_tpu.ops.pallas_lstm import fused_lstm_gates as jgates
from mlx_vae_tpu_torch.ops import fused_lstm as fl
from mlx_vae_tpu_torch.ops import lstm as tlstm


def _rand(shape, seed, scale=2.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("B,H", [(16, 128), (5, 32)])
def test_fused_forward_matches_pallas_interpret(B, H):
    gates, c = _rand((B, 4 * H), 0), _rand((B, H), 1)
    jh, jc = jgates(jnp.asarray(gates), jnp.asarray(c), True)
    th, tc = fl.fused_lstm_gates(torch.from_numpy(gates), torch.from_numpy(c))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,H", [(8, 128), (3, 40)])
def test_fused_backward_matches_pallas_interpret(B, H):
    gates, c = _rand((B, 4 * H), 2), _rand((B, H), 3)
    wh, wc = _rand((B, H), 4, 1.0), _rand((B, H), 5, 1.0)

    def jloss(g, cc):
        h, cn = jgates(g, cc, True)
        return jnp.sum(h * wh) + jnp.sum(cn * wc)

    jg, jc = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(gates), jnp.asarray(c))
    tg, tcc = torch.from_numpy(gates).requires_grad_(True), torch.from_numpy(c).requires_grad_(True)
    h, cn = fl.fused_lstm_gates(tg, tcc)
    ((h * torch.from_numpy(wh)).sum() + (cn * torch.from_numpy(wc)).sum()).backward()
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tcc.grad.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-4)


def test_plain_backward_equals_autograd_of_the_plain_forward():
    """The backward twin is the VJP of the forward twin."""
    gates = torch.from_numpy(_rand((6, 64), 6)).requires_grad_(True)
    c = torch.from_numpy(_rand((6, 16), 7)).requires_grad_(True)
    dh, dc = torch.from_numpy(_rand((6, 16), 8)), torch.from_numpy(_rand((6, 16), 9))
    h, cn = fl.gates_fwd_reference(gates, c)
    ga, ca = torch.autograd.grad((h * dh).sum() + (cn * dc).sum(), (gates, c))
    gb, cb = fl.gates_bwd_reference(gates.detach(), c.detach(), dh, dc)
    torch.testing.assert_close(gb, ga, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(cb, ca, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_cell_with_use_pallas_matches_jax(dtype):
    """``lstm_cell(use_pallas=True)`` (the gate pair's plain twins here)
    against the JAX cell: values and the gradients of every input."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    params = jax.tree_util.tree_map(np.array, jlstm.init_lstm_params(jax.random.PRNGKey(1), 24, 32))
    x, h, c = _rand((7, 24), 10, 1.0), _rand((7, 32), 11, 0.5), _rand((7, 32), 12, 0.5)
    w = _rand((7, 32), 13, 1.0)

    def jloss(p, xx, hh, cc):
        h2, c2 = jlstm.lstm_cell(p, xx, hh, cc, jdt, use_pallas=True)
        return jnp.sum(h2 * w) + jnp.sum(c2 * w * 0.5)

    jv, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3))(
        jax.tree_util.tree_map(jnp.asarray, params), *map(jnp.asarray, (x, h, c)))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    tx, th, tc = (torch.from_numpy(a).requires_grad_(True) for a in (x, h, c))
    before = (fl.gates_fwd.launches, fl.gates_bwd.launches)
    h2, c2 = tlstm.lstm_cell(tp, tx, th, tc, tdt, use_pallas=True)
    tv = (h2 * torch.from_numpy(w)).sum() + (c2 * torch.from_numpy(w) * 0.5).sum()
    tv.backward()
    assert (fl.gates_fwd.launches, fl.gates_bwd.launches) == before  # plain twins on CPU
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5, atol=1e-5)
    for got, want in zip([tp[k].grad for k in ("Wh", "Wx", "bias")] + [tx.grad, th.grad, tc.grad],
                         [jg[0][k] for k in ("Wh", "Wx", "bias")] + list(jg[1:])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_wrappers_refuse_other_devices():
    g, c = torch.empty((2, 32), device="meta"), torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        fl.gates_fwd(g, c)
    with pytest.raises(ValueError, match="unsupported device meta"):
        fl.gates_bwd(g, c, c, c)
