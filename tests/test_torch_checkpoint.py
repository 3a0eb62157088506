"""`.npz` checkpoints move between the JAX package and the port unchanged."""

import jax
import numpy as np
import pytest

from mlx_vae_tpu.config import ModelConfig as JaxConfig
from mlx_vae_tpu.models.vae import ARCVAE
from mlx_vae_tpu.train import checkpoint as jck
from mlx_vae_tpu.train.optim import adam_init
from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.models.decoder import init_decoder_params
from mlx_vae_tpu_torch.train import checkpoint as tck
from mlx_vae_tpu_torch.utils.tree import params_from_numpy, params_to_numpy

CFG = dict(vocab_size=24, embedding_dim=16, hidden_dim=32, latent_dim=8,
           num_conditions=2, num_layers=2)
STATS = {"properties_mean": [60.0, 2.0], "properties_std": [25.0, 1.0],
         "alphabet": ["<pad>", "<start>", "<eos>", "[C]", "[N]"]}


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(path))


def test_jax_checkpoint_loads_in_port(tmp_path):
    vae = ARCVAE(JaxConfig(**CFG), jax.random.PRNGKey(0), with_predictor=True)
    path = tmp_path / "checkpoint_best.npz"
    jck.save_checkpoint(path, 4, vae.params,
                        {k: adam_init(v) for k, v in vae.params.items()},
                        {"train_loss": [1.0, 0.5]}, best_val_loss=0.25,
                        data_stats=STATS)
    want = jck.load_checkpoint(path)
    got = tck.load_checkpoint(path)
    assert (got["epoch"], got["best_val_loss"], got["history"]) == \
        (4, 0.25, {"train_loss": [1.0, 0.5]})
    _assert_trees_equal(got["params"], want["params"])
    _assert_trees_equal(got["opt_states"], want["opt_states"])
    assert got["data_stats"]["alphabet"] == STATS["alphabet"]
    np.testing.assert_array_equal(got["data_stats"]["properties_mean"],
                                  want["data_stats"]["properties_mean"])
    # leaves stay numpy until the caller moves them
    assert isinstance(got["params"]["decoder"]["fc_out"]["weight"], np.ndarray)


def test_port_checkpoint_loads_in_jax(tmp_path):
    import torch
    dec = init_decoder_params(torch.Generator().manual_seed(0), ModelConfig(**CFG))
    enc = {"embedding": {"weight": torch.randn(24, 16)}}
    opt = {"encoder": {"step": np.int32(3), "m": params_to_numpy(enc),
                       "v": params_to_numpy(enc)},
           "decoder": {"step": np.int32(3), "m": params_to_numpy(dec),
                       "v": params_to_numpy(dec)}}
    path = tmp_path / "ck.npz"
    tck.write_checkpoint(path, tck.build_checkpoint_host(
        2, {"encoder": enc, "decoder": dec}, opt, {"val_loss": [0.3]},
        best_val_loss=0.3, data_stats=STATS))
    got = jck.load_checkpoint(path)
    _assert_trees_equal(got["params"]["decoder"], params_to_numpy(dec))
    _assert_trees_equal(got["opt_states"]["decoder"], opt["decoder"])
    assert got["epoch"] == 2 and got["data_stats"]["alphabet"] == STATS["alphabet"]
    # and back into torch unchanged
    back = params_from_numpy(tck.load_checkpoint(path)["params"]["decoder"])
    for (_, a), (_, b) in zip(_leaves(params_to_numpy(back)), _leaves(params_to_numpy(dec))):
        np.testing.assert_array_equal(a, b)


def test_mlx_optimizer_state_conversion_matches_jax():
    rng = np.random.default_rng(0)
    state = {"step": np.int32(7), "learning_rate": np.float32(2e-4),
             "fc_out": {"weight": {"m": rng.standard_normal((3, 2)),
                                   "v": rng.standard_normal((3, 2))},
                        "bias": {"m": rng.standard_normal(3),
                                 "v": rng.standard_normal(3)}}}
    assert tck._is_mlx_optimizer_state(state) == jck._is_mlx_optimizer_state(state)
    _assert_trees_equal(tck._convert_mlx_optimizer_state(state),
                        jck._convert_mlx_optimizer_state(state))


@pytest.mark.parametrize("best,siblings", [(0, [10]), (3, [4]), (0, [])])
def test_stale_best_notice_matches_jax(tmp_path, best, siblings):
    for e in siblings:
        (tmp_path / f"checkpoint_epoch_{e:03d}.npz").touch()
    p = tmp_path / "checkpoint_best.npz"
    assert tck.stale_best_notice(p, best) == jck.stale_best_notice(p, best)
