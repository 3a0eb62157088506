"""The port's eval and design CLIs (``cli/encode.py``, ``cli/interpolate.py``,
``cli/optimize.py``) with ``--device cpu``, on a checkpoint the JAX package
wrote, beside the JAX CLIs on the same files.

Held: ``encode``'s ``mu`` and ``logvar`` within 1e-5 in f32 and 2e-2 of the
largest magnitude in bf16 (``tests/test_torch_encoder.py``'s tolerances),
the report's keys and ``active_units``, the TF=1 next-token accuracy within
0.01, and the greedy rows from ``z = mu`` against the JAX greedy decode
under the decoder's distributional contract (>= 99.0% of first tokens and
>= 97.0% of rows agree); ``interpolate``'s ``z_path`` within 1e-5 and its
tokens under the same contract; ``optimize``'s output keys and a falling
objective. The JAX CLIs run on the CPU with ``use_pallas`` off (their scan
paths); the port's run its kernels' plain versions.

The checkpoint's decoder weights are the JAX init scaled by 3, so the
greedy decodes differ from row to row (at the init scale every row decodes
to the same token) and the row contract has something to hold.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_vae_tpu.cli import encode as jencode
from mlx_vae_tpu.cli import interpolate as jinterpolate
from mlx_vae_tpu.cli import optimize as joptimize
from mlx_vae_tpu.cli.generate import make_generate_fn as jax_make_generate_fn
from mlx_vae_tpu.config import ModelConfig as JaxConfig
from mlx_vae_tpu.models.vae import ARCVAE as JaxARCVAE
from mlx_vae_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from mlx_vae_tpu.train.optim import adam_init as jax_adam_init
from mlx_vae_tpu_torch.cli import encode as tencode
from mlx_vae_tpu_torch.cli import interpolate as tinterpolate
from mlx_vae_tpu_torch.cli import optimize as toptimize
from mlx_vae_tpu_torch.data.prepare import make_synthetic_dataset

SHAPE = dict(vocab_size=24, embedding_dim=16, hidden_dim=32, latent_dim=8, num_conditions=1,
             num_layers=2)
L = 16
AGREE_FIRST, AGREE_ROWS = 0.99, 0.97
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are tiny, and the test runner's
    parallel workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 400-molecule corpus (split 320 / 40 / 40) and two JAX-written
    checkpoints of the tiny model, with and without a predictor head."""
    d = tmp_path_factory.mktemp("evalcli")
    data = d / "d.json"
    make_synthetic_dataset(n=400, vocab_size=24, max_length=L, seed=3, path=str(data))
    stats = {"properties_mean": [60.0], "properties_std": [25.0],
             "alphabet": json.loads(data.read_text()).get("alphabet")}
    out = {"data": str(data)}
    for name, with_pred in (("ck", False), ("ck_pred", True)):
        vae = JaxARCVAE(JaxConfig(**SHAPE), jax.random.PRNGKey(7), with_predictor=with_pred)
        params = dict(vae.params)
        params["decoder"] = jax.tree_util.tree_map(lambda a: 3.0 * a, params["decoder"])
        path = d / f"{name}.npz"
        jax_save_checkpoint(path, 0, params, {k: jax_adam_init(v) for k, v in params.items()},
                            {}, data_stats=stats)
        out[name] = str(path)
    return out


def _flags(parser):
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name", ["encode", "interpolate", "optimize"])
def test_flag_set_equals_jax_plus_device(name):
    port = _flags({"encode": tencode, "interpolate": tinterpolate,
                   "optimize": toptimize}[name].build_parser())
    ref = _flags({"encode": jencode, "interpolate": jinterpolate,
                  "optimize": joptimize}[name].build_parser())
    assert port.pop("device") == "cuda"
    assert port == ref


def _scaled_err(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-3)


def _agreement(a, b):
    return float((a[:, 0] == b[:, 0]).mean()), float((a == b).all(axis=1).mean())


def _jax_greedy(ck, mu, cond, dtype):
    """The JAX CLI's greedy decode from ``z = mu`` (its scan sampler on the
    CPU), which it scores but does not write out."""
    from mlx_vae_tpu.train.checkpoint import load_checkpoint
    params = load_checkpoint(ck)["params"]
    gen = jax_make_generate_fn(JaxConfig(compute_dtype=dtype, **SHAPE), params["decoder"],
                               False, L, 1.0, greedy=True)
    return np.asarray(gen(jnp.asarray(mu), jnp.asarray(cond), jax.random.PRNGKey(0)))


def _encode_pair(tmp_path, files, *extra):
    argv = ["--checkpoint", files["ck"], "--data", files["data"], *extra]
    jencode.main(argv + ["--output", str(tmp_path / "j.npz"),
                         "--report", str(tmp_path / "j.json")])
    res = tencode.main(argv + ["--device", "cpu", "--output", str(tmp_path / "t.npz"),
                               "--report", str(tmp_path / "t.json")])
    j, t = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    jr = json.loads((tmp_path / "j.json").read_text())
    tr = json.loads((tmp_path / "t.json").read_text())
    return j, t, jr, tr, res


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_jax_cli(tmp_path, files, dtype):
    j, t, jr, tr, res = _encode_pair(tmp_path, files, "--split", "train", "--batch_size", "128",
                                     "--compute_dtype", dtype)
    assert sorted(t.files) == sorted(j.files)
    assert t["mu"].shape == (320, SHAPE["latent_dim"])
    for k in ("mu", "logvar"):
        assert _scaled_err(t[k], j[k]) <= TOL[dtype], k
    for k in ("properties", "properties_normalized", "split"):
        np.testing.assert_array_equal(t[k], j[k])
    assert tr.keys() == jr.keys()
    assert tr["active_units"] == jr["active_units"]
    assert tr["num_molecules"] == jr["num_molecules"] == 320
    assert abs(tr["next_token_accuracy"] - jr["next_token_accuracy"]) <= 0.01
    # the greedy rows from z = mu: 320 rows against the JAX greedy decode
    want = _jax_greedy(files["ck"], j["mu"], j["properties_normalized"], dtype)
    first, rows = _agreement(res["decoded"], want)
    assert first >= AGREE_FIRST and rows >= AGREE_ROWS, (first, rows)
    assert len({r.tobytes() for r in want}) > 10  # the rows differ: the contract holds something
    assert abs(tr["token_accuracy"] - jr["token_accuracy"]) <= 0.03
    assert abs(tr["exact_match"] - jr["exact_match"]) <= 0.03


def test_encode_pad_and_trim_and_no_reconstruct(tmp_path, files):
    """``--split all --batch_size 37`` (400 rows: ten full batches and one
    of 30 padded with row 0) trims exactly; ``--no_reconstruct`` leaves the
    reconstruction keys out, as the JAX CLI does."""
    j, t, jr, tr, res = _encode_pair(tmp_path, files, "--split", "all", "--batch_size", "37",
                                     "--no_reconstruct")
    assert t["mu"].shape[0] == 400
    assert _scaled_err(t["mu"], j["mu"]) <= 1e-5
    assert tr.keys() == jr.keys() and "token_accuracy" not in tr
    assert "decoded" not in res
    whole = tencode.main(["--checkpoint", files["ck"], "--data", files["data"], "--split", "all",
                          "--batch_size", "400", "--no_reconstruct", "--device", "cpu",
                          "--output", str(tmp_path / "w.npz"),
                          "--report", str(tmp_path / "w.json")])
    np.testing.assert_allclose(res["mu"], whole["mu"], rtol=0, atol=1e-6)


def test_interpolate_matches_jax_cli(tmp_path, files):
    argv = ["--checkpoint", files["ck"], "--data", files["data"], "--split", "train",
            "--index_a", "3", "--index_b", "17", "--steps", "9"]
    jinterpolate.main(argv + ["--output", str(tmp_path / "j.json")])
    got = tinterpolate.main(argv + ["--device", "cpu", "--output", str(tmp_path / "t.json")])
    j = json.loads((tmp_path / "j.json").read_text())
    t = json.loads((tmp_path / "t.json").read_text())
    assert t == got and t.keys() == j.keys()
    np.testing.assert_allclose(np.asarray(t["z_path"]), np.asarray(j["z_path"]),
                               rtol=1e-5, atol=1e-5)
    assert t["endpoint_tokens"] == j["endpoint_tokens"]
    first, rows = _agreement(np.asarray(t["tokens"]), np.asarray(j["tokens"]))
    assert first >= AGREE_FIRST and rows >= AGREE_ROWS, (first, rows)
    assert np.asarray(t["tokens"]).shape == (9, L)


@pytest.mark.parametrize("argv", [["--index_b", "99999"], ["--index_a", "-1"],
                                  ["--steps", "1"]])
def test_interpolate_refusals_match_jax(files, argv, capsys):
    base = ["--checkpoint", files["ck"], "--data", files["data"], *argv]
    for main, extra in ((tinterpolate.main, ["--device", "cpu"]), (jinterpolate.main, [])):
        with pytest.raises(SystemExit):
            main(base + extra)
    err = [line for line in capsys.readouterr().err.splitlines() if "error:" in line]
    assert len(err) == 2 and err[0] == err[1].replace("interpolate.py", err[0].split(":")[0])


def test_optimize_keys_and_falling_objective(tmp_path, files):
    argv = ["--checkpoint", files["ck_pred"], "--target", "90", "--num_molecules", "24",
            "--opt_steps", "40", "--max_length", str(L), "--seed", "7"]
    joptimize.main(argv + ["--output", str(tmp_path / "j.json")])
    got = toptimize.main(argv + ["--device", "cpu", "--output", str(tmp_path / "t.json")])
    j = json.loads((tmp_path / "j.json").read_text())
    t = json.loads((tmp_path / "t.json").read_text())
    assert t.keys() == j.keys()
    assert t["objective_final"] < t["objective_first"]
    assert np.asarray(t["tokens"]).shape == (24, L)
    assert np.abs(np.asarray(t["z_optimized"])).max() <= 3.0
    assert got["objective"].shape == (41,)
    # the same descent from the port's z0, through the JAX optimizer
    from mlx_vae_tpu.models.latent_opt import optimize_latent
    from mlx_vae_tpu.train.checkpoint import load_checkpoint
    params = load_checkpoint(files["ck_pred"])["params"]
    target = (np.float32(90.0) - 60.0) / 25.0
    jz, info = optimize_latent(params, JaxConfig(**SHAPE), jnp.asarray(got["z0"]),
                               jnp.asarray([target], jnp.float32), steps=40)
    np.testing.assert_allclose(np.asarray(t["z_optimized"]), np.asarray(jz), atol=1e-5)
    np.testing.assert_allclose(got["objective"], np.asarray(info["objective"]), atol=1e-5)


def test_optimize_refuses_a_checkpoint_without_predictor(files):
    argv = ["--checkpoint", files["ck"], "--target", "90", "--num_molecules", "8",
            "--opt_steps", "5", "--no_normalize"]
    with pytest.raises(SystemExit) as got:
        toptimize.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as want:
        joptimize.main(argv)
    assert "predictor" in str(got.value) and str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["encode", "interpolate", "optimize"])
def test_cuda_device_without_a_card_exits(files, name):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    main = {"encode": tencode, "interpolate": tinterpolate, "optimize": toptimize}[name].main
    with pytest.raises(SystemExit, match="CUDA is not available"):
        main(["--checkpoint", files["ck_pred"], "--data", files["data"]])


def test_encode_data_parallel_exits(files, tmp_path):
    """--data_parallel on one device (no process group, no card) encodes
    there, as the JAX CLI does when it forms no mesh: the same arrays as
    without the flag."""
    argv = ["--checkpoint", files["ck"], "--data", files["data"], "--device", "cpu",
            "--report", str(tmp_path / "r.json")]
    one = tencode.main(argv + ["--output", str(tmp_path / "a.npz")])
    dp = tencode.main(argv + ["--output", str(tmp_path / "b.npz"), "--data_parallel"])
    for k in ("mu", "logvar", "next_tokens", "decoded"):
        np.testing.assert_array_equal(dp[k], one[k], err_msg=k)
