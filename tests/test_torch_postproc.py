"""The port's native generation post-processor (``data/postproc.py``, the
ctypes bridge to ``native/postproc.cpp``) against its numpy path and the
JAX package's bridge, exactly, on ``tests/test_postproc.py``'s randomized
token matrices and edge rows (immediate EOS, no EOS, all pad, all
specials, duplicate molecules); and without the library
(``MLX_VAE_TPU_TORCH_NO_NATIVE=1``, or the loader patched to None) every
entry point returns None while its callers give the same numbers."""

import numpy as np
import pytest

from mlx_vae_tpu.data import postproc as jpost
from mlx_vae_tpu_torch.data import postproc as tpost
from mlx_vae_tpu_torch.data.metrics import _key_set, canonical_tokens, novelty, uniqueness
from mlx_vae_tpu_torch.data.prepare import EOS, selfies_validity
from mlx_vae_tpu_torch.utils import native as tnative
from test_postproc import _python_validity, _random_tokens


@pytest.fixture
def native():
    """Both packages' libraries, built on first use (skips without g++)."""
    if tpost._lib() is None or jpost._lib() is None:
        pytest.skip("no native toolchain")


def test_port_builds_into_its_own_cache(native):
    """The port's loader builds the repo-root source into its own cache
    directory, not the JAX package's."""
    so = tnative._so_path(tpost._SRC)
    assert so.parent.name == "mlx_vae_tpu_torch" and so.exists()
    assert tpost._SRC == jpost._SRC


@pytest.mark.usefixtures("native")
@pytest.mark.parametrize("n,L", [(1, 1), (7, 3), (64, 20), (301, 61)])
def test_canonicalize_equals_numpy_and_jax(n, L):
    a = _random_tokens(np.random.default_rng(n * 1000 + L), n, L)
    got = tpost.canonicalize(a, EOS, 3)
    np.testing.assert_array_equal(got, canonical_tokens(a))
    np.testing.assert_array_equal(got, jpost.canonicalize(a, EOS, 3))


@pytest.mark.usefixtures("native")
@pytest.mark.parametrize("n,L", [(1, 1), (64, 20), (500, 33)])
def test_unique_count_equals_numpy_and_jax(n, L):
    a = _random_tokens(np.random.default_rng(n + L), n, L)
    canon = tpost.canonicalize(a, EOS, 3)
    assert tpost.unique_count(canon) == len(_key_set(a, EOS, 3)) == jpost.unique_count(canon)


@pytest.mark.usefixtures("native")
def test_novel_counts_equal_numpy_sets_and_jax():
    rng = np.random.default_rng(7)
    gen = _random_tokens(rng, 200, 16)
    ref = _random_tokens(rng, 150, 16)
    ref[:50] = gen[:50]  # guarantee overlap
    gc, rc = tpost.canonicalize(gen, EOS, 3), tpost.canonicalize(ref, EOS, 3)
    gk, rk = _key_set(gen, EOS, 3), _key_set(ref, EOS, 3)
    assert tpost.novel_counts(gc, rc) == (len(gk), len(gk - rk)) == jpost.novel_counts(gc, rc)


@pytest.mark.usefixtures("native")
@pytest.mark.parametrize("n,L", [(1, 1), (64, 20), (333, 17)])
def test_validity_count_equals_python_loop_and_jax(n, L):
    a = _random_tokens(np.random.default_rng(n * 7 + L), n, L)
    got = tpost.validity_count(a, EOS)
    assert got / n == _python_validity(a)
    assert got == jpost.validity_count(a, EOS)


@pytest.mark.usefixtures("native")
def test_uint8_tokens_take_the_native_path():
    a = _random_tokens(np.random.default_rng(3), 50, 9).astype(np.uint8)
    assert uniqueness(a) == uniqueness(a.astype(np.int32))
    assert selfies_validity(a, []) == _python_validity(a)


def _metrics(rng_seed=11):
    rng = np.random.default_rng(rng_seed)
    gen, ref = _random_tokens(rng, 120, 14), _random_tokens(rng, 80, 14)
    return gen, ref, (uniqueness(gen), novelty(gen, ref), selfies_validity(gen, []))


def _entries_return_none(gen, ref):
    canon = canonical_tokens(gen)
    assert tpost.validity_count(gen.astype(np.int32), EOS) is None
    assert tpost.canonicalize(gen.astype(np.int32), EOS, 3) is None
    assert tpost.unique_count(canon) is None
    assert tpost.novel_counts(canon, canonical_tokens(ref)) is None


@pytest.mark.usefixtures("native")
def test_no_native_env_gives_none_and_the_same_metrics(monkeypatch):
    """``MLX_VAE_TPU_TORCH_NO_NATIVE=1`` (read at the first load, so the
    loader's per-process cache is emptied first)."""
    gen, ref, with_native = _metrics()
    monkeypatch.setattr(tnative, "_cache", {})
    monkeypatch.setenv("MLX_VAE_TPU_TORCH_NO_NATIVE", "1")
    assert tpost._lib() is None
    _entries_return_none(gen, ref)
    assert (uniqueness(gen), novelty(gen, ref), selfies_validity(gen, [])) == with_native


@pytest.mark.usefixtures("native")
def test_loader_patched_away_gives_none_and_the_same_metrics(monkeypatch):
    gen, ref, with_native = _metrics(12)
    monkeypatch.setattr(tpost, "_lib", lambda: None)
    _entries_return_none(gen, ref)
    assert (uniqueness(gen), novelty(gen, ref), selfies_validity(gen, [])) == with_native


def test_ragged_input_uses_python_path():
    rows = [[1, 5, EOS], [4, 4, 4, 4, EOS, 0], [EOS]]
    assert tpost.as_token_matrix(rows) is None
    assert selfies_validity(rows, []) == pytest.approx(2 / 3)
