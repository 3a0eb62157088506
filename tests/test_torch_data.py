"""The port's corpus feed against the JAX package's: the same split, padded
matrices, stats and batches from the same inputs (exact equality: the code
is a copy and the arithmetic is numpy's), the native packer against numpy,
the dataset-prep CLI on the same SMILES and the same drug-like corpus, the
``--data`` stats of the generation CLIs, and the generation metrics that
need the training split (novelty, molecule-level metrics)."""

import json

import numpy as np
import pytest

from mlx_vae_tpu.cli.common import resolve_property_stats as jax_resolve
from mlx_vae_tpu.data import metrics as jmetrics
from mlx_vae_tpu.data import packer as jpacker
from mlx_vae_tpu.data import prepare as jprepare
from mlx_vae_tpu.data import split as jsplit
from mlx_vae_tpu_torch.cli.common import resolve_property_stats
from mlx_vae_tpu_torch.data import metrics, packer, prepare, split
from mlx_vae_tpu_torch.data.dataset import MoleculeDataset
from mlx_vae_tpu_torch.utils.prefetch import prefetch_to_device


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "syn.json"
    prepare.make_synthetic_dataset(n=301, vocab_size=24, max_length=12, path=str(path))
    return str(path)


@pytest.fixture(scope="module")
def drug_like(tmp_path_factory):
    """A 40-molecule drug-like SELFIES corpus written by each package's
    prepare CLI."""
    tmp = tmp_path_factory.mktemp("drug")
    prepare.main(["--drug_like", "40", "--output", str(tmp / "t.json"), "--seed", "3"])
    jprepare.main(["--drug_like", "40", "--output", str(tmp / "j.json"), "--seed", "3"])
    return tmp


@pytest.mark.parametrize("n", [10, 101, 20523])
def test_split_indices_equal_jax(n):
    for a, b in zip(split.split_indices(n), jsplit.split_indices(n)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("keys", [("tpsa",), ("tpsa", "logp", "mw")])
def test_load_and_split_equals_jax(corpus, keys):
    port = split.load_and_split(corpus, property_keys=keys)
    ref = jsplit.load_and_split(corpus, property_keys=keys)
    assert port[3] == ref[3]
    for t, j in zip(port[:3], ref[:3]):
        assert len(t) == len(j) and t.max_length == j.max_length
        for attr in ("molecules", "properties", "properties_mean", "properties_std",
                     "properties_normalized"):
            a, b = getattr(t, attr), getattr(j, attr)
            assert a.dtype == b.dtype, attr
            np.testing.assert_array_equal(a, b, err_msg=attr)


@pytest.mark.parametrize("batch,drop_last", [(32, False), (32, True), (7, False)])
def test_batches_equal_jax(corpus, batch, drop_last):
    t, j = split.load_and_split(corpus)[0], jsplit.load_and_split(corpus)[0]
    for shuffle in (False, True):
        trng, jrng = np.random.default_rng(11), np.random.default_rng(11)
        for _ in range(2):  # consecutive epochs draw on from the same rng
            tb = list(t.to_batches(batch, shuffle=shuffle, rng=trng, drop_last=drop_last))
            jb = list(j.to_batches(batch, shuffle=shuffle, rng=jrng, drop_last=drop_last))
            ti = list(t.to_index_batches(batch, shuffle=False, drop_last=drop_last))
            assert len(tb) == len(jb) == len(ti)
            for (tm, tc), (jm, jc) in zip(tb, jb):
                np.testing.assert_array_equal(tm, jm)
                np.testing.assert_array_equal(tc, jc)
            if not shuffle:
                for (tm, _), idx in zip(tb, ti):
                    np.testing.assert_array_equal(tm, t.molecules[idx])


SEQS = [[1, 2, 3], [4, 5], list(range(20)), [], [7] * 12]


def test_packer_native_and_numpy_equal_jax(monkeypatch):
    assert packer._get_lib() is not None, "g++ builds native/packer.cpp"
    ref = jpacker.pack_sequences_numpy(SEQS, max_length=8, pad_token=0)
    native = packer.pack_sequences(SEQS, max_length=8, pad_token=0)
    monkeypatch.setattr(packer, "_get_lib", lambda: None)
    fallback = packer.pack_sequences(SEQS, max_length=8, pad_token=0)
    for a in (native, fallback, packer.pack_sequences_numpy(SEQS, 8, 0)):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, ref)
    assert list(ref[0]) == [1, 2, 3, 0, 0, 0, 0, 0]


def test_gather_rows_native_and_numpy(monkeypatch):
    data = np.arange(20, dtype=np.int32).reshape(5, 4)
    idx = np.array([3, 0, 3])
    np.testing.assert_array_equal(packer.gather_rows(data, idx), data[idx])
    monkeypatch.setattr(packer, "_get_lib", lambda: None)
    np.testing.assert_array_equal(packer.gather_rows(data, idx), data[idx])


def test_std_floor_and_train_stats():
    seqs = [[1, 2], [3, 4], [5, 6]]
    props = np.array([[10.0, 5.0], [20.0, 5.0], [30.0, 5.0]], np.float32)
    ds = MoleculeDataset(seqs, props, max_length=4)
    assert ds.properties_std[0, 1] == 1.0
    val = MoleculeDataset(seqs, props + 100.0, 4, properties_mean=ds.properties_mean,
                          properties_std=ds.properties_std)
    assert val.properties_normalized[0, 0] > 5.0


def test_prepare_from_smiles_equals_jax(tmp_path):
    smiles = ["CCO", "c1ccccc1O", "CC(=O)Nc1ccc(O)cc1", "not a smiles", "CCN(CC)CC"]
    t = prepare.prepare_from_smiles(smiles, max_length=32, path=str(tmp_path / "t.json"))
    j = jprepare.prepare_from_smiles(smiles, max_length=32)
    assert t == j
    assert json.loads((tmp_path / "t.json").read_text()) == t
    assert len(t["tokenized_sequences"]) == 4  # the bad SMILES is skipped


def test_drug_like_cli_equals_jax(drug_like):
    t = json.loads((drug_like / "t.json").read_text())
    assert t == json.loads((drug_like / "j.json").read_text())
    assert len(t["tokenized_sequences"]) == 40 and t["max_length"] == 64
    assert t["alphabet"][:3] == ["<pad>", "<start>", "<eos>"]


def test_synthetic_and_smiles_cli_equal_jax(tmp_path):
    args = ["--synthetic", "50", "--vocab_size", "30", "--max_length", "16", "--seed", "2"]
    prepare.main(args + ["--output", str(tmp_path / "t.json")])
    jprepare.main(args + ["--output", str(tmp_path / "j.json")])
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    (tmp_path / "s.smi").write_text("CCO\nc1ccncc1\n\nCC(C)O\n")
    for mod, out in ((prepare, "ts.json"), (jprepare, "js.json")):
        mod.main(["--smiles", str(tmp_path / "s.smi"), "--output", str(tmp_path / out)])
    assert (tmp_path / "ts.json").read_text() == (tmp_path / "js.json").read_text()
    with pytest.raises(SystemExit):
        prepare.main(["--output", str(tmp_path / "x.json")])


@pytest.mark.parametrize("num_conditions,no_normalize", [(1, False), (3, False), (1, True)])
def test_resolve_property_stats_with_data_equals_jax(corpus, num_conditions, no_normalize):
    ckpt = {"data_stats": {"alphabet": ["a", "b"], "properties_mean": None}}
    t = resolve_property_stats(corpus, no_normalize, ckpt, num_conditions)
    j = jax_resolve(corpus, no_normalize, ckpt, num_conditions)
    for a, b in zip(t[:2], j[:2]):
        np.testing.assert_array_equal(a, b)
    assert t[2] == j[2] == json.loads(open(corpus).read())["alphabet"]
    np.testing.assert_array_equal(t[3].molecules, j[3].molecules)


def test_resolve_property_stats_alphabet_from_data(drug_like):
    path = str(drug_like / "t.json")
    t = resolve_property_stats(path, False, {}, 1)
    j = jax_resolve(path, False, {}, 1)
    assert t[2] == j[2] == json.loads((drug_like / "t.json").read_text())["alphabet"]
    np.testing.assert_array_equal(t[0], j[0])


def test_resolve_property_stats_missing_data_file(tmp_path):
    with pytest.raises(FileNotFoundError, match="does not exist"):
        resolve_property_stats(str(tmp_path / "none.json"), False, {}, 1)


def test_novelty_equals_jax(corpus):
    train = split.load_and_split(corpus)[0]
    rng = np.random.default_rng(0)
    gen = np.concatenate([train.molecules[:30],  # not novel
                          rng.integers(3, 24, (40, 12)).astype(np.int32)])
    gen[::7, 4] = 2  # EOS mid-row: rows that differ after it are one molecule
    got = metrics.novelty(gen, train.molecules)
    assert got == jmetrics.novelty(gen, train.molecules)
    assert 0.0 < got < 1.0
    assert metrics.novelty(gen[:0], train.molecules) == 0.0


def test_molecule_metrics_equal_jax(drug_like):
    data = json.loads((drug_like / "t.json").read_text())
    alphabet = data["alphabet"]
    toks = jpacker.pack_sequences_numpy(data["tokenized_sequences"], 64, 0)
    toks[5, 3:] = 0  # a truncated row
    t = metrics.molecule_metrics(toks, alphabet, target_tpsa=90.0, sample=30)
    j = jmetrics.molecule_metrics(toks, alphabet, target_tpsa=90.0, sample=30)
    assert t == j and t["sampled"] == 30 and t["decoded"] > 0
    assert metrics.molecule_metrics(toks, [], target_tpsa=90.0) is None
    assert [m.weight() for m in metrics.decoded_mols(toks[:6], alphabet)] == \
        [m.weight() for m in jmetrics.decoded_mols(toks[:6], alphabet)]


@pytest.mark.parametrize("size", [1, 2, 5])
def test_prefetch_keeps_order_and_structure(corpus, size):
    """The host feed yields every batch once, in order, as tensors (tuples
    stay tuples), whatever its look-ahead."""
    import torch

    train = split.load_and_split(corpus)[0]
    want = list(train.to_batches(32, shuffle=False))
    got = list(prefetch_to_device(iter(want), size=size, device="cpu"))
    assert len(got) == len(want) == 8
    for (gm, gc), (wm, wc) in zip(got, want):
        assert isinstance(gm, torch.Tensor) and gm.dtype == torch.int32
        np.testing.assert_array_equal(gm.numpy(), wm)
        np.testing.assert_array_equal(gc.numpy(), wc)
    assert [t.shape[0] for t in prefetch_to_device([np.zeros(3), np.zeros(4)])] == [3, 4]
