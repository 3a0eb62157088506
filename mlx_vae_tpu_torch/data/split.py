"""Dataset loading and the fixed seed-67 / 80-10-10 split.

Bit-identical reproduction of the reference's split logic
(``reference/train.py:75-124``): seed the *global* numpy RNG with 67,
``np.random.shuffle`` an index array, slice 80/10/10, build the train dataset
first so its normalization stats flow into val/test.
"""

from __future__ import annotations

import json
from typing import Tuple

import numpy as np

from mlx_vae_tpu_torch.data.dataset import MoleculeDataset


def split_indices(n_total: int, seed: int = 67,
                  train_split: float = 0.8, val_split: float = 0.1):
    """Return (train_idx, val_idx, test_idx) exactly as ``train.py:85-96``."""
    np.random.seed(seed)
    indices = np.arange(n_total)
    np.random.shuffle(indices)
    n_train = int(train_split * n_total)
    n_val = int(val_split * n_total)
    return (
        indices[:n_train],
        indices[n_train : n_train + n_val],
        indices[n_train + n_val :],
    )


def load_and_split(
    data_path: str,
    seed: int = 67,
    property_keys: Tuple[str, ...] = ("tpsa",),
) -> Tuple[MoleculeDataset, MoleculeDataset, MoleculeDataset, dict]:
    """Load the dataset JSON and build the three splits.

    JSON schema (inferred from ``reference/train.py:79-87``)::

        {"molecules": [{"tpsa": float, ...}, ...],
         "tokenized_sequences": [[int, ...], ...],
         "max_length": int}

    ``property_keys`` extends the reference's TPSA-only conditioning to
    multi-property (e.g. ``("tpsa", "logp", "mw")`` per BASELINE.json config 3).
    """
    with open(data_path) as f:
        data = json.load(f)

    properties = np.array(
        [[mol[k] for k in property_keys] for mol in data["molecules"]],
        dtype=np.float32,
    )
    sequences = data["tokenized_sequences"]

    train_idx, val_idx, test_idx = split_indices(len(sequences), seed=seed)

    train_ds = MoleculeDataset(
        tokenized_molecules=[sequences[i] for i in train_idx],
        properties=properties[train_idx],
        max_length=data["max_length"],
        pad_token=0,
    )
    kw = dict(
        max_length=data["max_length"],
        pad_token=0,
        properties_mean=train_ds.properties_mean,
        properties_std=train_ds.properties_std,
    )
    val_ds = MoleculeDataset(
        tokenized_molecules=[sequences[i] for i in val_idx],
        properties=properties[val_idx], **kw,
    )
    test_ds = MoleculeDataset(
        tokenized_molecules=[sequences[i] for i in test_idx],
        properties=properties[test_idx], **kw,
    )
    return train_ds, val_ds, test_ds, data
