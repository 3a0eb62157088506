"""Host-side dataset of tokenized molecules + properties.

Capability parity with the reference ``MoleculeDataset``
(``reference/mlx_data/dataloader.py:1-111``): z-score property
normalization with train-set stats reused for val/test, std floor (<1e-8 ->
1.0), pad/truncate to ``max_length`` with ``pad_token``, shuffled batch
generator.

TPU-first differences:

* All sequences are padded **once** into a single ``[N, max_length] int32``
  array at construction (the reference re-pads Python lists per ``__getitem__``,
  ``dataloader.py:70-84``).
* ``to_batches`` yields contiguous **numpy** slices; device transfer happens
  in the trainer via a double-buffered prefetcher so host->HBM copies overlap
  compute.
* A native C++ packer (``native/packer.cpp``) accelerates the one remaining
  host hot loop (ragged list -> padded matrix); pure-numpy fallback otherwise.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from mlx_vae_tpu_torch.data import packer


class MoleculeDataset:
    def __init__(
        self,
        tokenized_molecules: list,
        properties: np.ndarray,
        max_length: int = 120,
        pad_token: int = 0,
        properties_mean: Optional[np.ndarray] = None,
        properties_std: Optional[np.ndarray] = None,
    ):
        self.max_length = int(max_length)
        self.pad_token = int(pad_token)

        # Pad/truncate every sequence up front into one dense int32 matrix.
        self.molecules = packer.pack_sequences(
            tokenized_molecules, self.max_length, self.pad_token
        )

        self.properties = np.asarray(properties, dtype=np.float32)
        if self.properties.ndim == 1:
            self.properties = self.properties[:, None]

        if properties_mean is not None and properties_std is not None:
            # Stats handed down from the training split
            # (reference ``train.py:108-124``).
            self.properties_mean = np.asarray(properties_mean, dtype=np.float32)
            self.properties_std = np.asarray(properties_std, dtype=np.float32)
        else:
            self.properties_mean = self.properties.mean(axis=0, keepdims=True)
            self.properties_std = self.properties.std(axis=0, keepdims=True)

        if self.properties_mean.ndim == 1:
            self.properties_mean = self.properties_mean[None, :]
        if self.properties_std.ndim == 1:
            self.properties_std = self.properties_std[None, :]

        # Std floor (reference ``dataloader.py:56-60``).
        self.properties_std = np.where(self.properties_std < 1e-8, 1.0, self.properties_std)

        self.properties_normalized = (
            (self.properties - self.properties_mean) / self.properties_std
        ).astype(np.float32)

    def __len__(self) -> int:
        return self.molecules.shape[0]

    def __getitem__(self, idx: int) -> dict:
        return {
            "molecule": self.molecules[idx],
            "properties": self.properties_normalized[idx],
        }

    def to_batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        rng: Optional[np.random.Generator] = None,
        drop_last: bool = False,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield ``(molecules [B, L] int32, properties [B, C] f32)`` batches.

        Like the reference generator (``dataloader.py:86-111``) the final
        partial batch is yielded (unless ``drop_last``); the jitted train step
        simply compiles once more for the remainder shape.
        """
        for batch_idx in self.to_index_batches(batch_size, shuffle=shuffle,
                                               rng=rng, drop_last=drop_last):
            yield (
                np.ascontiguousarray(self.molecules[batch_idx]),
                np.ascontiguousarray(self.properties_normalized[batch_idx]),
            )

    def to_index_batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        rng: Optional[np.random.Generator] = None,
        drop_last: bool = False,
    ) -> Iterator[np.ndarray]:
        """Yield the ``[B] int32`` index arrays behind ``to_batches`` —
        identical RNG consumption and batch composition (``to_batches`` is
        implemented on top of this, so the two can never desynchronize),
        but the data stays wherever it lives (used by the device-resident
        feed: the trainer ships 16KB of indices per batch instead of
        megabytes of tokens through the host<->device link)."""
        n = len(self)
        indices = np.arange(n)
        if shuffle:
            (rng or np.random).shuffle(indices)
        end = (n // batch_size) * batch_size if drop_last else n
        for i in range(0, end, batch_size):
            yield np.ascontiguousarray(indices[i : i + batch_size],
                                       dtype=np.int32)
