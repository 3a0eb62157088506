"""Sample-quality metrics on token rows: canonical identity and uniqueness.

Copied from ``mlx_vae_tpu/data/metrics.py`` (see ``data/prepare.py`` of this
package for why host code is copied). Novelty and the molecule-level metrics
are not copied yet.
"""

from __future__ import annotations

from typing import Iterable, Set

import numpy as np

from mlx_vae_tpu_torch.data.prepare import EOS, _SPECIALS

_NUM_SPECIALS = len(_SPECIALS)


def canonical_tokens(tokens, end_token: int = EOS,
                     num_specials: int = _NUM_SPECIALS) -> np.ndarray:
    """Canonicalize ``[B, L]`` token rows to ``[B, L] int32``.

    Each row's non-special tokens before its first ``end_token`` are
    left-compacted in order; remaining positions are -1 (never a token id).
    Two rows encode the same molecule iff their canonical rows are equal.
    A row with no kept tokens (immediate EOS, or all specials) canonicalizes
    to all -1 — the "empty molecule", still one identity.
    """
    a = np.asarray(tokens, dtype=np.int32)
    if a.ndim != 2:
        raise ValueError(f"expected [B, L] token matrix, got shape {a.shape}")
    ended = np.cumsum(a == end_token, axis=1) > 0  # at and after first EOS
    keep = (~ended) & (a >= num_specials)
    # Stable left-compaction: kept positions first, original order preserved.
    order = np.argsort(~keep, axis=1, kind="stable")
    comp = np.take_along_axis(a, order, axis=1)
    kept_mask = np.sort(keep, axis=1)[:, ::-1]  # first-k-true per row
    comp[~kept_mask] = -1
    return comp


def _keys(canon: np.ndarray) -> Iterable[bytes]:
    """Hashable per-row identities of a canonical matrix."""
    return (row.tobytes() for row in np.ascontiguousarray(canon))


def _key_set(tokens, end_token: int, num_specials: int) -> Set[bytes]:
    return set(_keys(canonical_tokens(tokens, end_token, num_specials)))


def uniqueness(tokens, end_token: int = EOS,
               num_specials: int = _NUM_SPECIALS) -> float:
    """Distinct molecules / total rows, in (0, 1]. Empty input -> 0.0."""
    a = np.asarray(tokens)
    if a.shape[0] == 0:
        return 0.0
    from mlx_vae_tpu_torch.data import postproc
    mat = postproc.as_token_matrix(a)
    if mat is not None:
        canon = postproc.canonicalize(mat, end_token, num_specials)
        if canon is not None:
            count = postproc.unique_count(canon)
            if count is not None:
                return count / a.shape[0]
    return len(_key_set(a, end_token, num_specials)) / a.shape[0]
