"""Sample-quality metrics for generated molecules (uniqueness / novelty).

The reference reports no sample-quality metrics at all — its generation path
ends at raw token arrays (``reference/models/decoder_sampling.py:126-128``).
These are the standard generative-chemistry metrics (MOSES-benchmark
conventions) computed on token sequences, complementing the validity fraction
in ``data/prepare.py:selfies_validity``:

* **uniqueness** — fraction of distinct molecules among the generated batch.
* **novelty** — fraction of the distinct generated molecules that do not
  appear in the training set (computed over the *unique* set, per MOSES, so
  mode-collapsing onto one novel molecule cannot score 100%).

A molecule's identity is its canonical token content: non-special tokens
strictly before the first EOS. Rows that differ only after EOS (the sampler
pads there — ``models/sampling.py:73``), or only in pad/start placement,
are the same molecule. Neither metric is gated on validity — validity is
reported separately; document both when comparing models.

All-host: metrics run once per CLI invocation on the final token matrix,
outside any timed region, so there is nothing to jit. At the 1M-molecule
bulk scale the per-row work routes to the native post-processor
(``data/postproc.py`` / ``native/postproc.cpp``) when a toolchain is
available; the numpy implementations below are the fallback AND the parity
oracle (``tests/test_postproc.py``).
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


def novelty(tokens, reference_tokens, end_token: int = EOS,
            num_specials: int = _NUM_SPECIALS) -> float:
    """Fraction of the DISTINCT generated molecules absent from
    ``reference_tokens`` (typically the training split's padded token
    matrix, ``MoleculeDataset.molecules``). Empty input -> 0.0.

    Canonicalization makes differing pad widths between the two matrices
    irrelevant (trailing -1 padding only extends to each matrix's own L;
    keys compare by content, so rows are re-padded to a common width here).
    """
    gen = np.asarray(tokens)
    ref = np.asarray(reference_tokens)
    if gen.shape[0] == 0:
        return 0.0
    width = max(gen.shape[1], ref.shape[1] if ref.size else 0)

    def pad_to(m, w):
        if m.shape[1] == w:
            return m
        out = np.full((m.shape[0], w), -1, np.int32)
        out[:, : m.shape[1]] = m
        return out

    from mlx_vae_tpu_torch.data import postproc
    gm, rm = postproc.as_token_matrix(gen), postproc.as_token_matrix(ref)
    if gm is not None and (rm is not None or not ref.size):
        gc = postproc.canonicalize(gm, end_token, num_specials)
        rc = (postproc.canonicalize(rm, end_token, num_specials)
              if rm is not None else np.empty((0, gm.shape[1]), np.int32))
        if gc is not None and rc is not None:
            counts = postproc.novel_counts(
                np.ascontiguousarray(pad_to(gc, width)),
                np.ascontiguousarray(pad_to(rc, width)))
            if counts is not None:
                distinct, novel = counts
                return novel / distinct

    gen_keys = set(_keys(pad_to(canonical_tokens(gen, end_token, num_specials), width)))
    ref_keys = set(_keys(pad_to(canonical_tokens(ref, end_token, num_specials), width))) if ref.size else set()
    return len(gen_keys - ref_keys) / len(gen_keys)


def decoded_mols(tokens, alphabet):
    """Yield a perceived ``Mol`` for every token row that decodes to a
    molecule; rows that don't decode are skipped.

    THE shared decode kernel for every consumer that scores generated
    token rows chemically (``molecule_metrics`` below and the
    conditioning-fidelity / latent-opt / prior-mismatch benchmark
    pipelines): SELFIES decoding emits kekulized structures with no
    aromatic flags, and the Ertl TPSA table distinguishes aromatic N/O
    contributions by aromatic bond, so aromaticity perception must run
    before any descriptor — centralized here so the pipelines cannot
    diverge on that subtlety.
    """
    from mlx_vae_tpu_torch.chem import selfies_to_mol
    from mlx_vae_tpu_torch.chem.smiles import perceive_aromaticity
    from mlx_vae_tpu_torch.data.prepare import decode_tokens
    for row in tokens:
        s = decode_tokens(row, alphabet)
        mol = selfies_to_mol(s) if s else None
        if mol is None:
            continue
        perceive_aromaticity(mol)
        yield mol


def molecule_metrics(tokens, alphabet, target_tpsa=None,
                     sample: int = 20000, seed: int = 0):
    """Molecule-LEVEL metrics via the chemistry backend, on a
    deterministic sample of rows (full decode of 1M rows would dominate
    the bulk-generation wall clock; ``sample`` rows at ~0.5 ms each is a
    bounded few seconds).

    Token-level uniqueness (above) treats distinct SELFIES encodings as
    distinct; two different token rows can decode to the SAME molecule
    (SELFIES is many-to-one), so this computes uniqueness over canonical
    SMILES, plus Ertl-TPSA statistics of the decoded molecules — the real
    conditioning-fidelity measure when ``target_tpsa`` is the generation
    target (the reference conditions on TPSA,
    ``reference/train.py:79-87``).

    Returns None when no chemistry backend is wired or the alphabet has
    no atom symbols (synthetic corpora); otherwise a dict with
    ``sampled``, ``decoded`` (rows decoding to a non-empty molecule),
    ``mol_uniqueness``, ``tpsa_mean``, ``tpsa_std`` and — given a target —
    ``tpsa_mae``.
    """
    from mlx_vae_tpu_torch.data import prepare as prep
    if not prep.selfies_available() or not alphabet:
        return None
    from mlx_vae_tpu_torch.chem import selfies_codec as sc
    if sc.KIND_ATOM not in sc.classify_symbols(list(alphabet))[0]:
        return None
    from mlx_vae_tpu_torch.chem import mol_to_smiles, tpsa

    a = np.asarray(tokens)
    if a.ndim != 2 or a.shape[0] == 0:
        return None
    n = a.shape[0]
    if n > sample:
        idx = np.random.default_rng(seed).choice(n, size=sample,
                                                 replace=False)
        a = a[np.sort(idx)]
    smiles_seen = set()
    tpsas = []
    decoded = 0
    for mol in decoded_mols(a, alphabet):
        decoded += 1
        smiles_seen.add(mol_to_smiles(mol))
        tpsas.append(tpsa(mol))
    out = {
        "sampled": int(a.shape[0]),
        "decoded": decoded,
        "mol_uniqueness": (len(smiles_seen) / decoded) if decoded else 0.0,
    }
    if tpsas:
        t = np.asarray(tpsas)
        out["tpsa_mean"] = float(t.mean())
        out["tpsa_std"] = float(t.std())
        if target_tpsa is not None:
            out["tpsa_mae"] = float(np.abs(t - target_tpsa).mean())
            out["tpsa_target"] = float(target_tpsa)
    return out
