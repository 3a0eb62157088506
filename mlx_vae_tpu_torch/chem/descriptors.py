"""Molecular descriptors: TPSA, molecular weight, approximate LogP.

Fills the role of ``rdkit.Chem.Descriptors`` in the reference's data
pipeline (``reference/mlx_data/dataloader.py:39-65`` reads
``tpsa`` per molecule; the prep tool also records logp/mw).

* ``tpsa`` — the Ertl topological polar surface area (Ertl, Rohde &
  Selzer, *J. Med. Chem.* 2000, 43, 3714): sum of published fragment
  contributions over N and O environments, with the paper's fallback
  formula for unmatched environments. This matches rdkit's default
  ``TPSA()`` semantics (N/O only, no S/P terms) — golden-value tests
  against well-known molecules are in ``tests/test_chem.py``.
* ``mol_weight`` — exact average-isotope molecular weight.
* ``clogp`` — an atom-contribution LogP in the spirit of
  Wildman & Crippen (1999) with a REDUCED type table (~25 environment
  classes instead of 68). Accurate to roughly ±1 log unit on drug-like
  molecules; do not expect bitwise rdkit ``MolLogP`` parity. Used only
  as a conditioning property, where monotone structure-property signal
  is what matters.
"""

from __future__ import annotations

from typing import List

from mlx_vae_tpu_torch.chem.mol import Mol
from mlx_vae_tpu_torch.chem.smiles import mol_from_smiles

# ------------------------------------------------------------------- TPSA

_N_FALLBACK = (30.5, 8.2, 1.5)   # value = a - X*b + H*c, floored at 0
_O_FALLBACK = (28.5, 8.6, 1.5)


def _in_3ring(mol: Mol, i: int) -> bool:
    nbrs = mol.adj[i]
    for a in range(len(nbrs)):
        for b in range(a + 1, len(nbrs)):
            key = (min(nbrs[a], nbrs[b]), max(nbrs[a], nbrs[b]))
            if key in mol.bonds:
                return True
    return False


def _tpsa_atom(mol: Mol, i: int) -> float:
    a = mol.atoms[i]
    el = a.element
    if el not in ("N", "O"):
        return 0.0
    h = mol.implicit_h(i)
    q = a.charge
    if a.aromatic:
        # Classify by BOND aromaticity (mol.aromatic_bonds, recorded by
        # perceive_aromaticity), not neighbor-atom flags: the N-aryl bond
        # of e.g. N-phenylpyrrole joins two aromatic atoms but is an
        # exocyclic single bond — rdkit scores that N 4.93 (n_ar=2 +
        # 1 single), not 4.41 (bridgehead n_ar=3).
        n_ar = sum(1 for j in mol.adj[i] if mol.is_aromatic_bond(i, j))
        n_single = sum(1 for j in mol.adj[i]
                       if not mol.is_aromatic_bond(i, j)
                       and mol.bond_order(i, j) == 1.0)
        n_double = sum(1 for j in mol.adj[i]
                       if not mol.is_aromatic_bond(i, j)
                       and mol.bond_order(i, j) == 2.0)
        if el == "O":
            if q == 0 and n_ar == 2 and h == 0:
                return 13.14
        else:  # aromatic N
            if q == 0:
                if n_ar == 2 and n_single == 0 and n_double == 0:
                    return 15.79 if h >= 1 else 12.89
                if n_ar == 3 and h == 0:
                    return 4.41
                if n_ar == 2 and n_single == 1 and h == 0:
                    return 4.93
                if n_ar == 2 and n_double == 1 and h == 0:
                    return 8.39
            elif q == 1:
                if n_ar == 2 and n_single == 0 and h == 1:
                    return 14.14
                if n_ar == 3 and h == 0:
                    return 4.10
                if n_ar == 2 and n_single == 1 and h == 0:
                    return 3.88
        # fall through to the fallback formula
    else:
        s = sum(1 for j in mol.adj[i] if mol.bond_order(i, j) == 1.0)
        d = sum(1 for j in mol.adj[i] if mol.bond_order(i, j) == 2.0)
        t = sum(1 for j in mol.adj[i] if mol.bond_order(i, j) == 3.0)
        ring3 = _in_3ring(mol, i)
        if el == "O":
            if q == 0:
                if h == 0 and s == 2 and d == 0:
                    return 12.53 if ring3 else 9.23
                if h == 0 and d == 1 and s == 0:
                    return 17.07
                if h == 1 and s == 1:
                    return 20.23
            elif q == -1 and s == 1 and h == 0:
                # charge-separated nitro oxygen scores as the =O of the
                # pentavalent form (both written forms of -NO2 must agree
                # at the Ertl nitro value 45.82)
                j = mol.adj[i][0]
                nb = mol.atoms[j]
                if nb.element == "N" and nb.charge == 1 and any(
                        mol.bond_order(j, k) == 2.0
                        and mol.atoms[k].element == "O"
                        for k in mol.adj[j]):
                    return 17.07
                return 23.06
        else:  # aliphatic N
            if q == 0:
                if h == 0:
                    if s == 3 and d == 0 and t == 0:
                        return 3.01 if ring3 else 3.24
                    if s == 1 and d == 1 and t == 0:
                        return 12.36
                    if s == 0 and d == 0 and t == 1:
                        return 23.79
                    if s == 1 and d == 2:
                        return 11.68
                    if d == 1 and t == 1:
                        return 13.60
                elif h == 1:
                    if s == 2 and d == 0:
                        return 21.94 if ring3 else 12.03
                    if d == 1 and s == 0:
                        return 23.85
                elif h == 2 and s == 1:
                    return 26.02
            elif q == 1:
                if h == 0:
                    if s == 4:
                        return 0.0
                    if s == 2 and d == 1:
                        # charge-separated nitro N scores as the
                        # pentavalent nitro N
                        if any(mol.atoms[j].element == "O"
                               and mol.atoms[j].charge == -1
                               and mol.bond_order(i, j) == 1.0
                               for j in mol.adj[i]) and any(
                                   mol.atoms[j].element == "O"
                                   and mol.bond_order(i, j) == 2.0
                                   for j in mol.adj[i]):
                            return 11.68
                        return 3.01
                    if s == 1 and t == 1:
                        return 4.36
                elif h == 1:
                    if s == 3:
                        return 4.44
                    if s == 1 and d == 1:
                        return 13.97
                elif h == 2:
                    if s == 2:
                        return 16.61
                    if d == 1:
                        return 25.59
                elif h == 3 and s == 1:
                    return 27.64
    # Ertl fallback for environments outside the table
    x = mol.degree(i) + h
    av, bv, cv = _N_FALLBACK if el == "N" else _O_FALLBACK
    return max(0.0, av - x * bv + h * cv)


def tpsa(mol: Mol) -> float:
    """Ertl topological polar surface area (N/O contributions, rdkit
    default semantics)."""
    return round(sum(_tpsa_atom(mol, i) for i in range(len(mol.atoms))), 2)


# --------------------------------------------------------------------- MW


def mol_weight(mol: Mol) -> float:
    return round(mol.weight(), 3)


# ------------------------------------------------------------------- LogP


def _clogp_atom(mol: Mol, i: int) -> float:
    a = mol.atoms[i]
    el = a.element
    h = mol.implicit_h(i)
    orders = [mol.bond_order(i, j) for j in mol.adj[i]]
    nbr_els = [mol.atoms[j].element for j in mol.adj[i]]
    het_nbr = any(e not in ("C", "H") for e in nbr_els)
    has_double = 2.0 in orders
    has_triple = 3.0 in orders

    if el == "C":
        hc = 0.1230 * h  # hydrocarbon H
        if a.aromatic:
            subs = [(mol.atoms[j], mol.bond_order(i, j))
                    for j in mol.adj[i] if not mol.is_aromatic_bond(i, j)]
            if not subs:
                if h:
                    return 0.1581 + hc       # aromatic CH
                return 0.2955                 # fused bridgehead
            e0 = subs[0][0].element
            if e0 == "N":
                return 0.2713 + hc
            if e0 == "O":
                return 0.2640 + hc
            if e0 in ("F", "Cl", "Br", "I", "S"):
                return 0.2148 + hc
            return 0.1360 + hc                # aromatic C - aliphatic C
        if has_triple:
            return 0.0017 + hc
        if has_double:
            dbl_to_het = any(
                o == 2.0 and mol.atoms[j].element != "C"
                for j, o in zip(mol.adj[i], orders))
            return (-0.2783 if dbl_to_het else 0.1551) + hc
        return (-0.2035 if het_nbr else 0.1441) + hc

    hh = -0.2677 * h  # polar H
    if el == "N":
        if a.charge != 0:
            return -1.950 + hh
        if a.aromatic:
            return -0.3239
        amide = any(
            mol.atoms[j].element == "C" and any(
                mol.bond_order(j, k) == 2.0
                and mol.atoms[k].element in ("O", "S")
                for k in mol.adj[j])
            for j in mol.adj[i])
        if amide:
            return -0.4458 + hh
        if has_triple:
            return 0.0151   # nitrile N
        if has_double:
            return -0.5188  # imine
        if h == 2:
            return -1.0190 + hh
        if h == 1:
            return -0.7096 + hh
        return -1.0270
    if el == "O":
        if a.charge != 0:
            return -1.326
        if a.aromatic:
            return 0.1552
        if has_double:
            return -0.1526  # carbonyl O
        if h >= 1:
            return -0.2893 + hh
        return -0.0684      # ether
    if el == "S":
        return 0.6482 if not a.aromatic else 0.6237
    if el == "P":
        return 0.8612
    if el == "F":
        return 0.4202
    if el == "Cl":
        return 0.6895
    if el == "Br":
        return 0.8456
    if el == "I":
        return 0.8857
    if el == "B":
        return -0.1032
    return 0.0


def clogp(mol: Mol) -> float:
    """Approximate Wildman-Crippen-style atom-contribution LogP (see
    module docstring for the accuracy caveat)."""
    return round(sum(_clogp_atom(mol, i) for i in range(len(mol.atoms))), 4)


# --------------------------------------------------------- string helpers


def descriptors_from_smiles(s: str):
    """-> (tpsa, logp, mw) or None if the SMILES does not parse."""
    mol = mol_from_smiles(s)
    if mol is None:
        return None
    return tpsa(mol), clogp(mol), mol_weight(mol)
