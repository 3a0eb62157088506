"""SELFIES encoder/decoder (Krenn, Häse, Nigam, Friederich & Aspuru-Guzik
2020, *Self-referencing embedded strings*; the v2 grammar of the public
``selfies`` library whose role this vendors — see
``reference/mlx_data/dataloader.py:39-65`` for how the reference
consumes SELFIES tokens).

The property that makes SELFIES the right representation for a molecular
VAE (and the reason the reference uses it): **every** symbol string drawn
from the alphabet decodes to a valence-correct molecule. Decoding is a
derivation automaton whose state is the number of bonds the current atom
can still make; bond orders are clamped to what both endpoints can
afford, branches/rings read their length/target from overloaded index
symbols, and anything impossible degrades to a no-op instead of an error.

Implementation choices documented for parity debugging (the public
library is not installable here to diff against):

* index alphabet and Q encoding are the published v2 ones
  (``[C]``=0, ``[Ring1]``=1, ... ``[P]``=15, base-16 big-endian);
* valence caps come from ``mol.allowed_valences`` (max allowed valence
  per element/charge) minus the symbol's explicit H count;
* an inactive branch symbol (state < 2) still consumes its index symbols
  and body — the construct is skipped as a unit; an inactive ring symbol
  consumes its index symbols;
* under-bonded bracket atoms are hydrogen-filled up to the nearest
  allowed valence after derivation, so ``selfies_to_mol`` output always
  passes ``Mol.is_valid()`` (the library instead emits radicals and
  leaves the judgment to rdkit).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

from mlx_vae_tpu_torch.chem.mol import Atom, Mol, allowed_valences
from mlx_vae_tpu_torch.chem.smiles import mol_from_smiles, mol_to_smiles

BOND_PREFIX = {"": 1, "=": 2, "#": 3, "/": 1, "\\": 1, "-": 1}
PREFIX_OF_ORDER = {1: "", 2: "=", 3: "#"}

INDEX_ALPHABET: Tuple[str, ...] = (
    "[C]", "[Ring1]", "[Ring2]", "[Branch1]", "[=Branch1]", "[#Branch1]",
    "[Branch2]", "[=Branch2]", "[#Branch2]", "[O]", "[N]", "[=N]", "[=C]",
    "[#C]", "[S]", "[P]")
_INDEX_OF = {s: i for i, s in enumerate(INDEX_ALPHABET)}

_ATOM_SYM_RE = re.compile(
    r"^\[(?P<bond>[=#/\\-]?)(?P<sym>[A-Z][a-z]?)"
    r"(?P<h>H\d?)?(?P<chg>[+-]\d?)?\]$")
_BRANCH_RE = re.compile(r"^\[(?P<bond>[=#]?)Branch(?P<n>[123])\]$")
_RING_RE = re.compile(r"^\[(?P<bond>[=#/\\-]?)Ring(?P<n>[123])\]$")

NOP = "[nop]"


def split_selfies(s: str) -> List[str]:
    """Split a SELFIES string into its bracket symbols."""
    out = []
    i, n = 0, len(s)
    while i < n:
        if s[i] != "[":
            raise ValueError(f"SELFIES symbol must start with '[' at {i}")
        j = s.find("]", i)
        if j < 0:
            raise ValueError("unterminated SELFIES symbol")
        out.append(s[i:j + 1])
        i = j + 1
    return out


def _parse_atom_symbol(sym: str) -> Optional[Tuple[int, str, Optional[int], int]]:
    """-> (bond_order, element, explicit_h or None, charge), or None."""
    m = _ATOM_SYM_RE.match(sym)
    if not m:
        return None
    el = m.group("sym")
    if el in ("Ring", "Branch"):
        return None
    h = m.group("h")
    hcount = None if h is None else (1 if h == "H" else int(h[1:]))
    chg = m.group("chg")
    if chg is None:
        charge = 0
    else:
        charge = (1 if len(chg) == 1 else int(chg[1:])) * \
            (1 if chg[0] == "+" else -1)
    return BOND_PREFIX[m.group("bond")], el, hcount, charge


def _cap(element: str, charge: int, h: Optional[int]) -> int:
    vals = allowed_valences(element, charge)
    if not vals:
        return 0
    return max(0, max(vals) - (h or 0))


# ---------------------------------------------------------------- decoding


class _Deriver:
    """The derivation automaton. ``caps[i]`` is the remaining bond
    capacity of atom i and is the single source of truth for state
    (a context-local copy could desync when a branch body makes a ring
    bond from the parent atom)."""

    def __init__(self, symbols: Sequence[str]):
        self.symbols = [s for s in symbols if s != NOP]
        self.pos = 0
        self.mol = Mol()
        self.caps: List[int] = []

    def _read_index(self, n: int, end: int) -> Optional[int]:
        q = 0
        for _ in range(n):
            if self.pos >= end:
                return None
            q = q * 16 + _INDEX_OF.get(self.symbols[self.pos], 0)
            self.pos += 1
        return q

    def derive(self, end: int, current: Optional[int],
               first_bond_cap: float) -> None:
        """Derive symbols[pos:end] growing from ``current`` (None at the
        root). ``first_bond_cap`` additionally clamps the first bond made
        in this context (branch-state semantics)."""
        first = True
        while self.pos < end:
            sym = self.symbols[self.pos]
            self.pos += 1

            atom = _parse_atom_symbol(sym)
            if atom is not None:
                b, el, h, chg = atom
                cap_new = _cap(el, chg, h)
                if current is None:
                    current = self.mol.add_atom(
                        Atom(el, charge=chg, explicit_h=h))
                    self.caps.append(cap_new)
                    first = False
                    continue
                o = min(b, self.caps[current], cap_new)
                if first:
                    o = min(o, int(first_bond_cap))
                if o < 1:
                    return  # saturated chain or unbondable atom: halt context
                idx = self.mol.add_atom(Atom(el, charge=chg, explicit_h=h))
                self.caps.append(cap_new)
                self.mol.add_bond(current, idx, float(o))
                self.caps[current] -= o
                self.caps[idx] -= o
                current = idx
                first = False
                continue

            mb = _BRANCH_RE.match(sym)
            if mb is not None:
                q = self._read_index(int(mb.group("n")), end)
                if q is None:
                    return
                body_end = min(end, self.pos + q + 1)
                if current is None or self.caps[current] < 2:
                    self.pos = body_end  # inactive: skip the whole construct
                    continue
                border = BOND_PREFIX[mb.group("bond")]
                sub_cap = min(border, self.caps[current] - 1)
                self.derive(body_end, current, sub_cap)
                self.pos = body_end  # discard any unconsumed branch tail
                continue

            mr = _RING_RE.match(sym)
            if mr is not None:
                q = self._read_index(int(mr.group("n")), end)
                if q is None:
                    return
                if current is None or self.caps[current] < 1:
                    continue
                target = max(0, current - (q + 1))
                key = (min(current, target), max(current, target))
                if target == current or key in self.mol.bonds:
                    continue
                border = BOND_PREFIX[mr.group("bond")]
                o = min(border, self.caps[current], self.caps[target])
                if first:
                    o = min(o, int(first_bond_cap))
                if o < 1:
                    continue
                self.mol.add_bond(current, target, float(o))
                self.caps[current] -= o
                self.caps[target] -= o
                first = False
                continue

            # unknown symbol: no-op (robustness)


def selfies_to_mol(s) -> Optional[Mol]:
    """Decode a SELFIES string or symbol list to a Mol (None only for an
    empty derivation — everything else decodes by construction)."""
    symbols = split_selfies(s) if isinstance(s, str) else list(s)
    d = _Deriver(symbols)
    d.derive(len(d.symbols), None, float("inf"))
    mol = d.mol
    if not mol.atoms:
        return None
    # Hydrogen-fill bracket atoms so the result always passes is_valid().
    for i, a in enumerate(mol.atoms):
        if a.explicit_h is not None:
            bsum = int(mol.bond_sum(i))
            total = bsum + a.explicit_h
            vals = allowed_valences(a.element, a.charge)
            if vals and total not in vals:
                fill = min((v for v in vals if v >= total), default=None)
                if fill is not None:
                    a.explicit_h = fill - bsum
    return mol


def selfies_to_smiles(s) -> Optional[str]:
    mol = selfies_to_mol(s)
    return None if mol is None else mol_to_smiles(mol)


# ---------------------------------------------------------------- encoding


def _atom_symbol(mol: Mol, i: int, bond_order: int) -> str:
    a = mol.atoms[i]
    h = mol.implicit_h(i)
    prefix = PREFIX_OF_ORDER[bond_order]
    # H must appear in the symbol when the decoder-side fill (max capacity
    # minus bonds, then nearest allowed valence) would not reproduce it —
    # exactly when the atom's SMILES form needs an explicit H bracket.
    need_h = a.charge != 0
    if a.explicit_h is not None:
        save, a.explicit_h = a.explicit_h, None
        need_h = need_h or mol.implicit_h(i) != save
        a.explicit_h = save
    parts = [prefix, a.element]
    if need_h and h > 0:
        parts.append(f"H{h}")
    if a.charge:
        sign = "+" if a.charge > 0 else "-"
        parts.append(f"{sign}{abs(a.charge)}")
    return "[" + "".join(parts) + "]"


def _index_symbols(q: int, n: int) -> List[str]:
    digits = []
    for _ in range(n):
        digits.append(INDEX_ALPHABET[q % 16])
        q //= 16
    return list(reversed(digits))


def _symbols_needed(q: int) -> int:
    for n in (1, 2, 3):
        if q < 16 ** n:
            return n
    raise ValueError(f"index {q} too large for SELFIES (>4095)")


def mol_to_selfies(mol: Mol) -> List[str]:
    """Encode a (kekulized) Mol as a SELFIES symbol list. The traversal
    mirrors the derivation automaton: DFS from atom 0 in graph order,
    non-tree bonds become Ring symbols on the later endpoint, non-last
    children become Branches."""
    n = len(mol.atoms)
    if n == 0:
        return []
    # Spanning tree in input order. Visit-time marking (not push-time):
    # an atom reachable both through a chain and directly keeps the chain
    # as its tree path, so rings encode linearly ([C][=C]...[Ring1]) the
    # way the published library does, instead of as branches.
    parent: Dict[int, Optional[int]] = {}
    order: List[int] = []
    pos: Dict[int, int] = {}
    stack: List[Tuple[int, Optional[int]]] = [(0, None)]
    children: Dict[int, List[int]] = {i: [] for i in range(n)}
    while stack:
        u, p = stack.pop()
        if u in pos:
            continue
        parent[u] = p
        order.append(u)
        pos[u] = len(order) - 1
        for v in reversed(mol.adj[u]):
            if v not in pos:
                stack.append((v, u))
    if len(order) != n:
        raise ValueError("disconnected molecule cannot be SELFIES-encoded")
    for v in order[1:]:
        children[parent[v]].append(v)
    for u in children:
        children[u].sort(key=lambda v: pos[v])
    tree = {(min(u, parent[u]), max(u, parent[u])) for u in order[1:]}
    ring_at: Dict[int, List[int]] = {i: [] for i in range(n)}
    for (i, j) in mol.bonds:
        if (i, j) not in tree:
            a, b = (i, j) if pos[i] < pos[j] else (j, i)
            ring_at[b].append(a)

    def emit(u: int, bond_from_parent: int) -> List[str]:
        out = [_atom_symbol(mol, u, bond_from_parent)]
        for tgt in sorted(ring_at[u], key=lambda x: pos[x]):
            o = int(mol.bond_order(u, tgt))
            q = pos[u] - pos[tgt] - 1
            nn = _symbols_needed(q)
            out.append(f"[{PREFIX_OF_ORDER[o]}Ring{nn}]")
            out.extend(_index_symbols(q, nn))
        kids = children[u]
        for k, v in enumerate(kids):
            o = int(mol.bond_order(u, v))
            sub = emit(v, o)
            if k < len(kids) - 1:
                q = len(sub) - 1
                nn = _symbols_needed(q)
                out.append(f"[{PREFIX_OF_ORDER[o]}Branch{nn}]")
                out.extend(_index_symbols(q, nn))
            out.extend(sub)
        return out

    return emit(order[0], 1)


def smiles_to_selfies(s: str) -> Optional[str]:
    """SMILES -> SELFIES string (None when the SMILES does not parse)."""
    mol = mol_from_smiles(s)
    if mol is None:
        return None
    return "".join(mol_to_selfies(mol))


# --------------------------------------------------- bulk-scan metadata

KIND_NOOP, KIND_ATOM, KIND_BRANCH, KIND_RING, KIND_NOP = 0, 1, 2, 3, 4


def classify_symbols(symbols: Sequence[str]):
    """Per-symbol automaton metadata for bulk validity scanning:
    ``(kind, nsym, index_val)`` integer lists aligned with ``symbols``.

    Derivation non-emptiness (>= 1 atom placed) is decidable from this
    alone: before the first atom there are no bonds, so branches are
    always inactive (skip nsym index symbols + Q+1 body symbols) and
    rings are no-ops (skip nsym index symbols). A decoded SELFIES
    molecule is valence-valid by construction, so "non-empty derivation"
    IS chemical validity of a generated row.
    """
    kinds, nsyms, ivals = [], [], []
    for s in symbols:
        if s == NOP:
            # [nop] is stripped BEFORE derivation (unlike unknown no-op
            # symbols, which are consumed in place) — callers must remove
            # KIND_NOP ids from the stream before scanning.
            k, n = KIND_NOP, 0
        elif _parse_atom_symbol(s) is not None:
            k, n = KIND_ATOM, 0
        else:
            mb = _BRANCH_RE.match(s)
            mr = _RING_RE.match(s)
            if mb is not None:
                k, n = KIND_BRANCH, int(mb.group("n"))
            elif mr is not None:
                k, n = KIND_RING, int(mr.group("n"))
            else:
                k, n = KIND_NOOP, 0
        kinds.append(k)
        nsyms.append(n)
        ivals.append(_INDEX_OF.get(s, 0))
    return kinds, nsyms, ivals


def derivation_nonempty(symbol_stream: Sequence[int], kinds: Sequence[int],
                        nsyms: Sequence[int],
                        ivals: Sequence[int]) -> bool:
    """Exact automaton scan over a stream of symbol ids (specials/EOS
    already stripped): True iff the derivation places at least one atom."""
    pos, n = 0, len(symbol_stream)
    while pos < n:
        t = symbol_stream[pos]
        k = kinds[t]
        pos += 1
        if k == KIND_ATOM:
            return True
        if k == KIND_BRANCH:
            q = 0
            for _ in range(nsyms[t]):
                if pos >= n:
                    return False
                q = q * 16 + ivals[symbol_stream[pos]]
                pos += 1
            pos += q + 1  # inactive before the first atom: skip the body
        elif k == KIND_RING:
            pos += nsyms[t]
    return False
