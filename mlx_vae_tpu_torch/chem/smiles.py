"""SMILES parser / writer with kekulization and aromaticity perception.

Implements the subset of the Daylight SMILES grammar that drug-like
organic molecules occupy (the same ground the reference's rdkit pipeline
covers for ChEMBL-CNS, ``reference/mlx_data/dataloader.py:39-65``):

* organic-subset atoms ``B C N O P S F Cl Br I`` and aromatic
  ``b c n o p s``; bracket atoms with isotope / explicit H / charge
  (stereo markers ``@ / \\`` are accepted and ignored — achiral graph);
* branches, ring closures (``%nn`` included), bond orders ``- = # :``;
* aromatic input is **kekulized** (perfect matching on the atoms that
  need a ring double bond, with pyrrole/furan/thiophene-type donors
  excluded) — parse fails if no Kekulé structure exists;
* ``mol_from_smiles`` returns None on any syntax or valence error,
  mirroring rdkit's ``MolFromSmiles`` contract that ``data/prepare.py``
  relies on for invalid-SMILES filtering.

The writer emits canonical, kekulized SMILES (Morgan-style iterative
rank refinement + deterministic DFS), used for molecule-level uniqueness
and round-trip testing.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Set, Tuple

from mlx_vae_tpu_torch.chem.mol import (ATOMIC_WEIGHTS, Atom, Mol,
                                  allowed_valences)

ORGANIC = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I"}
AROMATIC_ORGANIC = {"b", "c", "n", "o", "p", "s"}
_BRACKET_RE = re.compile(
    r"^(?P<iso>\d+)?(?P<sym>[A-Z][a-z]?|[bcnops])(?P<chiral>@{1,2})?"
    r"(?P<h>H\d*)?(?P<chg>\+{1,3}|-{1,3}|\+\d|-\d)?(?::\d+)?$")

AROMATIC_BOND = 1.5


class SmilesError(ValueError):
    pass


# --------------------------------------------------------------- parsing


def _parse_bracket(body: str) -> Atom:
    m = _BRACKET_RE.match(body)
    if not m:
        raise SmilesError(f"bad bracket atom [{body}]")
    sym = m.group("sym")
    aromatic = sym in AROMATIC_ORGANIC
    element = sym.capitalize() if aromatic else sym
    h = m.group("h")
    if h is None:
        hcount = 0
    elif h == "H":
        hcount = 1
    else:
        hcount = int(h[1:])
    chg = m.group("chg") or ""
    if not chg:
        charge = 0
    elif chg[-1].isdigit():
        charge = int(chg[1:]) * (1 if chg[0] == "+" else -1)
    else:
        charge = len(chg) * (1 if chg[0] == "+" else -1)
    iso = m.group("iso")
    return Atom(element, charge=charge, explicit_h=hcount,
                aromatic=aromatic, isotope=int(iso) if iso else None,
                chiral=m.group("chiral"))


def _flip_dir(d: str) -> str:
    return "/" if d == "\\" else "\\"


def parse_smiles(s: str) -> Mol:
    """Parse to a Mol with aromatic (1.5) bonds still in place.

    Multi-fragment input (``.``) parses to a disconnected Mol — callers
    that need one molecule pick a component (``mol_from_smiles`` keeps the
    largest, the standard ChEMBL salt-stripping curation). Tetrahedral
    tags (``@``/``@@``) and directional bonds (``/``, ``\\``) are recorded
    on the Mol (``stereo_order`` / ``bond_dirs``) and re-emitted by
    ``mol_to_smiles`` with writer-order parity correction."""
    if not s:
        raise SmilesError("empty SMILES")
    mol = Mol()
    prev: Optional[int] = None
    pending_bond: Optional[float] = None
    pending_dir: Optional[str] = None
    stack: List[Tuple[Optional[int], Optional[float], Optional[str]]] = []
    rings: Dict[int, Tuple[int, Optional[float], Optional[str]]] = {}
    i, n = 0, len(s)

    def note_neighbor(at: int, nb) -> None:
        """Append a neighbor (atom index or ring placeholder) to a chiral
        atom's SMILES-order slot list."""
        if at in mol.stereo_order:
            mol.stereo_order[at].append(nb)

    def attach(idx: int):
        nonlocal prev, pending_bond, pending_dir
        a = mol.atoms[idx]
        if a.chiral:
            # Slot order per OpenSMILES: preceding atom first (if any),
            # then the in-bracket H, then neighbors as written.
            slots: List = [] if prev is None else [prev]
            if (a.explicit_h or 0) == 1:
                slots.append(-1)
            mol.stereo_order[idx] = slots
        if prev is not None:
            order = pending_bond
            if order is None:
                order = (AROMATIC_BOND
                         if (mol.atoms[prev].aromatic
                             and mol.atoms[idx].aromatic) else 1.0)
            mol.add_bond(prev, idx, order)
            if pending_dir is not None:
                mol.bond_dirs[(prev, idx)] = pending_dir
                mol.bond_dirs[(idx, prev)] = _flip_dir(pending_dir)
            note_neighbor(prev, idx)
        prev = idx
        pending_bond = None
        pending_dir = None

    def close_ring(num: int):
        nonlocal pending_bond, pending_dir
        if prev is None:
            raise SmilesError("ring digit before any atom")
        if num in rings:
            other, order0, dir0 = rings.pop(num)
            order = pending_bond if pending_bond is not None else order0
            if order is None:
                order = (AROMATIC_BOND
                         if (mol.atoms[prev].aromatic
                             and mol.atoms[other].aromatic) else 1.0)
            if other == prev:
                raise SmilesError("ring closure to self")
            mol.add_bond(prev, other, order)
            if pending_dir is not None:
                mol.bond_dirs[(prev, other)] = pending_dir
                mol.bond_dirs[(other, prev)] = _flip_dir(pending_dir)
            elif dir0 is not None:
                mol.bond_dirs[(other, prev)] = dir0
                mol.bond_dirs[(prev, other)] = _flip_dir(dir0)
            # The opener's slot was the digit position; patch in the
            # partner now it is known. The closer's slot is right here.
            if other in mol.stereo_order:
                slots = mol.stereo_order[other]
                slots[slots.index(("ring", num))] = prev
            note_neighbor(prev, other)
        else:
            rings[num] = (prev, pending_bond, pending_dir)
            note_neighbor(prev, ("ring", num))
        pending_bond = None
        pending_dir = None

    while i < n:
        c = s[i]
        if c in "-=#:":
            if pending_bond is not None:
                raise SmilesError("double bond symbol")
            pending_bond = {"-": 1.0, "=": 2.0, "#": 3.0,
                            ":": AROMATIC_BOND}[c]
            i += 1
        elif c in "/\\":
            if pending_bond not in (None, 1.0):
                raise SmilesError("direction on a non-single bond")
            pending_dir = c
            i += 1
        elif c == "(":
            stack.append((prev, pending_bond, pending_dir))
            pending_bond = None
            pending_dir = None
            i += 1
        elif c == ")":
            if not stack:
                raise SmilesError("unbalanced )")
            prev, pending_bond, pending_dir = stack.pop()
            i += 1
        elif c == "[":
            j = s.find("]", i)
            if j < 0:
                raise SmilesError("unterminated bracket")
            attach(mol.add_atom(_parse_bracket(s[i + 1:j])))
            i = j + 1
        elif c == "%":
            if i + 2 >= n or not s[i + 1:i + 3].isdigit():
                raise SmilesError("bad %ring")
            close_ring(int(s[i + 1:i + 3]))
            i += 3
        elif c.isdigit():
            close_ring(int(c))
            i += 1
        elif c.isupper():
            sym = s[i:i + 2] if s[i:i + 2] in ("Cl", "Br") else c
            if sym not in ORGANIC:
                raise SmilesError(f"element {sym!r} needs brackets")
            attach(mol.add_atom(Atom(sym)))
            i += len(sym)
        elif c in AROMATIC_ORGANIC:
            attach(mol.add_atom(Atom(c.upper(), aromatic=True)))
            i += 1
        elif c == ".":
            # Fragment separator: the next atom starts a new component.
            if pending_bond is not None or pending_dir is not None:
                raise SmilesError("bond symbol before '.'")
            prev = None
            i += 1
        else:
            raise SmilesError(f"unexpected character {c!r}")
    if stack:
        raise SmilesError("unbalanced (")
    if rings:
        raise SmilesError(f"unclosed ring bonds {sorted(rings)}")
    if pending_bond is not None:
        raise SmilesError("dangling bond symbol")
    # A tetrahedral tag is meaningful only with exactly 4 distinct slots
    # (counting the in-bracket H); anything else is silently achiral —
    # matching rdkit's drop-bad-stereo sanitization rather than erroring.
    for at in list(mol.stereo_order):
        if len(mol.stereo_order[at]) != 4:
            del mol.stereo_order[at]
            mol.atoms[at].chiral = None
    return mol


# ----------------------------------------------------------- kekulization


def _needs_ring_double(mol: Mol, i: int) -> Optional[bool]:
    """Does aromatic atom i need exactly one double bond inside the
    aromatic system? None = cannot participate (not aromatic-capable)."""
    a = mol.atoms[i]
    # An existing exocyclic double bond (e.g. aromatic c=O in written-
    # aromatic quinones) satisfies the sp2 requirement.
    exo_double = any(
        mol.bond_order(i, j) == 2.0 for j in mol.adj[i]
        if not mol.atoms[j].aromatic)
    deg = mol.degree(i)
    h = a.explicit_h if a.explicit_h is not None else None
    el, q = a.element, a.charge
    if el == "C":
        if q == -1:
            return False  # carbanion donates the lone pair (Cp-)
        if q == 1:
            return False  # tropylium-type: empty p orbital, no double
        return not exo_double
    if el == "N" or el == "P":
        if q == 1:
            return True  # pyridinium / N-alkylpyridinium
        if q == -1:
            return False  # azolide N-
        # pyrrole-type: three sigma partners (2 ring + H or substituent)
        if (h or 0) >= 1 or deg >= 3:
            return False
        return True  # pyridine-type
    if el in ("O", "S", "Se"):
        return True if q == 1 else False
    if el == "B":
        return False
    return None


def kekulize(mol: Mol) -> None:
    """Replace aromatic (1.5) bonds with an alternating single/double
    assignment. Raises SmilesError when no Kekulé structure exists."""
    arom_bonds = [k for k, o in mol.bonds.items() if o == AROMATIC_BOND]
    if not arom_bonds:
        return
    arom_atoms: Set[int] = set()
    for (i, j) in arom_bonds:
        arom_atoms.update((i, j))
    need: Dict[int, bool] = {}
    for i in arom_atoms:
        r = _needs_ring_double(mol, i)
        if r is None:
            raise SmilesError(
                f"atom {mol.atoms[i].element} cannot be aromatic")
        need[i] = r

    # Perfect matching over atoms that need a double bond, using only
    # aromatic bonds. Backtracking is fine at molecule scale.
    adj: Dict[int, List[int]] = {i: [] for i in arom_atoms}
    for (i, j) in arom_bonds:
        adj[i].append(j)
        adj[j].append(i)
    todo = sorted((i for i in arom_atoms if need[i]),
                  key=lambda x: len(adj[x]))
    matched: Dict[int, int] = {}

    def backtrack(pos: int) -> bool:
        while pos < len(todo) and todo[pos] in matched:
            pos += 1
        if pos == len(todo):
            return True
        u = todo[pos]
        for v in adj[u]:
            if need.get(v) and v not in matched:
                matched[u] = v
                matched[v] = u
                if backtrack(pos + 1):
                    return True
                del matched[u], matched[v]
        return False

    if not backtrack(0):
        raise SmilesError("no Kekulé structure")
    double = {(min(u, v), max(u, v)) for u, v in matched.items()}
    for k in arom_bonds:
        mol.set_bond_order(*k, 2.0 if k in double else 1.0)
    # Note: a neutral 2-degree aromatic N without an explicit H is always
    # classified pyridine-type above (rdkit parity: pyrrole MUST be
    # written [nH]; plain-n pyrrole fails the matching and raises
    # "no Kekulé structure" rather than getting an H silently pinned).


# ----------------------------------------------------- aromaticity percept

def rings_upto(mol: Mol, max_size: int = 7) -> List[List[int]]:
    """Smallest ring through each ring bond (BFS), deduplicated."""
    out: List[List[int]] = []
    seen: Set[frozenset] = set()
    for (a, b) in mol.ring_bonds():
        # shortest path a->b avoiding the direct bond
        prevs = {a: None}
        queue = [a]
        found = False
        while queue and not found:
            nxt = []
            for u in queue:
                for v in mol.adj[u]:
                    if u == a and v == b:
                        continue
                    if v not in prevs:
                        prevs[v] = u
                        if v == b:
                            found = True
                            break
                        nxt.append(v)
                if found:
                    break
            queue = nxt
        if not found:
            continue
        path = [b]
        while path[-1] is not None:
            p = prevs[path[-1]]
            if p is None:
                break
            path.append(p)
        ring = path
        if len(ring) > max_size:
            continue
        key = frozenset(ring)
        if key not in seen:
            seen.add(key)
            out.append(ring)
    return out


def perceive_aromaticity(mol: Mol) -> None:
    """Set ``atom.aromatic`` flags and ``mol.aromatic_bonds`` on kekulized
    molecules (Hückel 4n+2 on individual small rings). Needed by the
    descriptors when the input came from SELFIES decoding, which emits
    kekulized structures with no aromatic flags. ``aromatic_bonds``
    records the ring edges of every qualifying ring — the per-bond truth
    the Ertl TPSA table needs (an N-aryl single bond joins two aromatic
    ATOMS but is not an aromatic BOND). ``ring_pi`` reads only bond
    orders / elements / charges, never the flags being set, so a single
    pass over the rings is the fixed point."""
    for a in mol.atoms:
        a.aromatic = False
    mol.aromatic_bonds = set()
    rings = [r for r in rings_upto(mol, 7) if 5 <= len(r) <= 7]

    ring_atom_set: Set[int] = set()
    for (i, j) in mol.ring_bonds():
        ring_atom_set.update((i, j))

    def ring_pi(ring: List[int]) -> Optional[int]:
        rset = set(ring)
        total = 0
        for i in ring:
            a = mol.atoms[i]
            in_double = any(
                mol.bond_order(i, j) == 2.0 and j in rset
                for j in mol.adj[i])
            # A double bond leaving this ring: to another ring atom
            # (fused-system edge, e.g. indole's fusion carbons seen from
            # the 5-ring) the pi electron still counts; to a terminal
            # heteroatom (quinoid C=O) it does not.
            exo = [j for j in mol.adj[i]
                   if mol.bond_order(i, j) == 2.0 and j not in rset]
            if in_double:
                total += 1
            elif exo:
                total += 1 if any(j in ring_atom_set for j in exo) else 0
            elif a.element == "C":
                if a.charge == -1:
                    total += 2
                elif a.charge == 1:
                    total += 0  # tropylium: empty p orbital
                else:
                    return None  # sp3 carbon -> not aromatic
            elif a.element in ("N", "P"):
                total += 2  # pyrrole/amide-type lone pair
            elif a.element in ("O", "S", "Se"):
                total += 2
            elif a.element == "B":
                total += 0
            else:
                return None
            # sp3 check: more than 3 sigma partners + H disqualifies
            if mol.degree(i) + mol.implicit_h(i) > 3:
                return None
        return total

    for ring in rings:
        pi = ring_pi(ring)
        if pi is not None and pi % 4 == 2:
            for i in ring:
                mol.atoms[i].aromatic = True
            # ``ring`` is an ordered cycle (BFS path b..a closed by the
            # (a, b) ring bond), so consecutive pairs + the closing pair
            # are exactly its edges.
            for u, v in zip(ring, ring[1:] + ring[:1]):
                mol.aromatic_bonds.add((min(u, v), max(u, v)))


# ---------------------------------------------------------------- writing


def _canonical_ranks(mol: Mol) -> List[int]:
    n = len(mol.atoms)
    inv = []
    for i, a in enumerate(mol.atoms):
        inv.append((a.element, a.charge, mol.degree(i), mol.implicit_h(i),
                    int(mol.bond_sum(i) * 2)))
    order = sorted(range(n), key=lambda i: inv[i])
    rank = [0] * n
    r = 0
    for k, i in enumerate(order):
        if k and inv[i] != inv[order[k - 1]]:
            r = k
        rank[i] = r

    def refine(rank: List[int]) -> List[int]:
        for _ in range(n):
            key = [(rank[i],
                    tuple(sorted((rank[j], int(mol.bond_order(i, j) * 2))
                                 for j in mol.adj[i])))
                   for i in range(n)]
            order = sorted(range(n), key=lambda i: key[i])
            new = [0] * n
            r = 0
            for k, i in enumerate(order):
                if k and key[i] != key[order[k - 1]]:
                    r = k
                new[i] = r
            if new == rank:
                break
            rank = new
        return rank

    rank = refine(rank)
    # break remaining ties deterministically
    while len(set(rank)) < n:
        counts: Dict[int, List[int]] = {}
        for i in range(n):
            counts.setdefault(rank[i], []).append(i)
        tied = min((v for v in counts.values() if len(v) > 1),
                   key=lambda v: rank[v[0]])
        rank[tied[0]] -= 0  # pick first, bump the others
        for i in tied[1:]:
            rank[i] += 1
        rank = refine(rank)
    return rank


def _perm_parity(a: List, b: List) -> int:
    """0 if b is an even permutation of a, 1 if odd."""
    b = list(b)
    p = 0
    for i in range(len(a)):
        if b[i] != a[i]:
            j = b.index(a[i], i + 1)
            b[i], b[j] = b[j], b[i]
            p ^= 1
    return p


def mol_to_smiles(mol: Mol) -> str:
    """Canonical kekulized SMILES (uppercase atoms, explicit = / #).

    Tetrahedral tags recorded in ``mol.stereo_order`` are re-emitted with
    the @/@@ sense corrected for the writer's own neighbor order
    (permutation parity vs the parse order), so equivalent stereo inputs
    canonicalize identically; directional bonds re-emit with the traversal
    orientation they are stored under (round-trip faithful; NOT normalized
    across the global /\\ flip — see the divergence ledger in
    docs/DESIGN.md)."""
    n = len(mol.atoms)
    if n == 0:
        return ""
    rank = _canonical_ranks(mol)
    start = rank.index(min(rank))
    ring_num = [0]
    ring_open: Dict[Tuple[int, int], int] = {}
    free_nums: List[int] = []

    # Pre-walk to find ring-closure bonds under the canonical DFS.
    tree_edges: Set[Tuple[int, int]] = set()
    closures: Dict[int, List[int]] = {i: [] for i in range(n)}
    stack = [start]
    seen = [False] * n
    seen[start] = True
    parent: Dict[int, Optional[int]] = {start: None}
    dfs_order = []
    while stack:
        u = stack.pop()
        dfs_order.append(u)
        for v in sorted(mol.adj[u], key=lambda x: rank[x], reverse=True):
            if not seen[v]:
                seen[v] = True
                parent[v] = u
                tree_edges.add((min(u, v), max(u, v)))
                stack.append(v)
    if not all(seen):
        raise SmilesError("disconnected molecule")
    pos = {u: k for k, u in enumerate(dfs_order)}
    for (i, j) in mol.bonds:
        if (i, j) not in tree_edges:
            a, b = (i, j) if pos[i] < pos[j] else (j, i)
            closures[a].append(b)
            closures[b].append(a)

    def bond_sym(o: float) -> str:
        return {1.0: "", 2.0: "=", 3.0: "#"}[o]

    # Directional-bond normalization: the absolute "/" vs "\" of a coupled
    # E/Z system is arbitrary — a global flip of every symbol around one
    # double-bond system is the SAME geometry — so equivalent inputs only
    # canonicalize equal if each coupled component is flipped to a fixed
    # convention: first symbol the writer emits for the component is "/".
    dir_comp: Dict[Tuple[int, int], Tuple[int, int]] = {}
    comp_flip: Dict[Tuple[int, int], bool] = {}
    if mol.bond_dirs:
        dkeys = {(min(u, v), max(u, v)) for (u, v) in mol.bond_dirs}
        uf = {k: k for k in dkeys}

        def find(x):
            while uf[x] != x:
                uf[x] = uf[uf[x]]
                x = uf[x]
            return x

        for (u, v), o in mol.bonds.items():
            if o == 2.0:
                inc = sorted(k for k in dkeys if u in k or v in k)
                for a, b in zip(inc, inc[1:]):
                    uf[find(a)] = find(b)
        dir_comp = {k: find(k) for k in dkeys}

    def dir_bond_sym(frm: int, to: int) -> str:
        """Bond symbol for frm->to, using the stored direction when the
        single bond carries one (component-flip normalized)."""
        o = mol.bond_order(frm, to)
        if o == 1.0:
            d = mol.bond_dirs.get((frm, to))
            if d is not None:
                comp = dir_comp[(min(frm, to), max(frm, to))]
                if comp not in comp_flip:
                    comp_flip[comp] = d != "/"
                return _flip_dir(d) if comp_flip[comp] else d
        return bond_sym(o)

    def stereo_tag(node: int, frm: Optional[int],
                   closure_partners: List[int],
                   children: List[int]) -> Optional[str]:
        """@/@@ corrected for the writer's emission order (permutation
        parity vs the recorded parse order); None when the atom carries no
        (valid) tetrahedral tag."""
        a = mol.atoms[node]
        stored = mol.stereo_order.get(node)
        if a.chiral is None or stored is None:
            return None
        emitted: List = [] if frm is None else [frm]
        if mol.implicit_h(node) == 1:
            emitted.append(-1)
        emitted += closure_partners + children
        if len(emitted) != 4 or sorted(emitted) != sorted(stored):
            return None
        flip = _perm_parity(stored, emitted)
        if not flip:
            return a.chiral
        return "@@" if a.chiral == "@" else "@"

    def atom_str(i: int, tag: Optional[str] = None) -> str:
        a = mol.atoms[i]
        h = mol.implicit_h(i)
        if tag is None and a.element in ORGANIC and a.charge == 0 \
                and a.isotope is None:
            # plain form is legal only if the implicit-H rule re-infers
            # the same H count on re-parse
            save, a.explicit_h = a.explicit_h, None
            inferred = mol.implicit_h(i)
            a.explicit_h = save
            if inferred == h:
                return a.element
        parts = [] if a.isotope is None else [str(a.isotope)]
        parts.append(a.element)
        if tag:
            parts.append(tag)
        if h == 1:
            parts.append("H")
        elif h > 1:
            parts.append(f"H{h}")
        if a.charge:
            sign = "+" if a.charge > 0 else "-"
            parts.append(sign if abs(a.charge) == 1
                         else f"{sign}{abs(a.charge)}")
        return "[" + "".join(parts) + "]"

    out: List[str] = []

    def emit(node: int, inc: Optional[float], frm: Optional[int]):
        if inc is not None:
            out.append(dir_bond_sym(frm, node))
        closure_partners = sorted(closures[node], key=lambda x: pos[x])
        children = [v for v in sorted(mol.adj[node], key=lambda x: rank[x])
                    if parent.get(v) == node]
        out.append(atom_str(node, stereo_tag(node, frm, closure_partners,
                                             children)))
        for other in closure_partners:
            key = (min(node, other), max(node, other))
            if key in ring_open:
                num = ring_open.pop(key)
                free_nums.append(num)
            else:
                num = free_nums.pop() if free_nums else ring_num[0] + 1
                ring_num[0] = max(ring_num[0], num)
                ring_open[key] = num
                out.append(dir_bond_sym(node, other))
            out.append(str(num) if num < 10 else f"%{num:02d}")
        for k, v in enumerate(children):
            o = mol.bond_order(node, v)
            if k < len(children) - 1:
                out.append("(")
                emit(v, o, node)
                out.append(")")
            else:
                emit(v, o, node)

    emit(start, None, None)
    return "".join(out)


# ------------------------------------------------------------- public API


def mol_from_smiles(s: str,
                    keep_largest_fragment: bool = True) -> Optional[Mol]:
    """Parse + kekulize + valence-check. None on any failure (rdkit's
    MolFromSmiles contract). Multi-fragment input (salts, mixtures — the
    norm in raw ChEMBL rows) keeps the LARGEST fragment (by heavy-atom
    count, then weight), the standard ChEMBL salt-stripping curation;
    pass ``keep_largest_fragment=False`` to reject such input instead.
    Input written aromatic must actually be aromatic after perception
    (rejects e.g. ``c1ccc1``); limitation: systems aromatic only as a
    multi-ring circuit (azulene) are rejected because perception is per
    small ring."""
    try:
        mol = parse_smiles(s.strip())
        kekulize(mol)
    except (SmilesError, ValueError):
        return None
    comps = mol.components()
    if len(comps) > 1:
        if not keep_largest_fragment:
            return None
        mol = mol.extract(max(comps, key=lambda c: (
            len(c), sum(ATOMIC_WEIGHTS.get(mol.atoms[i].element, 0.0)
                        for i in c))))
    written_aromatic = [a.aromatic for a in mol.atoms]
    if not mol.is_valid():
        return None
    perceive_aromaticity(mol)
    if any(w and not a.aromatic
           for w, a in zip(written_aromatic, mol.atoms)):
        return None
    return mol


def canonical_smiles(s: str) -> Optional[str]:
    mol = mol_from_smiles(s)
    return None if mol is None else mol_to_smiles(mol)
