"""Molecular graph + valence model for the vendored chemistry toolkit.

A ``Mol`` is a plain undirected multigraph: atoms with (element, charge,
optional explicit H count, aromatic flag) and integer-order bonds
(1/2/3; aromatic bonds exist only transiently during SMILES parsing and
are kekulized away before a ``Mol`` is returned to callers).

The valence model is the standard organic-subset table (what rdkit calls
"default valences"): an atom is valid when its bond-order sum plus
hydrogens equals an allowed valence for (element, charge). This is the
check behind chemical validity scoring (the role rdkit's
``MolFromSmiles`` sanitization plays in the reference pipeline,
``reference/mlx_data/dataloader.py:39-65``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# Allowed total valences (bond-order sum + H count) per neutral element.
ALLOWED_VALENCES: Dict[str, Tuple[int, ...]] = {
    "H": (1,),
    "B": (3,),
    "C": (4,),
    "N": (3,),
    "O": (2,),
    "F": (1,),
    "P": (3, 5),
    "S": (2, 4, 6),
    "Cl": (1,),
    "Br": (1,),
    "I": (1,),
    "Si": (4,),
    "Se": (2, 4, 6),
}

# Charge adjustments: (element, charge) -> allowed valences. Derived from
# the isoelectronic rule used by standard toolkits (N+ behaves like C,
# O+ like N, ...), restricted to charges seen in drug-like molecules.
CHARGED_VALENCES: Dict[Tuple[str, int], Tuple[int, ...]] = {
    ("N", 1): (4,),
    ("N", -1): (2,),
    ("O", 1): (3,),
    ("O", -1): (1,),
    ("C", 1): (3,),
    ("C", -1): (3,),
    ("S", 1): (3, 5),
    ("S", -1): (1,),
    ("P", 1): (4,),
    ("B", -1): (4,),
}

ATOMIC_WEIGHTS: Dict[str, float] = {
    "H": 1.008, "B": 10.811, "C": 12.011, "N": 14.007, "O": 15.999,
    "F": 18.998, "Si": 28.086, "P": 30.974, "S": 32.065, "Cl": 35.453,
    "Se": 78.971, "Br": 79.904, "I": 126.904,
}


def allowed_valences(element: str, charge: int = 0) -> Tuple[int, ...]:
    if charge != 0:
        v = CHARGED_VALENCES.get((element, charge))
        if v is not None:
            return v
        base = ALLOWED_VALENCES.get(element)
        if base is None:
            return ()
        # Generic fallback: |charge| shifts each allowed valence by +charge
        # for cations on N-group-like donors; keep it permissive but bounded.
        return tuple(max(0, x + charge) for x in base)
    return ALLOWED_VALENCES.get(element, ())


class Atom:
    __slots__ = ("element", "charge", "explicit_h", "aromatic", "isotope",
                 "chiral")

    def __init__(self, element: str, charge: int = 0,
                 explicit_h: Optional[int] = None, aromatic: bool = False,
                 isotope: Optional[int] = None,
                 chiral: Optional[str] = None):
        self.element = element
        self.charge = charge
        self.explicit_h = explicit_h  # None => infer implicit H from valence
        self.aromatic = aromatic
        self.isotope = isotope
        self.chiral = chiral  # None | "@" | "@@" (tetrahedral tag)


class Mol:
    """Undirected molecular graph. Bond orders: 1, 2, 3 (aromatic = 1.5
    only transiently inside the SMILES parser, never on a finished Mol)."""

    def __init__(self):
        self.atoms: List[Atom] = []
        self.bonds: Dict[Tuple[int, int], float] = {}
        self.adj: List[List[int]] = []
        # Bond keys that lie in a perceived aromatic ring. Populated by
        # ``smiles.perceive_aromaticity`` (kekulized orders stay 1/2; this
        # set is what distinguishes a ring aromatic bond from e.g. a biaryl
        # single bond between two aromatic atoms — the Ertl TPSA table
        # classifies N/O environments by aromatic BONDS, not neighbors).
        self.aromatic_bonds: set = set()
        # Tetrahedral stereo: atom index -> its neighbors in SMILES
        # appearance order (-1 = the in-bracket implicit H). The writer
        # re-derives @/@@ for its own emission order by permutation parity
        # against this list (smiles.mol_to_smiles).
        self.stereo_order: Dict[int, List[int]] = {}
        # Directional (E/Z) single bonds: DIRECTED (u, v) -> "/" or "\\",
        # meaning the bond was written u->v with that symbol; the reverse
        # direction is stored flipped.
        self.bond_dirs: Dict[Tuple[int, int], str] = {}

    def add_atom(self, atom: Atom) -> int:
        self.atoms.append(atom)
        self.adj.append([])
        return len(self.atoms) - 1

    def add_bond(self, i: int, j: int, order: float) -> None:
        if i == j:
            raise ValueError("self-bond")
        key = (min(i, j), max(i, j))
        if key in self.bonds:
            raise ValueError(f"duplicate bond {key}")
        self.bonds[key] = order
        self.adj[i].append(j)
        self.adj[j].append(i)

    def bond_order(self, i: int, j: int) -> float:
        return self.bonds[(min(i, j), max(i, j))]

    def is_aromatic_bond(self, i: int, j: int) -> bool:
        return (min(i, j), max(i, j)) in self.aromatic_bonds

    def set_bond_order(self, i: int, j: int, order: float) -> None:
        self.bonds[(min(i, j), max(i, j))] = order

    def degree(self, i: int) -> int:
        return len(self.adj[i])

    def bond_sum(self, i: int) -> float:
        return sum(self.bonds[(min(i, j), max(i, j))] for j in self.adj[i])

    # ------------------------------------------------------------ hydrogens

    def implicit_h(self, i: int) -> int:
        """Hydrogens on atom i: the explicit bracket count if given, else
        the smallest allowed valence that accommodates the bond-order sum
        (standard SMILES implicit-H rule)."""
        a = self.atoms[i]
        if a.explicit_h is not None:
            return a.explicit_h
        bsum = self.bond_sum(i)
        for v in allowed_valences(a.element, a.charge):
            if v >= bsum:
                return int(v - bsum)
        return 0

    # ------------------------------------------------------------- validity

    def check_valence(self, i: int) -> bool:
        a = self.atoms[i]
        allowed = allowed_valences(a.element, a.charge)
        if not allowed:
            return False
        total = self.bond_sum(i) + self.implicit_h(i)
        if total != int(total):
            return False  # un-kekulized aromatic bond survived
        return int(total) in allowed

    def is_valid(self) -> bool:
        return len(self.atoms) > 0 and all(
            self.check_valence(i) for i in range(len(self.atoms)))

    def weight(self) -> float:
        w = 0.0
        for i, a in enumerate(self.atoms):
            w += ATOMIC_WEIGHTS.get(a.element, 0.0)
            w += ATOMIC_WEIGHTS["H"] * self.implicit_h(i)
        return w

    # ---------------------------------------------------------- fragments

    def components(self) -> List[List[int]]:
        """Connected components as sorted atom-index lists."""
        n = len(self.atoms)
        seen = [False] * n
        comps: List[List[int]] = []
        for s in range(n):
            if seen[s]:
                continue
            stack, comp = [s], []
            seen[s] = True
            while stack:
                u = stack.pop()
                comp.append(u)
                for v in self.adj[u]:
                    if not seen[v]:
                        seen[v] = True
                        stack.append(v)
            comps.append(sorted(comp))
        return comps

    def extract(self, atom_indices: List[int]) -> "Mol":
        """New Mol containing only ``atom_indices`` (bonds, stereo and
        bond directions remapped). The indices must be closed under
        bonding (a connected component qualifies)."""
        remap = {old: new for new, old in enumerate(atom_indices)}
        out = Mol()
        for old in atom_indices:
            a = self.atoms[old]
            out.add_atom(Atom(a.element, charge=a.charge,
                              explicit_h=a.explicit_h, aromatic=a.aromatic,
                              isotope=a.isotope, chiral=a.chiral))
        for (i, j), order in self.bonds.items():
            if i in remap and j in remap:
                out.add_bond(remap[i], remap[j], order)
        for i, order_list in self.stereo_order.items():
            if i in remap:
                out.stereo_order[remap[i]] = [
                    remap.get(x, -1) if x != -1 else -1 for x in order_list]
        for (u, v), d in self.bond_dirs.items():
            if u in remap and v in remap:
                out.bond_dirs[(remap[u], remap[v])] = d
        return out

    # ----------------------------------------------------------- ring info

    def ring_bonds(self) -> set:
        """Bond keys that lie on a cycle (found by removing bridges via a
        simple DFS bridge-finding pass)."""
        n = len(self.atoms)
        disc = [-1] * n
        low = [0] * n
        bridges = set()
        t = [0]

        def dfs(u: int, parent_edge: Optional[Tuple[int, int]]):
            stack = [(u, parent_edge, iter(self.adj[u]))]
            disc[u] = low[u] = t[0]
            t[0] += 1
            while stack:
                node, pedge, it = stack[-1]
                advanced = False
                for v in it:
                    key = (min(node, v), max(node, v))
                    if key == pedge:
                        continue
                    if disc[v] == -1:
                        disc[v] = low[v] = t[0]
                        t[0] += 1
                        stack.append((v, key, iter(self.adj[v])))
                        advanced = True
                        break
                    low[node] = min(low[node], disc[v])
                if not advanced:
                    stack.pop()
                    if stack:
                        pnode = stack[-1][0]
                        low[pnode] = min(low[pnode], low[node])
                        if low[node] > disc[pnode]:
                            bridges.add((min(pnode, node), max(pnode, node)))

        for s in range(n):
            if disc[s] == -1:
                dfs(s, None)
        return {k for k in self.bonds if k not in bridges}
