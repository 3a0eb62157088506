"""Drug-like molecule corpus generation.

The reference trains on ChEMBL-CNS SELFIES whose blob is absent from its
repo (``reference/.MISSING_LARGE_BLOBS:1``), and this image has no
network egress to fetch a public set. This module therefore produces a
*realistic* corpus two ways:

* ``KNOWN_DRUGS`` — a curated list of real, well-known drug / natural-
  product molecules (written from their published structures), used as a
  golden set in tests and seeded into generated corpora;
* ``generate_smiles`` — a deterministic fragment-assembly generator:
  scaffold rings + substituents/linkers drawn from medicinal-chemistry
  vocabulary, attached only at hydrogen-bearing positions so every
  product is valence-correct by construction. The output distribution
  (MW ~150-450, TPSA ~20-120, mixed aromatic/aliphatic, 0-4 substituents)
  is shaped to resemble a CNS-leaning screening library — real chemistry
  with real Ertl TPSA spread, which is what the conditional VAE needs.

Everything is pure Python on the vendored toolkit; molecules are
deduplicated by canonical SMILES.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from mlx_vae_tpu_torch.chem.mol import Atom, Mol
from mlx_vae_tpu_torch.chem.smiles import mol_from_smiles, mol_to_smiles

# Real molecules, written from their published structures. Each parses
# with the vendored toolkit (enforced by tests/test_chem.py).
KNOWN_DRUGS: List[Tuple[str, str]] = [
    ("aspirin", "CC(=O)Oc1ccccc1C(=O)O"),
    ("paracetamol", "CC(=O)Nc1ccc(O)cc1"),
    ("caffeine", "Cn1cnc2c1c(=O)n(C)c(=O)n2C"),
    ("ibuprofen", "CC(C)Cc1ccc(cc1)C(C)C(=O)O"),
    ("naproxen", "COc1ccc2cc(ccc2c1)C(C)C(=O)O"),
    ("nicotine", "CN1CCCC1c1cccnc1"),
    ("amphetamine", "CC(N)Cc1ccccc1"),
    ("benzocaine", "CCOC(=O)c1ccc(N)cc1"),
    ("procaine", "CCN(CC)CCOC(=O)c1ccc(N)cc1"),
    ("lidocaine", "CCN(CC)CC(=O)Nc1c(C)cccc1C"),
    ("phenytoin", "O=C1NC(=O)C(N1)(c1ccccc1)c1ccccc1"),
    ("phenobarbital", "CCC1(c2ccccc2)C(=O)NC(=O)NC1=O"),
    ("diazepam_core", "CN1c2ccccc2C(=NCC1=O)c1ccccc1"),
    ("carbamazepine_core", "NC(=O)N1c2ccccc2C=Cc2ccccc21"),
    ("imipramine", "CN(C)CCCN1c2ccccc2CCc2ccccc21"),
    ("fluoxetine_core", "CNCCC(Oc1ccc(cc1)C(F)(F)F)c1ccccc1"),
    ("tryptamine", "NCCc1c[nH]c2ccccc12"),
    ("serotonin", "NCCc1c[nH]c2ccc(O)cc12"),
    ("melatonin", "CC(=O)NCCc1c[nH]c2ccc(OC)cc12"),
    ("dopamine", "NCCc1ccc(O)c(O)c1"),
    ("adrenaline", "CNCC(O)c1ccc(O)c(O)c1"),
    ("histamine", "NCCc1c[nH]cn1"),
    ("salbutamol", "CC(C)(C)NCC(O)c1ccc(O)c(CO)c1"),
    ("metoprolol_core", "CC(C)NCC(O)COc1ccc(CCOC)cc1"),
    ("atenolol", "CC(C)NCC(O)COc1ccc(CC(N)=O)cc1"),
    ("propranolol", "CC(C)NCC(O)COc1cccc2ccccc12"),
    ("warfarin_core", "CC(=O)CC(c1ccccc1)c1c(O)c2ccccc2oc1=O"),
    ("coumarin", "O=c1ccc2ccccc2o1"),
    ("quinoline", "c1ccc2ncccc2c1"),
    ("isoniazid", "NNC(=O)c1ccncc1"),
    ("pyrazinamide", "NC(=O)c1cnccn1"),
    ("metronidazole", "Cc1ncc(n1CCO)[N+](=O)[O-]"),
    ("sulfanilamide", "Nc1ccc(cc1)S(=O)(=O)N"),
    ("sulfamethoxazole_core", "Cc1cc(no1)NS(=O)(=O)c1ccc(N)cc1"),
    ("trimethoprim", "COc1cc(Cc2cnc(N)nc2N)cc(OC)c1OC"),
    ("methotrexate_fragment", "CN(Cc1cnc2nc(N)nc(N)c2n1)c1ccc(cc1)C(=O)O"),
    ("theophylline", "Cn1c2c(nc[nH]2)c(=O)n(C)c1=O"),
    ("allopurinol_core", "O=c1[nH]cnc2[nH]ncc12"),
    ("uracil", "O=c1cc[nH]c(=O)[nH]1"),
    ("thymine", "Cc1c[nH]c(=O)[nH]c1=O"),
    ("cytosine", "Nc1cc[nH]c(=O)n1"),
    ("adenine", "Nc1ncnc2[nH]cnc12"),
    ("guanine", "Nc1nc2[nH]cnc2c(=O)[nH]1"),
    ("nicotinamide", "NC(=O)c1cccnc1"),
    ("pyridoxine", "Cc1ncc(CO)c(CO)c1O"),
    ("ascorbic_fragment", "OCC(O)C1OC(=O)C(O)=C1O"),
    ("citric_acid", "OC(=O)CC(O)(CC(=O)O)C(=O)O"),
    ("ketamine", "CNC1(CCCCC1=O)c1ccccc1Cl"),
    ("tramadol_core", "CN(C)CC1CCCCC1(O)c1cccc(OC)c1"),
    ("gabapentin", "NCC1(CC(=O)O)CCCCC1"),
    ("pregabalin", "CC(C)CC(CN)CC(=O)O"),
    ("baclofen", "NC(Cc1ccc(Cl)cc1)CC(=O)O"),
    ("levodopa", "NC(Cc1ccc(O)c(O)c1)C(=O)O"),
    ("phenylalanine", "NC(Cc1ccccc1)C(=O)O"),
    ("tyrosine", "NC(Cc1ccc(O)cc1)C(=O)O"),
    ("tryptophan", "NC(Cc1c[nH]c2ccccc12)C(=O)O"),
    ("histidine", "NC(Cc1c[nH]cn1)C(=O)O"),
    ("caffeic_acid", "OC(=O)C=Cc1ccc(O)c(O)c1"),
    ("vanillin", "COc1cc(C=O)ccc1O"),
    ("eugenol", "C=CCc1ccc(O)c(OC)c1"),
    ("thymol", "CC(C)c1ccc(C)cc1O"),
    ("menthol", "CC(C)C1CCC(C)CC1O"),
    ("camphor_core", "CC1(C)C2CCC1(C)C(=O)C2"),
    ("nicotinic_acid", "OC(=O)c1cccnc1"),
    ("piracetam", "NC(=O)CN1CCCC1=O"),
    ("modafinil_core", "NC(=O)CS(=O)C(c1ccccc1)c1ccccc1"),
    ("bupropion_core", "CC(NC(C)(C)C)C(=O)c1cccc(Cl)c1"),
    ("venlafaxine_core", "CN(C)CC(c1ccc(OC)cc1)C1(O)CCCCC1"),
    ("donepezil_fragment", "COc1cc2CC(CC3CCN(Cc4ccccc4)CC3)C(=O)c2cc1OC"),
    ("memantine_core", "CC12CC3CC(C)(C1)CC(N)(C2)C3"),
    ("amantadine", "NC12CC3CC(CC(C3)C1)C2"),
]

# ------------------------------------------------------ fragment library

SCAFFOLDS: List[str] = [
    "c1ccccc1", "c1ccncc1", "c1cncnc1", "c1ccc2ccccc2c1", "c1ccc2ncccc2c1",
    "c1ccc2c(c1)cc[nH]2", "c1ccc2[nH]cnc2c1", "c1cc[nH]c1", "c1c[nH]cn1",
    "c1cc[nH]n1", "c1ocnc1", "c1scnc1", "c1ccoc1", "c1ccsc1",
    "C1CCCCC1", "C1CCCC1", "C1CCNCC1", "C1CNCCN1", "C1COCCN1", "C1CCOC1",
    "c1cnc2[nH]ccc2c1", "c1ccc2OCOc2c1", "C1CC1", "c1cnoc1",
]

# Substituents: the FIRST atom of the SMILES is the attachment point
# (it must tolerate one extra single bond).
SUBSTITUENTS: List[str] = [
    "C", "CC", "CCC", "C(C)C", "C(C)(C)C", "F", "Cl", "Br", "O", "OC",
    "OCC", "N", "NC", "N(C)C", "C#N", "C(F)(F)F", "C(=O)O", "C(=O)OC",
    "C(=O)N", "C(=O)NC", "C(=O)C", "S(=O)(=O)N", "S(=O)(=O)C", "SC",
    "[N+](=O)[O-]", "C=C", "CO", "CCO", "CN", "CCN", "C(=O)NCC",
    "OC(F)(F)F", "CC#N", "CC(=O)O", "NS(=O)(=O)C", "NC(=O)C",
]

# Ring-bearing substituents (attachment atom first).
RING_SUBSTITUENTS: List[str] = [
    "c1ccccc1", "Cc1ccccc1", "Oc1ccccc1", "OCc1ccccc1", "Nc1ccccc1",
    "c1ccncc1", "Cc1ccncc1", "N1CCOCC1", "N1CCNCC1", "N1CCN(C)CC1",
    "C(=O)N1CCOCC1", "N1CCCC1", "N1CCCCC1", "CN1CCOCC1", "C1CC1",
    "CC1CC1", "NC(=O)c1ccccc1", "C(=O)Nc1ccccc1", "Cn1ccnc1",
]

_parsed_cache: dict = {}


def _parsed(smiles: str) -> Mol:
    mol = _parsed_cache.get(smiles)
    if mol is None:
        # Fragments may carry an unsatisfied attachment valence (e.g. the
        # nitro group), so parse leniently: syntax + kekulization only,
        # full validity is checked on the assembled molecule.
        from mlx_vae_tpu_torch.chem.smiles import kekulize, parse_smiles
        mol = parse_smiles(smiles)
        kekulize(mol)
        _parsed_cache[smiles] = mol
    return mol


def _copy_mol(m: Mol) -> Mol:
    out = Mol()
    for a in m.atoms:
        out.add_atom(Atom(a.element, a.charge, a.explicit_h, a.aromatic,
                          a.isotope))
    for (i, j), o in m.bonds.items():
        out.add_bond(i, j, o)
    return out


def _can_take_bond(mol: Mol, i: int) -> bool:
    """Atom i can accept one more single bond: it has a hydrogen to give,
    or (bracket atoms like the nitro N+) spare capacity below its max
    allowed valence."""
    from mlx_vae_tpu_torch.chem.mol import allowed_valences
    a = mol.atoms[i]
    vals = allowed_valences(a.element, a.charge)
    if not vals:
        return False
    h = mol.implicit_h(i)
    if h >= 1:
        return True
    return mol.bond_sum(i) + h + 1 <= max(vals)


def _attach(base: Mol, site: int, frag: Mol) -> bool:
    """Graft ``frag`` onto ``base`` with a single bond base[site]-frag[0].
    Returns False (base unchanged) if either endpoint cannot take the
    bond."""
    if not (_can_take_bond(base, site) and _can_take_bond(frag, 0)):
        return False
    off = len(base.atoms)
    for a in frag.atoms:
        base.add_atom(Atom(a.element, a.charge, a.explicit_h, a.aromatic,
                           a.isotope))
    for (i, j), o in frag.bonds.items():
        base.add_bond(i + off, j + off, o)
    base.add_bond(site, off, 1.0)
    for idx in (site, off):
        a = base.atoms[idx]
        if a.explicit_h is not None and a.explicit_h > 0 \
                and not base.check_valence(idx):
            a.explicit_h -= 1  # the new bond consumes one hydrogen
    return base.check_valence(site) and base.check_valence(off)


def _h_sites(mol: Mol, rng: np.random.Generator,
             elements=("C", "N")) -> List[int]:
    sites = [i for i, a in enumerate(mol.atoms)
             if a.element in elements and mol.implicit_h(i) >= 1]
    rng.shuffle(sites)
    return sites


def _random_molecule(rng: np.random.Generator) -> Optional[str]:
    mol = _copy_mol(_parsed(SCAFFOLDS[int(rng.integers(len(SCAFFOLDS)))]))
    n_subs = int(rng.choice([0, 1, 1, 2, 2, 2, 3, 3, 4]))
    for _ in range(n_subs):
        sites = _h_sites(mol, rng)
        if not sites:
            break
        pool = RING_SUBSTITUENTS if rng.random() < 0.25 else SUBSTITUENTS
        frag = _copy_mol(_parsed(pool[int(rng.integers(len(pool)))]))
        if not _attach(mol, sites[0], frag):
            return None  # rare (charged attachment corner); just reroll
    if not mol.is_valid():
        return None
    return mol_to_smiles(mol)


def generate_smiles(n: int, seed: int = 0,
                    include_known: bool = True) -> List[str]:
    """Deterministically generate ``n`` unique drug-like SMILES."""
    rng = np.random.default_rng(seed)
    out: List[str] = []
    seen = set()
    if include_known:
        for _, smi in KNOWN_DRUGS:
            can = mol_to_smiles(mol_from_smiles(smi))
            if can not in seen:
                seen.add(can)
                out.append(smi)
            if len(out) >= n:
                return out[:n]
    attempts = 0
    while len(out) < n:
        attempts += 1
        if attempts > 50 * n:
            raise RuntimeError("corpus generation stalled")
        smi = _random_molecule(rng)
        if smi is None or smi in seen:
            continue
        seen.add(smi)
        out.append(smi)
    return out


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="Generate a drug-like SMILES corpus (one per line)")
    ap.add_argument("--output", required=True)
    ap.add_argument("--n", type=int, default=50000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    smiles = generate_smiles(args.n, seed=args.seed)
    with open(args.output, "w") as f:
        f.write("\n".join(smiles) + "\n")
    print(f"Wrote {len(smiles)} molecules -> {args.output}")


if __name__ == "__main__":
    main()
