"""Bemis-Murcko scaffolds (pure Python).

The port's own copy of ``deepchem_tpu/chem/scaffolds.py``: ring systems
and the linkers between them, with atoms double-bonded to them kept and
each pruned substituent replaced by a hydrogen, as RDKit's
``MurckoScaffold``; stereo and isotopes dropped.
"""

from __future__ import annotations

from typing import Optional, Set

from .mol import BOND_DOUBLE, Molecule
from .smiles import mol_from_smiles
from .canon import mol_to_smiles


def murcko_scaffold(mol: Molecule) -> Molecule:
    """Return the Bemis-Murcko scaffold as a new Molecule (may be empty)."""
    n = mol.num_atoms
    if n == 0:
        return Molecule().finalize()
    keep = [a.in_ring for a in mol.atoms]
    # linkers: atoms on shortest paths between ring systems — equivalently,
    # iteratively prune non-ring terminal atoms until fixpoint.
    degree = [0] * n
    alive = [True] * n
    for b in mol.bonds:
        degree[b.a1] += 1
        degree[b.a2] += 1
    changed = True
    while changed:
        changed = False
        for i in range(n):
            if alive[i] and not keep[i] and degree[i] <= 1:
                alive[i] = False
                changed = True
                for j in mol.neighbors(i):
                    if alive[j]:
                        degree[j] -= 1
    # retain atoms double-bonded to the scaffold (exocyclic =O etc.)
    extra: Set[int] = set()
    for b in mol.bonds:
        if b.order == BOND_DOUBLE:
            if alive[b.a1] and not alive[b.a2]:
                extra.add(b.a2)
            elif alive[b.a2] and not alive[b.a1]:
                extra.add(b.a1)
    for i in extra:
        alive[i] = True
    kept = [i for i in range(n) if alive[i]]
    if not kept:
        return Molecule().finalize()
    sub = mol.subgraph(kept)
    # normalize: drop chirality/isotopes so the scaffold string only
    # reflects the skeleton; re-derive H counts from valence
    for a in sub.atoms:
        a.chirality = ''
        a.explicit_hs = -1
        a.isotope = 0
    sub.finalize()
    # RDKit GetScaffoldForMol semantics: every pruned substituent is
    # replaced by a hydrogen on the attachment atom.  Valence-based
    # re-perception gets this wrong exactly where it is ambiguous —
    # a demethylated pyrrole/amide nitrogen reads as pyridine-type
    # (0 H) instead of keeping the [nH] RDKit emits — which would shift
    # scaffold-split membership for N-substituted heterocycles.
    refix = False
    for pos, i in enumerate(kept):
        want = mol.atoms[i].total_hs + sum(
            1 for j in mol.neighbors(i) if not alive[j])
        if sub.atoms[pos].total_hs != want:
            sub.atoms[pos].explicit_hs = want
            refix = True
    return sub.finalize() if refix else sub


def scaffold_smiles(smiles: str,
                    include_chirality: bool = False) -> Optional[str]:
    """SMILES -> canonical Murcko scaffold SMILES ('' for acyclic molecules).

    Returns None if the SMILES cannot be parsed (caller drops the datapoint,
    as the scaffold splitter expects).
    """
    mol = mol_from_smiles(smiles)
    if mol is None:
        return None
    scaf = murcko_scaffold(mol)
    if scaf.num_atoms == 0:
        return ''
    return mol_to_smiles(scaf, canonical=True)
