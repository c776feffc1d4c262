"""Self-contained molecular graph model (no RDKit dependency).

Atoms, bonds, implicit-hydrogen/valence perception, ring perception,
aromaticity, hybridization and conjugation: the substrate the PAGTN
featurizer reads.  The port's own copy of ``deepchem_tpu/chem/mol.py``,
trimmed to what featurization needs; perception rules are unchanged, so
both packages featurize a SMILES string to the same arrays.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

PERIODIC_TABLE: Dict[str, int] = {
    'H': 1, 'He': 2, 'Li': 3, 'Be': 4, 'B': 5, 'C': 6, 'N': 7, 'O': 8,
    'F': 9, 'Ne': 10, 'Na': 11, 'Mg': 12, 'Al': 13, 'Si': 14, 'P': 15,
    'S': 16, 'Cl': 17, 'Ar': 18, 'K': 19, 'Ca': 20, 'Sc': 21, 'Ti': 22,
    'V': 23, 'Cr': 24, 'Mn': 25, 'Fe': 26, 'Co': 27, 'Ni': 28, 'Cu': 29,
    'Zn': 30, 'Ga': 31, 'Ge': 32, 'As': 33, 'Se': 34, 'Br': 35, 'Kr': 36,
    'Rb': 37, 'Sr': 38, 'Y': 39, 'Zr': 40, 'Nb': 41, 'Mo': 42, 'Tc': 43,
    'Ru': 44, 'Rh': 45, 'Pd': 46, 'Ag': 47, 'Cd': 48, 'In': 49, 'Sn': 50,
    'Sb': 51, 'Te': 52, 'I': 53, 'Xe': 54, 'Cs': 55, 'Ba': 56, 'La': 57,
    'Ce': 58, 'Pr': 59, 'Nd': 60, 'Pm': 61, 'Sm': 62, 'Eu': 63, 'Gd': 64,
    'Tb': 65, 'Dy': 66, 'Ho': 67, 'Er': 68, 'Tm': 69, 'Yb': 70, 'Lu': 71,
    'Hf': 72, 'Ta': 73, 'W': 74, 'Re': 75, 'Os': 76, 'Ir': 77, 'Pt': 78,
    'Au': 79, 'Hg': 80, 'Tl': 81, 'Pb': 82, 'Bi': 83, 'Po': 84, 'At': 85,
    'Rn': 86, 'Fr': 87, 'Ra': 88, 'Ac': 89, 'Th': 90, 'Pa': 91, 'U': 92,
    '*': 0,
}

ATOMIC_SYMBOL: Dict[int, str] = {v: k for k, v in PERIODIC_TABLE.items()}

ATOMIC_MASS: Dict[int, float] = {
    0: 0.0, 1: 1.008, 2: 4.003, 3: 6.94, 4: 9.012, 5: 10.81, 6: 12.011,
    7: 14.007, 8: 15.999, 9: 18.998, 10: 20.18, 11: 22.99, 12: 24.305,
    13: 26.982, 14: 28.085, 15: 30.974, 16: 32.06, 17: 35.45, 18: 39.948,
    19: 39.098, 20: 40.078, 26: 55.845, 29: 63.546, 30: 65.38, 33: 74.922,
    34: 78.971, 35: 79.904, 53: 126.904,
}

# Default (lowest) valences per element, in increasing order; implicit-H
# perception picks the smallest valence >= explicit bond order sum
# (Daylight SMILES semantics).
DEFAULT_VALENCES: Dict[int, Tuple[int, ...]] = {
    1: (1,), 5: (3,), 6: (4,), 7: (3, 5), 8: (2,), 9: (1,),
    15: (3, 5), 16: (2, 4, 6), 17: (1,), 35: (1,), 53: (1,),
    14: (4,), 34: (2, 4, 6), 33: (3, 5), 52: (2, 4, 6), 85: (1,),
}

# Organic subset: atoms that may be written bare (no brackets) in SMILES.
ORGANIC_SUBSET = {'B', 'C', 'N', 'O', 'P', 'S', 'F', 'Cl', 'Br', 'I', '*'}

# Bond orders.  Aromatic bonds carry order 1.5 for valence accounting.
BOND_SINGLE = 1.0
BOND_DOUBLE = 2.0
BOND_TRIPLE = 3.0
BOND_QUADRUPLE = 4.0
BOND_AROMATIC = 1.5

HYB_S = 'S'
HYB_SP = 'SP'
HYB_SP2 = 'SP2'
HYB_SP3 = 'SP3'
HYB_SP3D = 'SP3D'
HYB_SP3D2 = 'SP3D2'

# Chirality tags (tetrahedral parity as written in SMILES).
CHI_NONE = ''
CHI_CCW = '@'
CHI_CW = '@@'


@dataclass
class Atom:
    """An atom in a :class:`Molecule`."""
    atomic_num: int
    formal_charge: int = 0
    explicit_hs: int = -1          # -1 means "compute implicit H count"
    is_aromatic: bool = False
    isotope: int = 0
    chirality: str = CHI_NONE
    num_radical_electrons: int = 0
    # Filled in by Molecule.finalize():
    implicit_hs: int = 0
    degree: int = 0                # heavy-atom degree (explicit connections)
    in_ring: bool = False
    hybridization: str = HYB_SP3
    index: int = -1

    @property
    def symbol(self) -> str:
        return ATOMIC_SYMBOL.get(self.atomic_num, '*')

    @property
    def total_hs(self) -> int:
        return self.explicit_hs if self.explicit_hs >= 0 else self.implicit_hs

    @property
    def mass(self) -> float:
        if self.isotope:
            return float(self.isotope)
        return ATOMIC_MASS.get(self.atomic_num, 2.0 * self.atomic_num)

    @property
    def implicit_valence(self) -> int:
        """Implicit hydrogens: 0 for a bracket atom with its hydrogens
        written out, as RDKit's ``GetImplicitValence``."""
        return 0 if self.explicit_hs >= 0 else self.implicit_hs


@dataclass
class Bond:
    """A bond between two atoms (COO edge with an order and flags)."""
    a1: int
    a2: int
    order: float = BOND_SINGLE
    is_aromatic: bool = False
    in_ring: bool = False
    index: int = -1
    stereo_dir: str = ''           # '/' or '\\' as written, a1 to a2
    #: a double bond's configuration from the direction marks beside it:
    #: '', 'cis' or 'trans' of ``stereo_atoms`` = (x, y), x bonded to a1
    #: and y to a2
    stereo: str = ''
    stereo_atoms: Optional[Tuple[int, int]] = None

    @property
    def is_conjugated(self) -> bool:
        # set by Molecule._perceive_conjugation; aromatic bonds until then
        return getattr(self, '_conjugated', self.is_aromatic)

    def other(self, idx: int) -> int:
        return self.a2 if idx == self.a1 else self.a1

    def type_name(self) -> str:
        if self.is_aromatic or self.order == BOND_AROMATIC:
            return 'AROMATIC'
        if self.order == BOND_SINGLE:
            return 'SINGLE'
        if self.order == BOND_DOUBLE:
            return 'DOUBLE'
        if self.order == BOND_TRIPLE:
            return 'TRIPLE'
        return 'OTHER'


class Molecule:
    """A molecular graph with perception utilities.

    Construction: add atoms/bonds then call :meth:`finalize` (the SMILES
    parser does this).  ``finalize`` computes implicit hydrogens,
    heavy-atom degrees, ring membership, aromaticity, hybridization and
    conjugation flags.
    """

    def __init__(self) -> None:
        self.atoms: List[Atom] = []
        self.bonds: List[Bond] = []
        self._adj: List[List[int]] = []      # atom idx -> list of bond indices
        self._ring_info: Optional[List[List[int]]] = None
        #: 3D coordinates, one (x, y, z) an atom (an SDF's, or an
        #: embedding's from ``utils/conformers.py``); None without them
        self.conformer: Optional[List[Tuple[float, float, float]]] = None

    # -- construction ------------------------------------------------------
    def add_atom(self, atom: Atom) -> int:
        atom.index = len(self.atoms)
        self.atoms.append(atom)
        self._adj.append([])
        return atom.index

    def add_bond(self, a1: int, a2: int, order: float = BOND_SINGLE,
                 is_aromatic: bool = False, stereo_dir: str = '') -> int:
        if a1 == a2:
            raise ValueError('self-bond')
        for bi in self._adj[a1]:
            if self.bonds[bi].other(a1) == a2:
                raise ValueError(f'duplicate bond {a1}-{a2}')
        bond = Bond(a1, a2, order=order, is_aromatic=is_aromatic,
                    stereo_dir=stereo_dir)
        bond.index = len(self.bonds)
        self.bonds.append(bond)
        self._adj[a1].append(bond.index)
        self._adj[a2].append(bond.index)
        return bond.index

    # -- queries -----------------------------------------------------------
    @property
    def num_atoms(self) -> int:
        return len(self.atoms)

    @property
    def num_bonds(self) -> int:
        return len(self.bonds)

    def neighbors(self, idx: int) -> List[int]:
        """The atoms bonded to atom ``idx``, in bond order."""
        return [self.bonds[bi].other(idx) for bi in self._adj[idx]]

    def atom_bonds(self, idx: int) -> List[Bond]:
        return [self.bonds[bi] for bi in self._adj[idx]]

    def get_bond(self, a1: int, a2: int) -> Optional[Bond]:
        for bi in self._adj[a1]:
            b = self.bonds[bi]
            if b.other(a1) == a2:
                return b
        return None

    # -- perception --------------------------------------------------------
    def finalize(self) -> 'Molecule':
        self._perceive_rings()
        self._perceive_hydrogens()
        self._perceive_aromaticity()
        self._perceive_hybridization()
        self._perceive_conjugation()
        return self

    def _perceive_hydrogens(self) -> None:
        for atom in self.atoms:
            bond_sum = 0.0
            deg = len(self._adj[atom.index])
            for bi in self._adj[atom.index]:
                o = self.bonds[bi].order
                if o == 1.5:
                    # kekulé-single aromatic bonds: aromatic O/S never
                    # donate a ring double bond (thiophene/furan type),
                    # and 3-connected aromatic N is pyrrole-type (donates
                    # its lone pair) — else S/N would count one valence
                    # slot high and gain a bogus implicit H
                    if atom.atomic_num in (8, 16) \
                            or (atom.atomic_num == 7 and deg == 3):
                        o = 1.0
                bond_sum += o
            atom.degree = deg
            if atom.explicit_hs >= 0:
                atom.implicit_hs = 0
                continue
            # Daylight rule: implicit H fills up to the smallest standard
            # valence >= ceil(bond order sum); charges shift the valence.
            order = math.ceil(bond_sum - 1e-9)
            valences = DEFAULT_VALENCES.get(atom.atomic_num)
            if valences is None:
                atom.implicit_hs = 0
                continue
            charge = atom.formal_charge
            z = atom.atomic_num
            if z in (7, 15, 8, 16):   # N,P,O,S: valence moves with charge
                shift = charge
            elif z == 5:              # B: borate [B-] is tetravalent
                shift = -charge
            else:                     # C and others: any charge drops a slot
                shift = -abs(charge)
            hs = 0
            for v in valences:
                cap = v + shift
                if cap >= order:
                    hs = cap - order
                    break
            atom.implicit_hs = max(0, hs - atom.num_radical_electrons)

    def _perceive_rings(self) -> None:
        """Mark atoms/bonds in rings via bridge detection (Tarjan)."""
        n = self.num_atoms
        visited = [False] * n
        disc = [0] * n
        low = [0] * n
        timer = 1
        bridges = set()
        for root in range(n):
            if visited[root]:
                continue
            stack = [(root, -1, iter(self._adj[root]))]
            visited[root] = True
            disc[root] = low[root] = timer
            timer += 1
            while stack:
                u, parent_bond, it = stack[-1]
                advanced = False
                for bi in it:
                    if bi == parent_bond:
                        continue
                    v = self.bonds[bi].other(u)
                    if not visited[v]:
                        visited[v] = True
                        disc[v] = low[v] = timer
                        timer += 1
                        stack.append((v, bi, iter(self._adj[v])))
                        advanced = True
                        break
                    low[u] = min(low[u], disc[v])
                if not advanced:
                    stack.pop()
                    if stack:
                        pu = stack[-1][0]
                        low[pu] = min(low[pu], low[u])
                        if low[u] > disc[pu]:
                            bridges.add(parent_bond)
        for b in self.bonds:
            b.in_ring = b.index not in bridges
        for a in self.atoms:
            a.in_ring = any(self.bonds[bi].in_ring for bi in self._adj[a.index])
        self._ring_info = None

    def rings(self) -> List[List[int]]:
        """Greedy small-rings set (approximate SSSR): for each ring bond, the
        shortest cycle through it; deduplicated."""
        if self._ring_info is not None:
            return self._ring_info
        found = {}
        for bond in self.bonds:
            if not bond.in_ring:
                continue
            # BFS shortest path a1->a2 avoiding the bond itself
            src, dst = bond.a1, bond.a2
            prev = {src: (-1, -1)}
            dq = deque([src])
            while dq:
                u = dq.popleft()
                if u == dst:
                    break
                for bi in self._adj[u]:
                    if bi == bond.index:
                        continue
                    b = self.bonds[bi]
                    if not b.in_ring:
                        continue
                    v = b.other(u)
                    if v not in prev:
                        prev[v] = (u, bi)
                        dq.append(v)
            if dst not in prev:
                continue
            path = [dst]
            u = dst
            while u != src:
                u = prev[u][0]
                path.append(u)
            key = tuple(sorted(path))
            if key not in found or len(path) < len(found[key]):
                found[key] = path
        self._ring_info = sorted(found.values(), key=len)
        return self._ring_info

    def _perceive_aromaticity(self) -> None:
        """Hückel 4n+2 aromatization of kekulé-written rings.

        Only ADDS aromaticity — lowercase/flagged input keeps its flags.
        Per-atom electron contributions: ring or fused-ring double bond
        -> 1; exocyclic double to N/O/S -> 0; lone-pair donor N/P/O/S or
        C- -> 2; C+ -> 0; exocyclic C=C or sp3 atoms disqualify the ring.
        """
        rings = [r for r in self.rings() if 5 <= len(r) <= 7]
        if not rings:
            return
        changed = True
        while changed:
            changed = False
            dbl = {}
            for b in self.bonds:
                if b.order == BOND_DOUBLE:
                    dbl.setdefault(b.a1, []).append(b.a2)
                    dbl.setdefault(b.a2, []).append(b.a1)
            for ring in rings:
                rset = set(ring)
                bonds = [self.get_bond(ring[i], ring[(i + 1) % len(ring)])
                         for i in range(len(ring))]
                if any(b is None for b in bonds):
                    continue
                if all(b.order == BOND_AROMATIC for b in bonds):
                    continue
                pi = 0
                donors = []
                ok = True
                for i in ring:
                    a = self.atoms[i]
                    partners = dbl.get(i, [])
                    if len(partners) > 1:         # cumulated: sp carbon
                        ok = False
                        break
                    if partners:
                        p = partners[0]
                        pb = self.get_bond(i, p)
                        if p in rset or (pb is not None and pb.in_ring):
                            pi += 1               # (fused-)ring double bond
                        elif self.atoms[p].atomic_num in (7, 8, 16, 34) \
                                and not self.atoms[p].in_ring:
                            pi += 0               # carbonyl-type exocyclic
                        else:
                            ok = False            # exocyclic C=C: fulvene
                            break
                    elif a.is_aromatic:
                        pi += 1
                    elif a.atomic_num in (7, 15) and a.formal_charge == 0 \
                            and a.degree + a.total_hs <= 3:
                        pi += 2                   # pyrrole-type lone pair
                        donors.append(a)
                    elif a.atomic_num in (8, 16, 34) \
                            and a.formal_charge == 0 and a.degree == 2:
                        pi += 2                   # furan/thiophene O/S
                    elif a.atomic_num == 6 and a.formal_charge == -1:
                        pi += 2                   # cyclopentadienyl anion
                        donors.append(a)
                    elif a.atomic_num == 6 and a.formal_charge == 1:
                        pi += 0                   # tropylium cation
                    else:
                        ok = False                # sp3 / no π electrons
                        break
                if not ok or pi % 4 != 2:
                    continue
                # donor-N hydrogens become explicit ([nH]) so the 1.5 bond
                # orders do not drop them on re-perception
                for a in donors:
                    if a.explicit_hs < 0:
                        a.explicit_hs = a.total_hs
                for i in ring:
                    self.atoms[i].is_aromatic = True
                for b in bonds:
                    b.order = BOND_AROMATIC
                    b.is_aromatic = True
                changed = True

    def _perceive_hybridization(self) -> None:
        for atom in self.atoms:
            if atom.is_aromatic:
                atom.hybridization = HYB_SP2
                continue
            n_double = sum(1 for b in self.atom_bonds(atom.index)
                           if b.order == BOND_DOUBLE)
            n_triple = sum(1 for b in self.atom_bonds(atom.index)
                           if b.order == BOND_TRIPLE)
            heavy = atom.degree + atom.total_hs
            if n_triple or n_double >= 2:
                atom.hybridization = HYB_SP
            elif n_double == 1:
                atom.hybridization = HYB_SP2
            elif heavy > 6:
                atom.hybridization = HYB_SP3D2
            elif heavy > 4:
                atom.hybridization = HYB_SP3D
            elif heavy <= 1 and atom.degree <= 1 and atom.atomic_num in (1,):
                atom.hybridization = HYB_S
            else:
                atom.hybridization = HYB_SP3

    def _perceive_conjugation(self) -> None:
        """A bond is conjugated if both end atoms are sp2/sp/aromatic."""
        def pi_capable(a: Atom) -> bool:
            return a.is_aromatic or a.hybridization in (HYB_SP, HYB_SP2)
        for b in self.bonds:
            conj = (b.is_aromatic or
                    (pi_capable(self.atoms[b.a1]) and
                     pi_capable(self.atoms[b.a2])))
            object.__setattr__(b, '_conjugated', conj)

    def subgraph(self, atom_indices: Sequence[int]) -> 'Molecule':
        """The finalized molecule induced on ``atom_indices``, in their
        order, with the bonds among them."""
        keep = {a: i for i, a in enumerate(atom_indices)}
        out = Molecule()
        for a in atom_indices:
            old = self.atoms[a]
            out.add_atom(Atom(
                atomic_num=old.atomic_num, formal_charge=old.formal_charge,
                explicit_hs=old.explicit_hs, is_aromatic=old.is_aromatic,
                isotope=old.isotope, chirality=old.chirality,
                num_radical_electrons=old.num_radical_electrons))
        for b in self.bonds:
            if b.a1 in keep and b.a2 in keep:
                out.add_bond(keep[b.a1], keep[b.a2], order=b.order,
                             is_aromatic=b.is_aromatic)
        return out.finalize()

    def __repr__(self) -> str:
        return f'<Molecule atoms={self.num_atoms} bonds={self.num_bonds}>'
