"""Atom/bond one-hot helpers of the PAGTN and MolGraphConv featurizers,
the hydrogen-bond donor and acceptor rule, and the 75-column atom
features of the GraphConv featurizer."""

from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np

from deepchem_tpu_torch.chem.mol import Atom, Bond, Molecule

# the GraphConv featurizer's atom symbol vocabulary (44 symbols)
GRAPH_CONV_SYMBOLS = [
    'C', 'N', 'O', 'S', 'F', 'Si', 'P', 'Cl', 'Br', 'Mg', 'Na', 'Ca', 'Fe',
    'As', 'Al', 'I', 'B', 'V', 'K', 'Tl', 'Yb', 'Sb', 'Sn', 'Ag', 'Pd', 'Co',
    'Se', 'Ti', 'Zn', 'H', 'Li', 'Ge', 'Cu', 'Au', 'Ni', 'Cd', 'In', 'Mn',
    'Zr', 'Cr', 'Pt', 'Hg', 'Pb', 'Unknown',
]

# MolGraphConvFeaturizer's atom types
DEFAULT_ATOM_TYPES = ['C', 'N', 'O', 'F', 'P', 'S', 'Cl', 'Br', 'I']
DEFAULT_HYBRIDIZATIONS = ['SP', 'SP2', 'SP3']
DEFAULT_BOND_TYPES = ['SINGLE', 'DOUBLE', 'TRIPLE', 'AROMATIC']


def one_hot_encode(val: Any, allowable_set: Sequence,
                   include_unknown_set: bool = False) -> List[float]:
    """One-hot of ``val`` over ``allowable_set``; with
    ``include_unknown_set`` a trailing slot takes values outside it,
    otherwise they encode as all zeros."""
    vec = [0.0] * (len(allowable_set) + (1 if include_unknown_set else 0))
    try:
        idx = list(allowable_set).index(val)
    except ValueError:
        if not include_unknown_set:
            return vec
        idx = len(allowable_set)
    vec[idx] = 1.0
    return vec


def get_atom_type_one_hot(atom: Atom, allowable_set=DEFAULT_ATOM_TYPES,
                          include_unknown_set: bool = True) -> List[float]:
    return one_hot_encode(atom.symbol, allowable_set, include_unknown_set)


def get_atom_formal_charge(atom: Atom) -> List[float]:
    return [float(atom.formal_charge)]


def get_atom_total_num_Hs_one_hot(atom: Atom,
                                  allowable_set=(0, 1, 2, 3, 4),
                                  include_unknown_set: bool = True
                                  ) -> List[float]:
    return one_hot_encode(atom.total_hs, list(allowable_set),
                          include_unknown_set)


def get_atom_is_in_aromatic_one_hot(atom: Atom) -> List[float]:
    return [float(atom.is_aromatic)]


def get_atom_total_degree_one_hot(atom: Atom,
                                  allowable_set=(0, 1, 2, 3, 4, 5),
                                  include_unknown_set: bool = True
                                  ) -> List[float]:
    return one_hot_encode(atom.degree, list(allowable_set),
                          include_unknown_set)


def get_atom_partial_charge(atom: Atom) -> List[float]:
    """0.0: Gasteiger charges need RDKit, which neither package uses."""
    return [0.0]


def get_atom_chirality_one_hot(atom: Atom) -> List[float]:
    """[R, S] as the SMILES parity marks give them: ``@@`` and ``@``."""
    return [float(atom.chirality == '@@'), float(atom.chirality == '@')]


def get_atom_hybridization_one_hot(
        atom: Atom, allowable_set=DEFAULT_HYBRIDIZATIONS,
        include_unknown_set: bool = False) -> List[float]:
    return one_hot_encode(atom.hybridization, allowable_set,
                          include_unknown_set)


def get_bond_type_one_hot(bond: Bond,
                          allowable_set=DEFAULT_BOND_TYPES,
                          include_unknown_set: bool = False) -> List[float]:
    return one_hot_encode(bond.type_name(), allowable_set,
                          include_unknown_set)


def get_bond_is_in_same_ring_one_hot(bond: Bond) -> List[float]:
    return [float(bond.in_ring)]


def get_bond_is_conjugated_one_hot(bond: Bond) -> List[float]:
    return [float(bond.is_conjugated)]


def get_bond_stereo_one_hot(bond: Bond) -> List[float]:
    """[NONE, ANY, Z, E, CIS, TRANS] of a bond: CIS or TRANS where its
    configuration was perceived, ANY where it carries a direction mark
    without one, else NONE."""
    vec = [0.0] * 6
    if bond.stereo == 'cis':
        vec[4] = 1.0
    elif bond.stereo == 'trans':
        vec[5] = 1.0
    elif bond.stereo_dir:
        vec[1] = 1.0
    else:
        vec[0] = 1.0
    return vec


def construct_hydrogen_bonding_info(mol: Molecule):
    """``[(atom index, 'Donor' or 'Acceptor')]``: N and O accept, and
    donate where they carry a hydrogen; F accepts."""
    out = []
    for a in mol.atoms:
        if a.atomic_num in (7, 8):
            if a.total_hs > 0:
                out.append((a.index, 'Donor'))
            out.append((a.index, 'Acceptor'))
        if a.atomic_num == 9:
            out.append((a.index, 'Acceptor'))
    return out


_SYM75_IDX = {s: i for i, s in enumerate(GRAPH_CONV_SYMBOLS[:-1])}
_HYB75_IDX = {'SP': 0, 'SP2': 1, 'SP3': 2, 'SP3D': 3, 'SP3D2': 4}


def atom_features_75_mol(mol: Molecule, use_chirality: bool = False,
                         hydrogens_implicit: bool = True) -> np.ndarray:
    """``[n_atoms, 75]`` float32 atom features of a molecule, column by
    column as the JAX package's: symbol one-hot (44, the last for any other
    element), degree 0-10 (11), implicit valence 0-6 (7), formal charge,
    radical electrons, hybridization SP..SP3D2 (5), aromatic, total
    hydrogens 0-4 (5; with ``hydrogens_implicit``); with ``use_chirality``
    three more: R (``@@``), S (``@``), and a column of zeros."""
    n = mol.num_atoms
    width = 70 + (5 if hydrogens_implicit else 0) \
        + (3 if use_chirality else 0)
    out = np.zeros((n, width), dtype=np.float32)
    for i, a in enumerate(mol.atoms):
        row = out[i]
        row[_SYM75_IDX.get(a.symbol, 43)] = 1.0
        if 0 <= a.degree < 11:
            row[44 + a.degree] = 1.0
        iv = a.implicit_valence
        if 0 <= iv < 7:
            row[55 + iv] = 1.0
        row[62] = a.formal_charge
        row[63] = a.num_radical_electrons
        h = _HYB75_IDX.get(a.hybridization)
        if h is not None:
            row[64 + h] = 1.0
        row[69] = 1.0 if a.is_aromatic else 0.0
        col = 70
        if hydrogens_implicit:
            if 0 <= a.total_hs < 5:
                row[70 + a.total_hs] = 1.0
            col = 75
        if use_chirality:
            row[col] = 1.0 if a.chirality == '@@' else 0.0
            row[col + 1] = 1.0 if a.chirality == '@' else 0.0
    return out
