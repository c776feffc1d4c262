"""Atom/bond one-hot helpers used by the PAGTN featurizer."""

from __future__ import annotations

from typing import Any, List, Sequence

from deepchem_tpu_torch.chem.mol import Atom, Bond

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
