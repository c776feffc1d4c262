"""Conformer graphs: a molecule's MolGraphConv graph with 3D positions.

Counterparts of ``deepchem_tpu/feat/conformer_featurizers.py``'s
``_positions`` and ``RDKitConformerFeaturizer``: the graph is
:class:`MolGraphConvFeaturizer` with bond features (30 atom and 11 bond
features), the positions the molecule's conformer where it has one, else
the port's own distance-geometry embedding
(:func:`~deepchem_tpu_torch.utils.conformers.embed_molecule_3d`).
"""

from __future__ import annotations

from typing import List

import numpy as np

from deepchem_tpu_torch.chem.mol import Molecule
from deepchem_tpu_torch.feat.base import MolecularFeaturizer
from deepchem_tpu_torch.feat.graph_data import GraphData
from deepchem_tpu_torch.feat.molecule_featurizers import \
    MolGraphConvFeaturizer
from deepchem_tpu_torch.utils.conformers import embed_molecule_3d


def _positions(mol: Molecule) -> np.ndarray:
    """``[N, 3]`` float32: the molecule's conformer, else its embedding."""
    if mol.conformer is not None:
        return np.asarray(mol.conformer, dtype=np.float32)
    return np.asarray(embed_molecule_3d(mol), dtype=np.float32)


class RDKitConformerFeaturizer(MolecularFeaturizer):
    """``GraphData`` with 3D positions in ``node_pos_features``: the
    MolGraphConv graph with bond features, and the positions ``[N, 3]``,
    stacked ``num_conformers`` times (``[k N, 3]``) where it is above 1,
    as the JAX package stacks them.  The OGB-style index features of atoms
    and bonds are there for callers (:meth:`atom_to_feature_vector`,
    :meth:`bond_to_feature_vector`); the graph does not use them."""

    # OGB-style tables of allowed values; 'misc' catches the rest
    ALLOWABLE = {
        'atomic_num': list(range(1, 119)) + ['misc'],
        'chirality': ['CHI_UNSPECIFIED', 'CHI_TETRAHEDRAL_CW',
                      'CHI_TETRAHEDRAL_CCW', 'CHI_OTHER'],
        'degree': list(range(11)) + ['misc'],
        'formal_charge': [-5, -4, -3, -2, -1, 0, 1, 2, 3, 4, 5, 'misc'],
        'numH': list(range(9)) + ['misc'],
        'radical_e': list(range(5)) + ['misc'],
        'hybridization': ['SP', 'SP2', 'SP3', 'SP3D', 'SP3D2', 'misc'],
        'is_aromatic': [False, True],
        'is_in_ring': [False, True],
        'bond_type': ['SINGLE', 'DOUBLE', 'TRIPLE', 'AROMATIC', 'misc'],
        'bond_stereo': ['STEREONONE', 'STEREOZ', 'STEREOE', 'STEREOCIS',
                        'STEREOTRANS', 'STEREOANY'],
        'is_conjugated': [False, True],
    }

    @staticmethod
    def _safe_index(table, value):
        try:
            return table.index(value)
        except ValueError:
            return len(table) - 1

    def __init__(self, num_conformers: int = 1):
        self.num_conformers = num_conformers

    def atom_to_feature_vector(self, atom) -> List[int]:
        """OGB-style index features of one atom: atomic number, chirality,
        degree with hydrogens, formal charge, hydrogens, radical electrons,
        hybridization, aromatic, in a ring."""
        chirality = ('CHI_UNSPECIFIED' if not atom.chirality else
                     'CHI_TETRAHEDRAL_CW' if atom.chirality == '@@' else
                     'CHI_TETRAHEDRAL_CCW')
        A, idx = self.ALLOWABLE, self._safe_index
        return [
            idx(A['atomic_num'], atom.atomic_num),
            idx(A['chirality'], chirality),
            idx(A['degree'], atom.degree + atom.total_hs),
            idx(A['formal_charge'], atom.formal_charge),
            idx(A['numH'], atom.total_hs),
            idx(A['radical_e'], atom.num_radical_electrons),
            idx(A['hybridization'], atom.hybridization.upper()),
            A['is_aromatic'].index(bool(atom.is_aromatic)),
            A['is_in_ring'].index(bool(atom.in_ring)),
        ]

    def bond_to_feature_vector(self, bond) -> List[int]:
        """OGB-style index features of one bond: type, stereo,
        conjugated."""
        A, idx = self.ALLOWABLE, self._safe_index
        if bond.is_aromatic:
            btype = 'AROMATIC'
        else:
            btype = {1.0: 'SINGLE', 2.0: 'DOUBLE',
                     3.0: 'TRIPLE'}.get(float(bond.order), 'misc')
        stereo = {'': 'STEREONONE', 'cis': 'STEREOCIS',
                  'trans': 'STEREOTRANS'}.get(bond.stereo, 'STEREOANY')
        return [
            idx(A['bond_type'], btype),
            A['bond_stereo'].index(stereo),
            A['is_conjugated'].index(bool(bond.is_conjugated)),
        ]

    def _featurize(self, mol: Molecule) -> GraphData:
        graph = MolGraphConvFeaturizer(use_edges=True)._featurize(mol)
        pos = _positions(mol)
        if self.num_conformers > 1:
            pos = np.concatenate([pos] * self.num_conformers, axis=0)
        return GraphData(graph.node_features, graph.edge_index,
                         graph.edge_features, node_pos_features=pos)
