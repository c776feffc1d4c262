"""Conformer graphs: a molecule's graph with 3D positions.

Counterparts of ``deepchem_tpu/feat/conformer_featurizers.py``'s
``_positions``, ``RDKitConformerFeaturizer`` and
``EquivariantGraphFeaturizer``, and of ``deepchem_tpu/models/mxmnet.py``'s
``MXMNetFeaturizer``.  The conformer graph is :class:`MolGraphConvFeaturizer`
with bond features (30 atom and 11 bond features); the positions are the
molecule's conformer where it has one, else the port's own
distance-geometry embedding
(:func:`~deepchem_tpu_torch.utils.conformers.embed_molecule_3d`).
"""

from __future__ import annotations

from typing import List, Optional

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


# the elements of EquivariantGraphFeaturizer's one-hot: H C N O F S Cl
_EQ_ATOMS = [1, 6, 7, 8, 9, 16, 17]


class EquivariantGraphFeaturizer(MolecularFeaturizer):
    """SE(3)-equivariant model inputs: each atom's one-hot over C, N, O, F,
    S and Cl and its atomic number (7 features), the bonds both ways (or,
    with ``fully_connected``, every ordered pair of distinct atoms), each
    edge's displacement ``pos[dst] - pos[src]`` as its features, the
    positions, and ``edge_weights``: each edge's length one-hot over the
    bins of ``weight_bins`` (``np.digitize``; default 1, 2, 3, 4 Å, so 5
    bins).  ``embeded`` is kept, as in the JAX package, and unused."""

    def __init__(self, fully_connected: bool = False,
                 weight_bins: Optional[List[float]] = None,
                 embeded: bool = False):
        self.fully_connected = fully_connected
        self.embeded = embeded
        self.weight_bins = (list(weight_bins) if weight_bins is not None
                            else [1.0, 2.0, 3.0, 4.0])

    def _node_features(self, mol: Molecule) -> np.ndarray:
        return np.asarray(
            [[float(a.atomic_num == z) for z in _EQ_ATOMS[1:]]
             + [float(a.atomic_num)] for a in mol.atoms], dtype=np.float32)

    def _discretize(self, dists: np.ndarray) -> np.ndarray:
        bins = np.digitize(dists, self.weight_bins)
        out = np.zeros((len(dists), len(self.weight_bins) + 1),
                       dtype=np.float32)
        out[np.arange(len(dists)), bins] = 1.0
        return out

    def _featurize(self, mol: Molecule) -> GraphData:
        pos = _positions(mol)
        src: List[int] = []
        dst: List[int] = []
        if self.fully_connected:
            n = mol.num_atoms
            for i in range(n):
                for j in range(n):
                    if i != j:
                        src.append(i)
                        dst.append(j)
        else:
            for b in mol.bonds:
                src += [b.a1, b.a2]
                dst += [b.a2, b.a1]
        src_a = np.asarray(src, dtype=np.int64)
        dst_a = np.asarray(dst, dtype=np.int64)
        disp = pos[dst_a] - pos[src_a] if len(src_a) else \
            np.zeros((0, 3), dtype=np.float32)
        dists = np.linalg.norm(disp, axis=-1) if len(src_a) else \
            np.zeros(0, dtype=np.float32)
        return GraphData(self._node_features(mol),
                         np.stack([src_a, dst_a]),
                         edge_features=disp.astype(np.float32),
                         node_pos_features=pos,
                         edge_weights=self._discretize(dists))


class MXMNetFeaturizer(MolecularFeaturizer):
    """MXMNet's inputs: each atom's atomic number one-hot over 0-9
    (clipped), the bonds both ways (the local graph), the positions
    (float32), and ``global_edges`` ``[2, E_g]``: for each atom ``i``, up
    to ``max_neighbors`` nearest other atoms ``j`` within ``radius``
    (``j -> i``), nearest first by numpy's default ``argsort`` of the
    distances, so tied distances pick the JAX package's neighbours.  The
    distances are taken at the conformer's precision (the embedding's
    float64 where the molecule has no conformer)."""

    def __init__(self, radius: float = 5.0, max_neighbors: int = 16):
        self.radius = radius
        self.max_neighbors = max_neighbors

    def _featurize(self, mol: Molecule) -> GraphData:
        if mol.conformer is None:
            coords = embed_molecule_3d(mol)
        else:
            coords = np.asarray(mol.conformer, dtype=np.float32)
        z = np.array([a.atomic_num for a in mol.atoms], dtype=np.int32)
        nf = np.eye(10, dtype=np.float32)[np.clip(z, 0, 9)]
        src, dst = [], []
        for b in mol.bonds:
            src += [b.a1, b.a2]
            dst += [b.a2, b.a1]
        ei = np.array([src, dst], dtype=np.int64).reshape(2, -1)
        d = np.linalg.norm(coords[:, None] - coords[None, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        gsrc, gdst = [], []
        for i in range(len(z)):
            for j in np.argsort(d[i])[:self.max_neighbors]:
                if d[i, j] <= self.radius:
                    gsrc.append(j)
                    gdst.append(i)
        return GraphData(nf, ei, node_pos_features=coords.astype(np.float32),
                         global_edges=np.array([gsrc, gdst],
                                               dtype=np.int64).reshape(2, -1))
