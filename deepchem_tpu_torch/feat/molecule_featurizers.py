"""Molecule featurizers."""

from __future__ import annotations

from collections import deque
from typing import List, Optional

import numpy as np

from deepchem_tpu_torch.chem import Molecule
from deepchem_tpu_torch.feat import feature_utils as fu
from deepchem_tpu_torch.feat.base import MolecularFeaturizer
from deepchem_tpu_torch.feat.graph_data import GraphData


class PagtnMolGraphFeaturizer(MolecularFeaturizer):
    """PAGTN graph featurizer: 49-dim atom one-hots and 38-dim
    shortest-path pair features on the complete graph, self-pairs
    included (n^2 edges for n atoms).

    Pair features: for each of the first ``max_length`` bonds on the BFS
    shortest path, bond type (4) + conjugated + in ring; then same-ring;
    then a one-hot of the path length (``max_length + 1`` means longer or
    disconnected).
    """

    def __init__(self, max_length: int = 5):
        self.max_length = max_length
        self.SYMBOLS = ['B', 'C', 'N', 'O', 'S', 'F', 'Si', 'P', 'Cl', 'Br',
                        'Mg', 'Na', 'Ca', 'Fe', 'As', 'Al', 'I', 'Li', 'K',
                        'Unknown']

    def _featurize(self, mol: Molecule) -> GraphData:
        n = mol.num_atoms
        atom_feats = []
        for a in mol.atoms:
            f = (fu.one_hot_encode(a.symbol, self.SYMBOLS[:-1], True)
                 + fu.one_hot_encode(a.degree, list(range(11)), False)
                 + fu.one_hot_encode(a.formal_charge,
                                     [-2, -1, 0, 1, 2], True)
                 + fu.one_hot_encode(a.total_hs, [0, 1, 2, 3, 4], True)
                 + fu.get_atom_hybridization_one_hot(a, include_unknown_set=True)
                 + [float(a.is_aromatic), a.mass * 0.01])
            atom_feats.append(f)
        atom_feats = np.asarray(atom_feats, dtype=np.float32)
        rings = mol.rings()
        src, dst, efeats = [], [], []
        for i in range(n):
            prev = {i: (-1, None)}
            dq = deque([i])
            while dq:
                u = dq.popleft()
                for b in mol.atom_bonds(u):
                    v = b.other(u)
                    if v not in prev:
                        prev[v] = (u, b)
                        dq.append(v)
            for j in range(n):
                src.append(i)
                dst.append(j)
                pathvec = []
                path_bonds = []
                u = j
                ok = j in prev
                while ok and u != i:
                    pu, b = prev[u]
                    path_bonds.append(b)
                    u = pu
                plen = len(path_bonds)
                for k in range(self.max_length):
                    if k < plen:
                        b = path_bonds[-1 - k]
                        pathvec += fu.get_bond_type_one_hot(b) + [
                            float(b.is_conjugated), float(b.in_ring)]
                    else:
                        pathvec += [0.0] * 6
                same_ring = any(i in r and j in r for r in rings)
                dist_onehot = fu.one_hot_encode(
                    min(plen, self.max_length + 1) if ok else
                    self.max_length + 1,
                    list(range(self.max_length + 2)), False)
                efeats.append(pathvec + [float(same_ring)] + dist_onehot)
        ei = np.array([src, dst], dtype=np.int64).reshape(2, -1)
        return GraphData(atom_feats, ei,
                         np.asarray(efeats, dtype=np.float32))


class ConvMolFeaturizer(MolecularFeaturizer):
    """GraphConv featurizer: 75 atom features a row
    (:func:`atom_features_75_mol`) and COO edges, both directions of each
    bond in bond order, ``[a1 -> a2, a2 -> a1]``.  So a node's neighbours
    stand in its neighbour-table row in bond order, which decides the ties
    of the neighbour max.

    ``master_atom`` appends a node holding the mean of the atom features,
    joined to every atom; ``use_chirality`` adds three chirality columns.
    Every molecule takes the Python parser: the JAX package's native C++
    parse path is not ported.
    """

    def __init__(self, master_atom: bool = False,
                 use_chirality: bool = False):
        self.master_atom = master_atom
        self.use_chirality = use_chirality

    def _featurize(self, mol: Molecule) -> GraphData:
        feats = fu.atom_features_75_mol(mol,
                                        use_chirality=self.use_chirality)
        src, dst = [], []
        for b in mol.bonds:
            src += [b.a1, b.a2]
            dst += [b.a2, b.a1]
        if self.master_atom:
            feats = np.concatenate([feats, feats.mean(axis=0,
                                                      keepdims=True)])
            mi = len(feats) - 1
            for i in range(mol.num_atoms):
                src += [i, mi]
                dst += [mi, i]
        ei = np.array([src, dst], dtype=np.int64).reshape(2, -1)
        return GraphData(feats, ei)


class MolGraphConvFeaturizer(MolecularFeaturizer):
    """30 atom features and, with ``use_edges``, 11 bond features, for the
    graph models that read MolGraphConv graphs (MPNN, GCN, GAT,
    AttentiveFP).

    Atom: type one-hot over C, N, O, F, P, S, Cl, Br, I and other (10),
    formal charge, hybridization SP, SP2, SP3 (3), hydrogen-bond acceptor
    and donor, aromatic, total degree 0-5 and more (7), total hydrogens
    0-4 and more (6); ``use_chirality`` adds R and S, and
    ``use_partial_charge`` a column of zeros.  Bond, written for both
    directions: type one-hot (4), in a ring, conjugated, and the first
    five of the stereo one-hot (none, any, Z, E, cis).  A molecule with no
    bond has ``[0, 11]`` edge features.
    """

    def __init__(self, use_edges: bool = False,
                 use_chirality: bool = False,
                 use_partial_charge: bool = False):
        self.use_edges = use_edges
        self.use_chirality = use_chirality
        self.use_partial_charge = use_partial_charge

    def _featurize(self, mol: Molecule) -> GraphData:
        hbond = fu.construct_hydrogen_bonding_info(mol)
        donors = {i for i, t in hbond if t == 'Donor'}
        acceptors = {i for i, t in hbond if t == 'Acceptor'}
        atom_feats = []
        for a in mol.atoms:
            f = (fu.get_atom_type_one_hot(a)
                 + fu.get_atom_formal_charge(a)
                 + fu.get_atom_hybridization_one_hot(a)
                 + [float(a.index in acceptors), float(a.index in donors)]
                 + fu.get_atom_is_in_aromatic_one_hot(a)
                 + fu.get_atom_total_degree_one_hot(a)
                 + fu.get_atom_total_num_Hs_one_hot(a))
            if self.use_chirality:
                f += fu.get_atom_chirality_one_hot(a)
            if self.use_partial_charge:
                f += fu.get_atom_partial_charge(a)
            atom_feats.append(f)
        src, dst = [], []
        bond_feats: Optional[List] = [] if self.use_edges else None
        for b in mol.bonds:
            src += [b.a1, b.a2]
            dst += [b.a2, b.a1]
            if self.use_edges:
                bf = (fu.get_bond_type_one_hot(b)
                      + fu.get_bond_is_in_same_ring_one_hot(b)
                      + fu.get_bond_is_conjugated_one_hot(b)
                      + fu.get_bond_stereo_one_hot(b)[:5])
                bond_feats += [bf, bf]
        ei = np.array([src, dst], dtype=np.int64).reshape(2, -1)
        ef = None
        if self.use_edges:
            ef = np.asarray(bond_feats, dtype=np.float32).reshape(
                ei.shape[1], 11)
        return GraphData(np.asarray(atom_feats, dtype=np.float32), ei, ef)


class DMPNNFeaturizer(MolecularFeaturizer):
    """Chemprop's D-MPNN featurization: 133 atom and 14 bond features, for
    :class:`DMPNNModel`.

    Atom, each one-hot with a trailing unknown slot: atomic number over
    the first 100 elements (101), degree 0-5 (7), formal charge -1, -2, 1,
    2, 0 (6), chirality none, ``@``, ``@@``, other (5), total hydrogens 0-4
    (6), hybridization SP, SP2, SP3, SP3D, SP3D2 (6), aromatic (1), mass
    times 0.01 (1).  Bond: a null-bond flag (0), type single, double,
    triple, aromatic (4), conjugated (1), in a ring (1), the first six of
    the stereo one-hot and a 0 (7).  Edges come in ``(u -> v, v -> u)``
    adjacent pairs, so the reverse of edge ``e`` is ``e ^ 1``.

    ``features_generators=['morgan']`` (a Morgan count vector as global
    features) is not ported yet and raises.
    """

    def __init__(self, features_generators: Optional[List[str]] = None,
                 is_adding_hs: bool = False):
        if is_adding_hs:
            raise NotImplementedError(
                'explicit-H featurization not supported')
        if features_generators:
            raise NotImplementedError(
                f'features generators {features_generators} are not ported '
                '(the Morgan fingerprints of chem/fingerprints.py)')
        self.features_generators = features_generators

    @staticmethod
    def _atom_features(a) -> List[float]:
        f = fu.one_hot_encode(a.atomic_num, list(range(1, 101)), True)
        f += fu.one_hot_encode(a.degree, [0, 1, 2, 3, 4, 5], True)
        f += fu.one_hot_encode(a.formal_charge, [-1, -2, 1, 2, 0], True)
        chir = {'': 0, '@': 1, '@@': 2}.get(a.chirality, 3)
        f += fu.one_hot_encode(chir, [0, 1, 2, 3], True)
        f += fu.one_hot_encode(a.total_hs, [0, 1, 2, 3, 4], True)
        f += fu.one_hot_encode(a.hybridization,
                               ['SP', 'SP2', 'SP3', 'SP3D', 'SP3D2'], True)
        f += fu.get_atom_is_in_aromatic_one_hot(a)
        f += [a.mass * 0.01]
        return f

    @staticmethod
    def _bond_features(b) -> List[float]:
        return ([0.0] + fu.get_bond_type_one_hot(b)
                + fu.get_bond_is_conjugated_one_hot(b)
                + fu.get_bond_is_in_same_ring_one_hot(b)
                + fu.get_bond_stereo_one_hot(b)[:6] + [0.0])

    def _featurize(self, mol: Molecule) -> GraphData:
        atom_feats = np.asarray([self._atom_features(a) for a in mol.atoms],
                                dtype=np.float32)
        src, dst, bond_feats = [], [], []
        for b in mol.bonds:
            bf = self._bond_features(b)
            src += [b.a1, b.a2]
            dst += [b.a2, b.a1]
            bond_feats += [bf, bf]
        ei = np.array([src, dst], dtype=np.int64).reshape(2, -1)
        ef = np.asarray(bond_feats, dtype=np.float32).reshape(
            ei.shape[1], 14)
        return GraphData(atom_feats, ei, ef)
