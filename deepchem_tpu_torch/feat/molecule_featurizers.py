"""Molecule featurizers: graphs for the graph models, circular
fingerprints for the dense ones, and SMILES as one-hot characters, token
sequences and images for the sequence and image models."""

from __future__ import annotations

import math
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from deepchem_tpu_torch.chem import (Molecule, mol_from_smiles,
                                     morgan_fingerprint,
                                     sparse_morgan_fingerprint)
from deepchem_tpu_torch.feat import feature_utils as fu
from deepchem_tpu_torch.feat.base import Featurizer, MolecularFeaturizer
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

    ``features_generators=['morgan']`` adds each graph's 2048-bit Morgan
    fingerprint (radius 2) as float32 ``global_features``.
    """

    def __init__(self, features_generators: Optional[List[str]] = None,
                 is_adding_hs: bool = False):
        if is_adding_hs:
            raise NotImplementedError(
                'explicit-H featurization not supported')
        for gen in features_generators or ():
            if gen != 'morgan':
                raise ValueError(f'unsupported features generator {gen!r}')
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
        extra = {}
        if self.features_generators:
            extra['global_features'] = np.concatenate([
                morgan_fingerprint(mol, radius=2, n_bits=2048).astype(
                    np.float32) for _ in self.features_generators])
        return GraphData(atom_feats, ei, ef, **extra)


class CircularFingerprint(MolecularFeaturizer):
    """Extended-connectivity (Morgan, ECFP) fingerprints of
    ``chem/fingerprints.py``: ``size`` float64 bits (or counts with
    ``is_counts_based``) of every atom environment up to ``radius``; with
    ``chiral`` the chirality tags enter the atom invariants, with
    ``bonds`` the bond orders the environment hashes, and ``features``
    replaces the atom invariants by pharmacophore flags (FCFP).  With
    ``sparse`` each molecule gives the unfolded ``{hash: {'count': c}}``
    (with ``smiles``, each entry also an empty ``'smiles'``: fragment
    SMILES are not extracted)."""

    def __init__(self, radius: int = 2, size: int = 2048,
                 chiral: bool = False, bonds: bool = True,
                 features: bool = False, sparse: bool = False,
                 smiles: bool = False, is_counts_based: bool = False):
        self.radius = radius
        self.size = size
        self.chiral = chiral
        self.bonds = bonds
        self.features = features
        self.sparse = sparse
        self.smiles = smiles
        self.is_counts_based = is_counts_based

    def _featurize(self, mol: Molecule):
        if self.sparse:
            d = sparse_morgan_fingerprint(
                mol, self.radius, use_chirality=self.chiral,
                use_bond_types=self.bonds, use_features=self.features)
            if self.smiles:
                return {k: {'smiles': '', 'count': v['count']}
                        for k, v in d.items()}
            return d
        return morgan_fingerprint(
            mol, self.radius, self.size, use_chirality=self.chiral,
            use_bond_types=self.bonds, use_features=self.features,
            counts=self.is_counts_based).astype(np.float64)


class WeaveFeaturizer(MolecularFeaturizer):
    """Weave featurizer: 75 atom features a row (:func:`atom_features_75_mol`)
    and dense pair features, ``pair_features`` ``[n * n, 14]`` float32,
    row ``i * n + j`` for the pair (i, j): the bond's type one-hot in
    columns 0-3, both atoms in one ring in column 4, the graph distance 1
    to 6 and 7 or more one-hot in columns 6-12 (none for a pair in two
    fragments).  Columns 5 and 13 stay 0, as the JAX package leaves them.
    Edges are both directions of each bond, in bond order.

    ``graph_distance``, ``explicit_H`` and ``max_pair_distance`` are
    accepted for DeepChem's signature and change nothing, as in the JAX
    package; ``use_chirality`` adds three chirality columns."""

    def __init__(self, graph_distance: bool = True, explicit_H: bool = False,
                 use_chirality: bool = False,
                 max_pair_distance: Optional[int] = None):
        self.graph_distance = graph_distance
        self.use_chirality = use_chirality
        self.max_pair_distance = max_pair_distance

    def _featurize(self, mol: Molecule) -> GraphData:
        n = mol.num_atoms
        feats = fu.atom_features_75_mol(mol,
                                        use_chirality=self.use_chirality)
        dist = np.full((n, n), 99, dtype=np.int32)
        for i in range(n):
            dist[i, i] = 0
            dq = deque([i])
            while dq:
                u = dq.popleft()
                for v in mol.neighbors(u):
                    if dist[i, v] > dist[i, u] + 1:
                        dist[i, v] = dist[i, u] + 1
                        dq.append(v)
        pair = np.zeros((n, n, 14), dtype=np.float32)
        for b in mol.bonds:
            bt = fu.get_bond_type_one_hot(b)
            pair[b.a1, b.a2, 0:4] = bt
            pair[b.a2, b.a1, 0:4] = bt
        for r in mol.rings():
            pair[np.ix_(r, r, [4])] = 1.0
        for d in range(1, 8):
            mask = (dist == d) if d < 7 else (dist >= 7) & (dist < 99)
            pair[:, :, 5 + d][mask] = 1.0
        src, dst = [], []
        for b in mol.bonds:
            src += [b.a1, b.a2]
            dst += [b.a2, b.a1]
        ei = np.array([src, dst], dtype=np.int64).reshape(2, -1)
        return GraphData(feats, ei, pair_features=pair.reshape(n * n, 14))


class CoulombMatrix(MolecularFeaturizer):
    """The Coulomb matrix of a molecule's conformer, ``[max_atoms,
    max_atoms]`` float64, zero-padded: ``z_i z_j / |r_i - r_j|`` off the
    diagonal (0 where two atoms coincide), ``0.5 z_i^2.4`` on it, for the
    atoms the molecule has (hydrogens only where they are explicit atoms).
    A molecule without a conformer fails (an empty array, as every
    featurizer's failure).

    ``randomize`` gives ``n_samples`` matrices, rows and columns ordered
    by ``argsort(row norms + N(0, 1) noise)`` from ``RandomState(seed)``,
    drawn on in turn; ``upper_tri`` keeps each matrix's upper triangle,
    diagonal included.  One sample comes back without its sample axis.
    ``remove_hydrogens`` is accepted and changes nothing, as in the JAX
    package."""

    def __init__(self, max_atoms: int, remove_hydrogens: bool = False,
                 randomize: bool = False, upper_tri: bool = False,
                 n_samples: int = 1, seed: Optional[int] = None):
        self.max_atoms = max_atoms
        self.remove_hydrogens = remove_hydrogens
        self.randomize = randomize
        self.upper_tri = upper_tri
        self.n_samples = n_samples
        self.rng = np.random.RandomState(seed)

    @staticmethod
    def get_interatomic_distances(conf) -> np.ndarray:
        """All-pairs distances of an ``(N, 3)`` array, a molecule's
        conformer or an object with ``GetPositions()``."""
        if hasattr(conf, 'GetPositions'):
            xyz = np.asarray(conf.GetPositions(), dtype=np.float64)
        elif getattr(conf, 'conformer', None) is not None:
            xyz = np.asarray(conf.conformer, dtype=np.float64)
        else:
            xyz = np.asarray(conf, dtype=np.float64)
        return np.linalg.norm(xyz[:, None, :] - xyz[None, :, :], axis=-1)

    def coulomb_matrix(self, mol: Molecule) -> np.ndarray:
        if mol.conformer is None:
            raise ValueError('CoulombMatrix requires 3D coordinates')
        xyz = np.asarray(mol.conformer, dtype=np.float64)
        z = np.array([a.atomic_num for a in mol.atoms], dtype=np.float64)
        n = len(z)
        d = np.linalg.norm(xyz[:, None, :] - xyz[None, :, :], axis=-1)
        with np.errstate(divide='ignore'):
            m = np.outer(z, z) / np.where(d > 0, d, np.inf)
        np.fill_diagonal(m, 0.5 * z ** 2.4)
        pad = np.zeros((self.max_atoms, self.max_atoms))
        pad[:n, :n] = m
        return pad

    def randomize_coulomb_matrix(self, m: np.ndarray) -> List[np.ndarray]:
        out = []
        row_norms = np.linalg.norm(m, axis=1)
        for _ in range(self.n_samples):
            e = self.rng.normal(size=row_norms.size)
            p = np.argsort(row_norms + e)
            out.append(m[p][:, p])
        return out

    def _featurize(self, mol: Molecule) -> np.ndarray:
        m = self.coulomb_matrix(mol)
        ms = self.randomize_coulomb_matrix(m) if self.randomize else [m]
        if self.upper_tri:
            ms = [mm[np.triu_indices_from(mm)] for mm in ms]
        out = np.stack(ms)
        return out[0] if out.shape[0] == 1 else out


class CoulombMatrixEig(CoulombMatrix):
    """The Coulomb matrix's eigenvalues, largest first, ``[max_atoms]``
    float64."""

    def _featurize(self, mol: Molecule) -> np.ndarray:
        w, _ = np.linalg.eigh(self.coulomb_matrix(mol))
        return w[::-1].astype(np.float64)


class OneHotFeaturizer(Featurizer):
    """A SMILES (any string) as one-hot characters ``[max_length,
    len(charset) + 1]`` (the last column: a character not in ``charset``,
    the space that pads included), cut or space-padded to ``max_length``
    (as long as the string with ``max_length`` None)."""

    CHARSET = ['#', ')', '(', '+', '-', '/', '1', '3', '2', '5', '4', '7',
               '6', '8', '=', '@', 'C', 'B', 'F', 'I', 'H', 'O', 'N', 'S',
               '[', ']', '\\', 'c', 'l', 'o', 'n', 'p', 's', 'r']

    def __init__(self, charset: Optional[Sequence[str]] = None,
                 max_length: Optional[int] = 100):
        self.charset = list(charset) if charset is not None else \
            list(self.CHARSET)
        self.max_length = max_length

    def _featurize(self, datapoint: str) -> np.ndarray:
        s = self.pad_string(datapoint)
        out = np.zeros((len(s), len(self.charset) + 1), dtype=np.float32)
        for i, ch in enumerate(s):
            j = self.charset.index(ch) if ch in self.charset else -1
            out[i, j] = 1.0
        return out

    def pad_smile(self, smiles: str) -> str:
        """``smiles`` space-padded (and cut) to the featurizer's length."""
        return self.pad_string(smiles)

    def pad_string(self, string: str) -> str:
        if self.max_length is None:
            return string
        return string[:self.max_length].ljust(self.max_length)

    def untransform(self, one_hot: np.ndarray) -> str:
        """The string of a one-hot array, unknown characters and the
        padding's spaces dropped."""
        return ''.join(self.charset[i] for i in np.argmax(one_hot, axis=1)
                       if i < len(self.charset)).strip()


class SmilesToSeq(Featurizer):
    """A SMILES as token indices: ``pad_len`` pad tokens, one index a
    character (``'<unk>'``'s, else the pad's, for one not in
    ``char_to_idx``), ``pad_len`` pads, cut or padded to ``max_len + 2 *
    pad_len``; int32."""

    def __init__(self, char_to_idx: Dict[str, int], max_len: int = 250,
                 pad_len: int = 10):
        self.char_to_idx = dict(char_to_idx)
        self.idx_to_char = {v: k for k, v in char_to_idx.items()}
        self.max_len = max_len
        self.pad_len = pad_len

    def _tokens(self):
        pad = self.char_to_idx.get('<pad>', 0)
        return pad, self.char_to_idx.get('<unk>', pad)

    def _featurize(self, datapoint: str) -> np.ndarray:
        pad, unk = self._tokens()
        seq = [pad] * self.pad_len + [self.char_to_idx.get(c, unk)
                                      for c in datapoint] \
            + [pad] * self.pad_len
        total = self.max_len + 2 * self.pad_len
        seq = seq[:total] + [pad] * max(0, total - len(seq))
        return np.array(seq, dtype=np.int32)

    def to_seq(self, smile_chars: Sequence[str]) -> np.ndarray:
        """Characters -> their indices."""
        _, unk = self._tokens()
        return np.array([self.char_to_idx.get(c, unk) for c in smile_chars])

    def remove_pad(self, characters: Sequence[str]) -> List[str]:
        """The characters without the pad margins and pad tokens."""
        characters = list(characters)[
            self.pad_len:len(characters) - self.pad_len]
        return [c for c in characters if c != '<pad>']

    def smiles_from_seq(self, seq: Sequence[int]) -> str:
        return ''.join(self.remove_pad(
            [self.idx_to_char[int(i)] for i in seq]))


def create_char_to_idx(smiles_list: Sequence[str],
                       max_len: int = 250) -> Dict[str, int]:
    """:class:`SmilesToSeq`'s vocabulary: ``'<pad>'`` 0, ``'<unk>'`` 1,
    then the characters of the SMILES of at most ``max_len``, sorted."""
    chars = set()
    for s in smiles_list:
        if len(s) <= max_len:
            chars.update(s)
    vocab = {'<pad>': 0, '<unk>': 1}
    for c in sorted(chars):
        vocab[c] = len(vocab)
    return vocab


class SmilesToImage(Featurizer):
    """A molecule drawn on an ``img_size`` square, one channel
    ``[img_size, img_size, 1]``: each atom's pixel of :func:`_layout_2d`'s
    layout, scaled to fill the image, holds its atomic number / 10."""

    def __init__(self, img_size: int = 80, res: float = 0.5,
                 max_len: int = 250, img_spec: str = 'std'):
        self.img_size = img_size
        self.res = res
        self.max_len = max_len
        self.img_spec = img_spec

    def _prepare(self, point):
        return mol_from_smiles(point) if isinstance(point, str) else point

    def _featurize(self, mol: Molecule) -> np.ndarray:
        coords = _layout_2d(mol)
        n = self.img_size
        img = np.zeros((n, n, 1), dtype=np.float32)
        scale = (n / 2 - 2) / max(
            1e-6, np.abs(coords).max() if len(coords) else 1.0)
        for a, (x, y) in zip(mol.atoms, coords):
            px = np.clip(int(n / 2 + x * scale), 0, n - 1)
            py = np.clip(int(n / 2 + y * scale), 0, n - 1)
            img[py, px, 0] = a.atomic_num / 10.0
        return img


def _layout_2d(mol: Molecule) -> np.ndarray:
    """A deterministic 2-D layout: each component's first atom at the
    origin, then breadth first, the unplaced neighbours of atom ``u`` at
    unit distance on angles ``2 pi (t + 0.5) / k + 0.7 u``."""
    n = mol.num_atoms
    coords = np.zeros((n, 2))
    placed = [False] * n
    for comp in mol.components():
        root = comp[0]
        placed[root] = True
        dq = deque([root])
        while dq:
            u = dq.popleft()
            nbrs = [v for v in mol.neighbors(u) if not placed[v]]
            k = len(nbrs)
            for t, v in enumerate(nbrs):
                ang = 2 * math.pi * (t + 0.5) / max(k, 1) + 0.7 * u
                coords[v] = coords[u] + [math.cos(ang), math.sin(ang)]
                placed[v] = True
                dq.append(v)
    return coords
