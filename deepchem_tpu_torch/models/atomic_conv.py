"""Atomic convolutions for protein-ligand binding affinity (Gomes et al.
2017, ACNN).

Counterparts of ``deepchem_tpu/models/atomic_conv.py``:
``compute_neighbor_list``, ``neighbor_dict``, ``AtomicConvolution``,
``_ACNNModule``, ``AtomicConvModel``, ``pdb_atoms``,
``AtomicConvFeaturizer``, ``ComplexNeighborListFragmentAtomicCoordinates``
and ``ani_symmetry_features``.  A complex is three fragments, the ligand,
the protein and the two joined, each as coordinates, a neighbour list,
the neighbours' atomic numbers and the atomic numbers.  For each atom the
radial symmetry functions of its neighbours' distances, resolved by the
neighbours' atom types, are one batched product on cuBLAS; the three
fragments' flattened features feed a dense stack.  Neighbour lists are
built on the host, in numpy, as the JAX package builds them.
"""

from __future__ import annotations

import itertools
import logging
import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepchem_tpu_torch.data import NumpyDataset
from deepchem_tpu_torch.models.fcnet import _common, truncated_dense
from deepchem_tpu_torch.models.graph_models import _SeededDropout
from deepchem_tpu_torch.models.losses import L2Loss
from deepchem_tpu_torch.models.torch_model import TorchModel

logger = logging.getLogger(__name__)

#: the atom types of the JAX package (DeepChem's default): common
#: biomolecular elements, -1 for every other element
DEFAULT_ATOM_TYPES: Tuple[float, ...] = (
    6, 7., 8., 9., 11., 12., 15., 16., 17., 20., 25., 30., 35., 53., -1.)

#: the radial grid: cutoffs x means x widths (22 x 3 x 1 = 66 triples)
DEFAULT_RADIAL: Tuple[Sequence[float], ...] = (
    tuple(np.arange(1.5, 12.1, 0.5)), (0.0, 4.0, 8.0), (0.4,))


def compute_neighbor_list(coords: np.ndarray, cutoff: float = 12.0,
                          max_neighbors: int = 12
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """``[N, 3]`` coordinates -> ``[N, max_neighbors]`` int32 neighbour ids
    (nearest first) and whether each slot holds a neighbour within
    ``cutoff``; an empty slot names the atom itself.  ``argpartition`` of
    each row, then a local ``argsort`` of its nearest, as in JAX."""
    coords = np.asarray(coords, dtype=np.float32)
    n = len(coords)
    d = np.linalg.norm(coords[:, None, :] - coords[None, :, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    d[d > cutoff] = np.inf
    m = min(max_neighbors, max(n - 1, 1))
    part = np.argpartition(d, m - 1, axis=1)[:, :m]
    pd_ = np.take_along_axis(d, part, axis=1)
    loc = np.argsort(pd_, axis=1)
    order = np.take_along_axis(part, loc, axis=1)
    dist = np.take_along_axis(pd_, loc, axis=1)
    if m < max_neighbors:
        pad = np.full((n, max_neighbors - m), np.inf, dtype=d.dtype)
        order = np.concatenate(
            [order, np.zeros((n, max_neighbors - m), order.dtype)], 1)
        dist = np.concatenate([dist, pad], 1)
    valid = dist < np.inf
    out = np.where(valid, order, np.arange(n)[:, None])
    return out.astype(np.int32), valid


def neighbor_dict(coords: np.ndarray, cutoff: float = 12.0,
                  max_neighbors: int = 12) -> dict:
    """DeepChem's neighbour list format: ``{atom: [neighbour ids]}``."""
    idx, valid = compute_neighbor_list(coords, cutoff, max_neighbors)
    return {i: list(idx[i][valid[i]]) for i in range(len(coords))}


def _take_rows_fill(coords: torch.Tensor, idx: torch.Tensor
                    ) -> torch.Tensor:
    """``coords[b, idx[b]]`` for ``coords`` ``[B, N, 3]`` and ``idx`` ``[B,
    N, M]``: ``jnp.take``'s default mode, as the JAX module gathers, so a
    negative id counts from the end and an id past either end gives NaN
    rows (a complex packed past its fragment's atom count names such
    ids)."""
    B, N, M = idx.shape
    idx = idx.long()
    wrapped = torch.where(idx < 0, idx + N, idx)
    inside = (wrapped >= 0) & (wrapped < N)
    flat = wrapped.clamp(0, max(N - 1, 0)).reshape(B, N * M, 1)
    rows = torch.gather(coords, 1, flat.expand(B, N * M, 3))
    rows = torch.where(inside.reshape(B, N * M, 1), rows,
                       torch.full_like(rows, float('nan')))
    return rows.reshape(B, N, M, 3)


class AtomicConvolution(nn.Module):
    """Atom-type-resolved radial symmetry functions, no parameters: for
    each radial triple ``k = (r_c, r_s, e)`` and atom type ``t``,
    ``out[b, n, t, k] = Σ_m exp(-e (d_bnm - r_s)^2) f_c(d_bnm; r_c)
    [z_nbr = t]`` with the cosine cutoff ``f_c(d) = (cos(π d / r_c) + 1) /
    2`` for ``d <= r_c``, else 0; flattened to ``[B, N, T K]``.  The sum
    over the ``M`` neighbours is one batched ``[T, M] x [M, K]`` product
    an atom (cuBLAS on the card).  An empty slot has ``z_nbr = 0``, which
    is no type."""

    def __init__(self, radial_params: Sequence[Tuple[float, float, float]],
                 atom_types: Sequence[float]):
        super().__init__()
        params = torch.tensor(radial_params, dtype=torch.float32)
        self.register_buffer('rc', params[:, 0].contiguous(),
                             persistent=False)
        self.register_buffer('rs', params[:, 1].contiguous(),
                             persistent=False)
        self.register_buffer('e', params[:, 2].contiguous(),
                             persistent=False)
        self.register_buffer('types', torch.tensor(atom_types,
                                                   dtype=torch.float32),
                             persistent=False)

    def forward(self, coords: torch.Tensor, nbr_idx: torch.Tensor,
                nbr_z: torch.Tensor) -> torch.Tensor:
        B, N, M = nbr_idx.shape
        delta = coords[:, :, None, :] - _take_rows_fill(coords, nbr_idx)
        d = torch.sqrt(torch.sum(delta * delta, dim=-1) + 1e-12)
        dk = d[..., None]                                      # [B,N,M,1]
        fc = 0.5 * (torch.cos(math.pi * dk / self.rc) + 1.0) \
            * (dk <= self.rc)
        g = torch.exp(-self.e * torch.square(dk - self.rs)) * fc
        tmask = (nbr_z[..., None] == self.types).to(g.dtype)   # [B,N,M,T]
        T, K = tmask.shape[-1], g.shape[-1]
        out = torch.bmm(tmask.reshape(B * N, M, T).transpose(1, 2),
                        g.reshape(B * N, M, K))                # [BN, T, K]
        return out.reshape(B, N, T * K)


class _ACNNModule(_SeededDropout):
    """Three :class:`AtomicConvolution` (ligand, protein, complex), their
    flattened features joined, then per layer ``Dense`` (kernels a normal
    of ``weight_init_stddevs`` cut at two deviations, biases
    ``bias_init_consts``), seeded dropout, a residual add where
    ``residual`` and the width stays, and ReLU; the ``n_tasks`` head.
    flax scopes: ``Dense_<i>`` the layers, then the head."""

    def __init__(self, n_tasks: int, radial_params, atom_types,
                 layer_sizes: Sequence[int], weight_init_stddevs,
                 bias_init_consts, dropouts, residual: bool,
                 in_features: int, dropout_seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = AtomicConvolution(radial_params, atom_types)
        self.residual, self.dropout_seed = residual, dropout_seed
        self.dropouts = tuple(dropouts)
        widths = [in_features] + list(layer_sizes)
        self.layers = nn.ModuleList(
            truncated_dense(a, b, s, c, generator) for a, b, s, c in zip(
                widths[:-1], widths[1:], weight_init_stddevs,
                bias_init_consts))
        self.head = truncated_dense(widths[-1], n_tasks,
                                    weight_init_stddevs[-1],
                                    bias_init_consts[-1], generator)
        n = len(layer_sizes)
        self.flax_scopes = {**{f'Dense_{i}': f'layers.{i}'
                               for i in range(n)}, f'Dense_{n}': 'head'}

    def forward(self, f1_x, f1_nbrs, f1_nbrs_z, f1_z, f2_x, f2_nbrs,
                f2_nbrs_z, f2_z, cx_x, cx_nbrs, cx_nbrs_z, cx_z):
        B = f1_x.shape[0]
        x = torch.cat([self.conv(f1_x, f1_nbrs, f1_nbrs_z).reshape(B, -1),
                       self.conv(f2_x, f2_nbrs, f2_nbrs_z).reshape(B, -1),
                       self.conv(cx_x, cx_nbrs, cx_nbrs_z).reshape(B, -1)],
                      dim=-1)
        prev = x.shape[-1]
        for layer, rate in zip(self.layers, self.dropouts):
            y = layer(x)
            if rate > 0:
                y = self._dropout(y, rate)
            x = x + y if self.residual and prev == y.shape[-1] else y
            prev = y.shape[-1]
            x = F.relu(x)
        return self.head(x)


def _as_list(v, n: int) -> List:
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v] * n


class AtomicConvModel(TorchModel):
    """ACNN on :class:`AtomicConvFeaturizer` complexes, a regressor on
    squared error (:class:`L2Loss`), Adam at ``learning_rate``.  A sample's
    ``X`` is DeepChem's 9-tuple: (ligand coordinates, neighbour list,
    atomic numbers, the protein's, the complex's); neighbour lists are
    ``{atom: [ids]}`` dicts or ``[N, M]`` id arrays.
    :meth:`default_generator` pads each fragment to its atom count
    (``frag1_num_atoms``, ``frag2_num_atoms``, ``complex_num_atoms``) and
    ``max_num_neighbors`` slots, atomic numbers outside ``atom_types`` as
    -1; a neighbour id past the padded fragment (a complex of more atoms
    than ``complex_num_atoms``) reads NaN coordinates, as ``jnp.take``
    does.  The module is built at construction from a ``torch.Generator``
    seeded with ``seed``; dropout draws from a generator seeded with
    ``seed``.  Engine arguments: ``batch_size`` (24), ``learning_rate``,
    ``optimizer``, ``model_dir``, ``log_frequency``, ``device``, ``seed``
    (see :class:`TorchModel`)."""

    def __init__(self, n_tasks: int = 1, frag1_num_atoms: int = 70,
                 frag2_num_atoms: int = 634, complex_num_atoms: int = 701,
                 max_num_neighbors: int = 12, batch_size: int = 24,
                 atom_types: Sequence[float] = DEFAULT_ATOM_TYPES,
                 radial: Sequence[Sequence[float]] = DEFAULT_RADIAL,
                 layer_sizes: Sequence[int] = (32, 32, 16),
                 weight_init_stddevs=0.02, bias_init_consts=1.0,
                 dropouts=0.0, residual: bool = False,
                 learning_rate: float = 0.001, **kwargs):
        self.n_tasks = n_tasks
        self.mode = 'regression'
        self.frag1_num_atoms = frag1_num_atoms
        self.frag2_num_atoms = frag2_num_atoms
        self.complex_num_atoms = complex_num_atoms
        self.max_num_neighbors = max_num_neighbors
        self.atom_types = list(atom_types)
        n_layers = len(layer_sizes)
        radial_params = [tuple(t) for t in itertools.product(*radial)]
        features = len(radial_params) * len(self.atom_types) * (
            frag1_num_atoms + frag2_num_atoms + complex_num_atoms)
        engine = _common(dict(kwargs, batch_size=batch_size,
                              learning_rate=learning_rate))

        def module(generator):
            return _ACNNModule(
                n_tasks, tuple(radial_params),
                tuple(float(t) for t in atom_types), tuple(layer_sizes),
                tuple(_as_list(weight_init_stddevs, n_layers)),
                tuple(_as_list(bias_init_consts, n_layers)),
                tuple(_as_list(dropouts, n_layers)), residual, features,
                dropout_seed=engine['seed'], generator=generator)
        super().__init__(module, L2Loss(), output_types=['prediction'],
                         **engine)

    def _frag_arrays(self, samples, off: int, n_atoms: int):
        """One fragment's columns of a batch -> ``[B, N, 3]`` coordinates,
        ``[B, N, M]`` neighbour ids and their atomic numbers, ``[B, N]``
        atomic numbers, as the JAX package pads them."""
        B = len(samples)
        M = self.max_num_neighbors
        X = np.zeros((B, n_atoms, 3), np.float32)
        nbrs = np.zeros((B, n_atoms, M), np.int32)
        nbrs_z = np.zeros((B, n_atoms, M), np.float32)
        z_out = np.zeros((B, n_atoms), np.float32)
        allowed = np.asarray(self.atom_types)
        for i, s in enumerate(samples):
            coords = np.asarray(s[off], np.float32)
            z = np.asarray(s[off + 2], np.float32).copy()
            z[~np.isin(z, allowed)] = -1.
            n = min(len(coords), n_atoms)
            X[i, :n] = coords[:n]
            z_out[i, :n] = z[:n]
            nl = s[off + 1]
            if isinstance(nl, dict):
                for a, ids in nl.items():
                    if a >= n or not len(ids):
                        continue
                    ids = np.asarray(ids, np.int64)[:M]
                    nbrs[i, a, :len(ids)] = ids
                    nbrs_z[i, a, :len(ids)] = z[ids]
            else:
                arr = np.asarray(nl, np.int64)[:n, :M]
                valid = arr != np.arange(len(arr))[:, None]
                nbrs[i, :len(arr), :arr.shape[1]] = arr
                nbrs_z[i, :len(arr), :arr.shape[1]] = z[arr] * valid
        return X, nbrs, nbrs_z, z_out

    def default_generator(self, dataset: NumpyDataset, epochs: int = 1,
                          mode: str = 'fit', deterministic: bool = True,
                          pad_batches: bool = True):
        for _ in range(epochs):
            for (X_b, y_b, w_b, _) in dataset.iterbatches(
                    batch_size=self.batch_size, deterministic=deterministic,
                    pad_batches=pad_batches):
                inputs = []
                for off, n_atoms in ((0, self.frag1_num_atoms),
                                     (3, self.frag2_num_atoms),
                                     (6, self.complex_num_atoms)):
                    inputs.extend(self._frag_arrays(X_b, off, n_atoms))
                if y_b is not None:
                    y_b = np.reshape(y_b, (len(X_b), self.n_tasks))
                yield (inputs, [y_b], [w_b])

    def get_num_tasks(self) -> int:
        return self.n_tasks

    def get_task_type(self) -> str:
        return 'regression'


# -- featurization ---------------------------------------------------------

_ELEMENT_Z = {
    'H': 1, 'C': 6, 'N': 7, 'O': 8, 'F': 9, 'Na': 11, 'Mg': 12, 'P': 15,
    'S': 16, 'Cl': 17, 'K': 19, 'Ca': 20, 'Mn': 25, 'Fe': 26, 'Co': 27,
    'Ni': 28, 'Cu': 29, 'Zn': 30, 'Br': 35, 'I': 53, 'Se': 34, 'B': 5,
    'Si': 14, 'As': 33, 'Cd': 48, 'Hg': 80, 'D': 1}


def pdb_atoms(source: Union[str, Sequence[str]]
              ) -> Tuple[np.ndarray, np.ndarray]:
    """PDB text (a path, or a list of lines) -> the ``ATOM`` and ``HETATM``
    records' coordinates ``[N, 3]`` float32 and atomic numbers ``[N]``
    int32 (-1 for an element not in the table), the element from columns
    77-78, else from the atom name."""
    if isinstance(source, str):
        with open(source) as f:
            lines = f.readlines()
    else:
        lines = list(source)
    coords, zs = [], []
    for line in lines:
        if not line.startswith(('ATOM', 'HETATM')):
            continue
        try:
            xyz = (float(line[30:38]), float(line[38:46]),
                   float(line[46:54]))
        except (ValueError, IndexError):
            continue
        elem = line[76:78].strip() if len(line) > 76 else ''
        if not elem:
            name = line[12:16].strip()
            elem = name[:2] if name[:2] in _ELEMENT_Z else name[:1]
        elem = elem.capitalize()
        z = _ELEMENT_Z.get(elem)
        coords.append(xyz)
        zs.append(-1 if z is None else z)
    return (np.asarray(coords, np.float32), np.asarray(zs, np.int32))


class AtomicConvFeaturizer:
    """(ligand, protein) pairs -> DeepChem's 9-tuple a complex: each
    fragment's coordinates, ``{atom: [ids]}`` neighbours within
    ``neighbor_cutoff`` (at most ``max_num_neighbors``) and atomic
    numbers, for the ligand, the protein and the two joined.  A fragment
    is a PDB path, a list of PDB lines or a ``(coords, z)`` pair;
    hydrogens are dropped with ``strip_hydrogens``.  A complex with an
    empty fragment or more atoms than the maxima is logged and dropped;
    ``kept_indices`` lists the pairs kept.  The complex's default maximum,
    704, is above :class:`AtomicConvModel`'s 701, as in the JAX
    package."""

    def __init__(self, frag1_num_atoms: int = 70,
                 frag2_num_atoms: int = 634,
                 complex_num_atoms: int = 704,
                 max_num_neighbors: int = 12,
                 neighbor_cutoff: float = 12.0,
                 strip_hydrogens: bool = True):
        self.frag1_num_atoms = frag1_num_atoms
        self.frag2_num_atoms = frag2_num_atoms
        self.complex_num_atoms = complex_num_atoms
        self.max_num_neighbors = max_num_neighbors
        self.neighbor_cutoff = neighbor_cutoff
        self.strip_hydrogens = strip_hydrogens

    def _load(self, source):
        if isinstance(source, tuple) and len(source) == 2:
            coords, z = source
        else:
            coords, z = pdb_atoms(source)
        if self.strip_hydrogens and len(z):
            keep = z != 1
            coords, z = coords[keep], z[keep]
        return coords, z

    @staticmethod
    def get_Z_matrix(z, max_atoms: int) -> np.ndarray:
        """Atomic numbers zero-padded to ``max_atoms``; raises where there
        are more.  Takes an array or an object with ``GetAtoms()``."""
        if hasattr(z, 'GetAtoms'):
            z = np.array([a.GetAtomicNum() for a in z.GetAtoms()])
        z = np.asarray(z)
        if len(z) > max_atoms:
            raise ValueError(
                'A molecule is larger than permitted by max_atoms. '
                'Increase max_atoms and try again.')
        out = np.zeros(max_atoms, dtype=z.dtype)
        out[:len(z)] = z
        return out

    def featurize_mol(self, coords, z, max_num_atoms: int):
        """One fragment -> (coordinates zero-padded to ``max_num_atoms``,
        the neighbour dict, the padded atomic numbers)."""
        nbrs = neighbor_dict(np.asarray(coords), self.neighbor_cutoff,
                             self.max_num_neighbors)
        zp = self.get_Z_matrix(z, max_num_atoms)
        cp = np.zeros((max_num_atoms, 3))
        cp[:len(coords)] = coords
        return cp, nbrs, zp

    def _featurize(self, pair):
        lig, prot = pair
        lc, lz = self._load(lig)
        pc, pz = self._load(prot)
        if len(lc) == 0 or len(pc) == 0:
            raise ValueError('empty fragment')
        if len(lc) > self.frag1_num_atoms or \
                len(pc) > self.frag2_num_atoms or \
                len(lc) + len(pc) > self.complex_num_atoms:
            raise ValueError(
                f'fragment sizes ({len(lc)}, {len(pc)}) exceed '
                f'({self.frag1_num_atoms}, {self.frag2_num_atoms}, '
                f'{self.complex_num_atoms})')
        cc = np.concatenate([lc, pc])
        cz = np.concatenate([lz, pz])
        cut, M = self.neighbor_cutoff, self.max_num_neighbors
        return (lc, neighbor_dict(lc, cut, M), lz,
                pc, neighbor_dict(pc, cut, M), pz,
                cc, neighbor_dict(cc, cut, M), cz)

    def featurize(self, pairs) -> np.ndarray:
        out, kept = [], []
        for i, pair in enumerate(pairs):
            try:
                out.append(self._featurize(pair))
                kept.append(i)
            except Exception as e:
                logger.warning('Failed to featurize complex %d: %s', i, e)
        arr = np.empty(len(out), dtype=object)
        for i, t in enumerate(out):
            arr[i] = t
        self.kept_indices = np.asarray(kept, dtype=np.int64)
        return arr


class ComplexNeighborListFragmentAtomicCoordinates(AtomicConvFeaturizer):
    """DeepChem's older name of :class:`AtomicConvFeaturizer`."""


def ani_symmetry_features(coords: torch.Tensor,
                          atomic_numbers: torch.Tensor,
                          atom_mask: Optional[torch.Tensor] = None,
                          atom_cases: Sequence[int] = (1, 6, 7, 8, 16),
                          radial_cutoff: float = 4.6,
                          angular_cutoff: float = 3.1,
                          radial_length: int = 32,
                          angular_length: int = 8,
                          radial_eta: float = 16.0,
                          angular_eta: float = 8.0,
                          zeta: float = 32.0) -> torch.Tensor:
    """ANI-1 symmetry functions (Smith et al. 2017): ``coords`` ``[N, 3]``
    (Å), ``atomic_numbers`` ``[N]``, ``atom_mask`` ``[N]`` optional ->
    ``[N, 1 + S R + S (S + 1) / 2 R_a A]``: each atom's atomic number, its
    radial terms by species, and its angular terms by unordered species
    pair (radial shells times angle shells), as dense masked tensors."""
    n = coords.shape[0]
    dev, dt = coords.device, coords.dtype
    z = atomic_numbers.to(torch.int32)
    mask = torch.ones(n, dtype=dt, device=dev) if atom_mask is None \
        else atom_mask.to(dt)
    species = torch.stack([(z == s).to(dt) * mask for s in atom_cases],
                          dim=-1)                               # [N, S]
    d = coords[:, None, :] - coords[None, :, :]
    r = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)            # [N, N]
    eye = torch.eye(n, dtype=dt, device=dev)
    pair_mask = (1.0 - eye) * mask[:, None] * mask[None, :]

    def fc(rr, rc):
        return torch.where(rr < rc, 0.5 * torch.cos(math.pi * rr / rc) + 0.5,
                           torch.zeros_like(rr))

    def linspace(a, b, k):
        return torch.linspace(a, b, k, dtype=dt, device=dev)
    rs = linspace(0.5, radial_cutoff, radial_length)
    rad = torch.exp(-radial_eta * (r[:, :, None] - rs) ** 2) \
        * (fc(r, radial_cutoff) * pair_mask)[:, :, None]        # [N, N, R]
    g_rad = torch.einsum('ijk,js->isk', rad, species)           # [N, S, R]
    ars = linspace(0.5, angular_cutoff, angular_length)
    thetas = linspace(0.0, math.pi, angular_length)
    cos_ijk = torch.einsum('ija,ika->ijk', d, d) / torch.clamp_min(
        r[:, :, None] * r[:, None, :], 1e-6)
    theta = torch.arccos(torch.clamp(cos_ijk, -1.0 + 1e-6, 1.0 - 1e-6))
    fpair = fc(r, angular_cutoff) * pair_mask                   # [N, N]
    tri_mask = fpair[:, :, None] * fpair[:, None, :] * (1.0 - eye)[None]
    ang_r = 0.5 * (r[:, :, None] + r[:, None, :])               # [N, N, N]
    shell = torch.exp(-angular_eta * (ang_r[..., None] - ars) ** 2)
    angle = (2.0 ** (1.0 - zeta)) * \
        (1.0 + torch.cos(theta[..., None] - thetas)) ** zeta
    tri = shell[..., :, None] * angle[..., None, :] \
        * tri_mask[..., None, None]                             # [N,N,N,Ra,A]
    pair_feats = []
    S = len(atom_cases)
    for s1 in range(S):
        for s2 in range(s1, S):
            w = species[:, s1][None, :, None] * species[:, s2][None, None, :]
            if s1 != s2:
                w = w + species[:, s2][None, :, None] \
                    * species[:, s1][None, None, :]
            g = torch.einsum('ijkra,ijk->ira', tri,
                             w * torch.ones((n, 1, 1), dtype=dt, device=dev))
            pair_feats.append(g.reshape(n, -1))
    return torch.cat([z[:, None].to(dt) * mask[:, None],
                      g_rad.reshape(n, -1)] + pair_feats, dim=-1)
