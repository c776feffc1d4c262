"""The Molecule Attention Transformer.

Counterparts of ``deepchem_tpu/models/mat.py``'s ``MATEncoding``,
``MATFeaturizer``, ``ScaleNorm``, ``_MATAttention``, ``_MATModule`` and
``MATModel``.  A batch is dense per molecule, ``[B, A, ...]`` with ``A``
the largest molecule (its dummy node included) rounded up to
``atom_quantum``; each attention mixes the scaled dot-product weights
with the row-normalised adjacency and a kernel of the distances.  Every
product is a batched matmul or einsum (cuBLAS), as the JAX package
computes them outside any Pallas kernel.
"""

from __future__ import annotations

import math
from collections import deque
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepchem_tpu_torch.chem import Molecule, mol_from_smiles
from deepchem_tpu_torch.data import NumpyDataset, pad_batch
from deepchem_tpu_torch.feat import feature_utils as fu
from deepchem_tpu_torch.feat.base import MolecularFeaturizer
from deepchem_tpu_torch.metrics import to_one_hot
from deepchem_tpu_torch.models.graph_layers import dense
from deepchem_tpu_torch.models.losses import L2Loss, SoftmaxCrossEntropy
from deepchem_tpu_torch.models.torch_model import TorchModel

#: distance of an unreachable pair, and of the dummy node to every atom
FAR = 1e6



class MATEncoding:
    """A molecule's node features, adjacency and distances."""

    def __init__(self, node_features, adjacency_matrix, distance_matrix):
        self.node_features = node_features
        self.adjacency_matrix = adjacency_matrix
        self.distance_matrix = distance_matrix


class MATFeaturizer(MolecularFeaturizer):
    """Each atom's one-hots (symbol of 12 and other, degree 0-5, hydrogens
    0-4, charge -1..1 and other) and ring and aromatic flags, after a
    dummy node with a feature column of its own; the adjacency; the
    distances of the conformer where there is one, else the bond counts
    of a breadth-first search (``FAR`` where unreachable).  The dummy node
    is unconnected and ``FAR`` from every atom."""

    def construct_mol(self, mol) -> Molecule:
        """A SMILES string parsed (``ValueError`` if it does not), a
        molecule as it is."""
        if isinstance(mol, str):
            parsed = mol_from_smiles(mol)
            if parsed is None:
                raise ValueError(f'unparseable SMILES {mol!r}')
            return parsed
        return mol

    def atom_features(self, atom) -> np.ndarray:
        return np.asarray(
            fu.one_hot_encode(atom.symbol,
                              ['B', 'Br', 'C', 'Cl', 'F', 'I', 'N',
                               'O', 'P', 'S', 'Se', 'Si'], True)
            + fu.one_hot_encode(atom.degree, [0, 1, 2, 3, 4, 5], False)
            + fu.one_hot_encode(atom.total_hs, [0, 1, 2, 3, 4], False)
            + fu.one_hot_encode(atom.formal_charge, [-1, 0, 1], True)
            + [float(atom.in_ring), float(atom.is_aromatic)],
            dtype=np.float32)

    def construct_node_features_matrix(self, mol: Molecule) -> np.ndarray:
        return np.asarray([self.atom_features(a) for a in mol.atoms],
                          dtype=np.float32)

    def _featurize(self, mol: Molecule, **kwargs) -> MATEncoding:
        mol = self.construct_mol(mol)
        n = mol.num_atoms
        node = self.construct_node_features_matrix(mol)
        adj = np.zeros((n, n), dtype=np.float32)
        for b in mol.bonds:
            adj[b.a1, b.a2] = adj[b.a2, b.a1] = 1.0
        if mol.conformer is not None:
            xyz = np.asarray(mol.conformer)
            dist = np.linalg.norm(xyz[:, None] - xyz[None, :], axis=-1)
        else:
            dist = np.full((n, n), FAR, dtype=np.float32)
            for i in range(n):
                dist[i, i] = 0
                queue = deque([i])
                while queue:
                    u = queue.popleft()
                    for v in mol.neighbors(u):
                        if dist[i, v] > dist[i, u] + 1:
                            dist[i, v] = dist[i, u] + 1
                            queue.append(v)
        nd = np.zeros((n + 1, node.shape[1] + 1), dtype=np.float32)
        nd[1:, 1:] = node
        nd[0, 0] = 1.0
        adj2 = np.zeros((n + 1, n + 1), dtype=np.float32)
        adj2[1:, 1:] = adj
        dist2 = np.full((n + 1, n + 1), FAR, dtype=np.float32)
        dist2[1:, 1:] = dist
        return MATEncoding(nd, adj2, dist2)


class ScaleNorm(nn.Module):
    """``x * s / sqrt(|x|^2 + eps^2)`` with a learned scalar ``s``,
    initialised to ``sqrt(scale)``."""

    def __init__(self, scale: float = 1.0, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale_param = nn.Parameter(
            torch.tensor(float(np.sqrt(scale)), dtype=torch.float32))

    def forward(self, x):
        norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)
                          + self.eps ** 2)
        return x * (self.scale_param / norm)


class _MATAttention(nn.Module):
    """Molecule-aware self-attention: ``lambda_attention`` times the
    softmax of ``q k^T / sqrt(d)`` over the real atoms, plus ``1 -
    lambda_attention - lambda_distance`` times the row-normalised
    adjacency, plus ``lambda_distance`` times the distance kernel
    (``'softmax'`` of ``-dist`` over the real atoms, or ``'exp'``:
    ``exp(-dist)`` there, 0 elsewhere), applied to ``v`` per head, then
    projected."""

    def __init__(self, dim: int, n_heads: int, lambda_attention: float,
                 lambda_distance: float, dist_kernel: str = 'softmax',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim, self.n_heads = dim, n_heads
        self.lambda_attention, self.lambda_distance = lambda_attention, \
            lambda_distance
        self.dist_kernel = dist_kernel
        self.q = dense(dim, dim, generator)
        self.k = dense(dim, dim, generator)
        self.v = dense(dim, dim, generator)
        self.out = dense(dim, dim, generator)

    def forward(self, x, adj, dist, mask):
        B, A, _ = x.shape
        H = self.n_heads
        dh = self.dim // H
        q = self.q(x).reshape(B, A, H, dh)
        k = self.k(x).reshape(B, A, H, dh)
        v = self.v(x).reshape(B, A, H, dh)
        real = mask[:, None, :] > 0                          # [B, 1, A]
        logits = torch.einsum('bihd,bjhd->bhij', q, k) / math.sqrt(dh)
        logits = torch.where(real[:, None], logits,
                             logits.new_tensor(-1e9))
        att = torch.softmax(logits, dim=-1)
        adj_n = adj / torch.clamp_min(adj.sum(dim=-1, keepdim=True), 1.0)
        if self.dist_kernel == 'exp':
            dist_k = torch.where(real, torch.exp(-dist), dist.new_zeros(()))
        else:
            dist_k = torch.softmax(torch.where(real, -dist,
                                               dist.new_tensor(-1e9)),
                                   dim=-1)
        lam_a, lam_d = self.lambda_attention, self.lambda_distance
        mixed = lam_a * att + (1.0 - lam_a - lam_d) * adj_n[:, None] \
            + lam_d * dist_k[:, None]
        out = torch.einsum('bhij,bjhd->bihd', mixed, v).reshape(B, A,
                                                                self.dim)
        return self.out(out)


class _MATModule(nn.Module):
    """The embedding, ``n_layers`` pre-norm blocks (attention, then a
    GELU feed-forward of ``2 dim``, each added to its input, with dropout
    in training), a final norm (``'layer'`` or ``'scale'``: ScaleNorm) and
    the readout: the masked ``'mean'`` or ``'sum'`` over the atoms, or
    ``'grover'``'s four attention pools (``gen_att1``, ``gen_att2``)
    flattened; then the head.  Parameters are initialised as flax
    initialises the JAX module, from ``generator``; ``flax_scopes`` names
    flax's numbered scopes."""

    def __init__(self, n_features: int, n_tasks: int, n_classes: int,
                 dim: int, n_layers: int, n_heads: int,
                 lambda_attention: float, lambda_distance: float,
                 dropout: float, mode: str, dist_kernel: str = 'softmax',
                 norm: str = 'layer', aggregation: str = 'mean',
                 generator: Optional[torch.Generator] = None,
                 dropout_seed: int = 0):
        super().__init__()
        if norm not in ('layer', 'scale'):
            raise ValueError(f'bad norm {norm!r}')
        if aggregation not in ('mean', 'sum', 'grover'):
            raise ValueError(f'bad aggregation {aggregation!r}')
        self.n_tasks, self.n_classes, self.mode = n_tasks, n_classes, mode
        self.dropout, self.dropout_seed = dropout, dropout_seed
        self.aggregation = aggregation
        self._dropout_generator: Optional[torch.Generator] = None

        def make_norm():
            return ScaleNorm(dim) if norm == 'scale' \
                else nn.LayerNorm(dim, eps=1e-6)
        self.embed = dense(n_features, dim, generator)
        self.attn_norms = nn.ModuleList()
        self.attns = nn.ModuleList()
        self.ffn_norms = nn.ModuleList()
        self.ffn_in = nn.ModuleList()
        self.ffn_out = nn.ModuleList()
        for _ in range(n_layers):
            self.attns.append(_MATAttention(dim, n_heads, lambda_attention,
                                            lambda_distance, dist_kernel,
                                            generator))
            self.attn_norms.append(make_norm())
            self.ffn_out.append(dense(2 * dim, dim, generator))
            self.ffn_in.append(dense(dim, 2 * dim, generator))
            self.ffn_norms.append(make_norm())
        self.final_norm = make_norm()
        width = dim
        if aggregation == 'grover':
            self.gen_att2 = dense(128, 4, generator, bias=False)
            self.gen_att1 = dense(dim, 128, generator, bias=False)
            width = 4 * dim
        n_out = n_tasks * n_classes if mode == 'classification' else n_tasks
        self.head = dense(width, n_out, generator)
        norm_scope = 'ScaleNorm' if norm == 'scale' else 'LayerNorm'
        self.flax_scopes = {
            'Dense_0': 'embed', f'Dense_{1 + 2 * n_layers}': 'head',
            f'{norm_scope}_{2 * n_layers}': 'final_norm',
            **{k: v for i in range(n_layers) for k, v in (
                (f'_MATAttention_{i}', f'attns.{i}'),
                (f'_MATAttention_{i}/Dense_0', 'q'),
                (f'_MATAttention_{i}/Dense_1', 'k'),
                (f'_MATAttention_{i}/Dense_2', 'v'),
                (f'_MATAttention_{i}/Dense_3', 'out'),
                (f'{norm_scope}_{2 * i}', f'attn_norms.{i}'),
                (f'{norm_scope}_{2 * i + 1}', f'ffn_norms.{i}'),
                (f'Dense_{1 + 2 * i}', f'ffn_out.{i}'),
                (f'Dense_{2 + 2 * i}', f'ffn_in.{i}'))}}
        self.flax_leaves = {'scale': 'weight', 'scale_param': 'scale_param'}

    def _drop(self, h: torch.Tensor) -> torch.Tensor:
        if not self.training or self.dropout == 0:
            return h
        gen = self._dropout_generator
        if gen is None or gen.device != h.device:
            gen = torch.Generator(h.device).manual_seed(self.dropout_seed)
            self._dropout_generator = gen
        keep = torch.empty_like(h).bernoulli_(1 - self.dropout, generator=gen)
        return h * keep / (1 - self.dropout)

    def forward(self, x, adj, dist, mask):
        h = self.embed(x)
        for attn, an, fn, f_in, f_out in zip(self.attns, self.attn_norms,
                                              self.ffn_norms, self.ffn_in,
                                              self.ffn_out):
            h = h + self._drop(attn(an(h), adj, dist, mask))
            h = h + self._drop(f_out(F.gelu(f_in(fn(h)),
                                            approximate='tanh')))
        h = self.final_norm(h)
        m = mask[..., None]
        if self.aggregation == 'sum':
            g = torch.sum(h * m, dim=1)
        elif self.aggregation == 'grover':
            att = self.gen_att2(torch.tanh(self.gen_att1(h)))   # [B, A, 4]
            att = torch.softmax(torch.where(m > 0, att, att.new_tensor(-1e9)),
                                dim=1)
            g = torch.einsum('bak,bad->bkd', att, h).reshape(h.shape[0], -1)
        else:
            g = torch.sum(h * m, dim=1) / torch.clamp_min(
                mask.sum(dim=1, keepdim=True), 1.0)
        out = self.head(g)
        if self.mode == 'classification':
            logits = out.reshape(-1, self.n_tasks, self.n_classes)
            return torch.softmax(logits, dim=-1), logits
        return out


class MATModel(TorchModel):
    """The Molecule Attention Transformer over :class:`MATFeaturizer`
    encodings: ``dim`` wide, ``n_layers`` blocks of ``n_heads`` heads.  A
    regressor trains on squared error, a classifier on softmax cross
    entropy.  The module is built at construction from a generator seeded
    with ``seed`` (which also seeds dropout); load flax parameters with
    :func:`params_from_flax`."""

    atom_quantum = 16
    #: when set, every batch pads to this many atoms
    #: (:meth:`_collect_uniform_batches`)
    _fixed_atoms: Optional[int] = None

    def __init__(self, n_tasks: int = 1, dim: int = 64, n_layers: int = 2,
                 n_heads: int = 8, lambda_attention: float = 0.33,
                 lambda_distance: float = 0.33, dropout_p: float = 0.0,
                 mode: str = 'regression', n_classes: int = 2,
                 dist_kernel: str = 'softmax', norm: str = 'layer',
                 aggregation_type: str = 'mean', batch_size: int = 32,
                 n_features: int = 31, seed: int = 0, **kwargs):
        self.n_tasks, self.mode, self.n_classes = n_tasks, mode, n_classes
        self.n_features = n_features

        def module(generator):
            return _MATModule(
                n_features=n_features, n_tasks=n_tasks, n_classes=n_classes,
                dim=dim, n_layers=n_layers, n_heads=n_heads,
                lambda_attention=lambda_attention,
                lambda_distance=lambda_distance, dropout=dropout_p,
                mode=mode, dist_kernel=dist_kernel, norm=norm,
                aggregation=aggregation_type, generator=generator,
                dropout_seed=seed)
        if mode == 'classification':
            loss, output_types = SoftmaxCrossEntropy(), ['prediction', 'loss']
        else:
            loss, output_types = L2Loss(), ['prediction']
        super().__init__(module, loss, output_types=output_types,
                         batch_size=batch_size, seed=seed, **kwargs)

    def build(self, sample_inputs) -> None:
        if sample_inputs[0].shape[-1] != self.n_features:
            raise ValueError(f'batch has {sample_inputs[0].shape[-1]} atom '
                             f'features; the model was built for '
                             f'{self.n_features}')
        super().build(sample_inputs)

    @staticmethod
    def pad_array(array: np.ndarray, shape) -> np.ndarray:
        """``array`` zero-padded to ``shape``."""
        array = np.asarray(array)
        result = np.zeros(shape=shape, dtype=array.dtype)
        result[tuple(slice(s) for s in array.shape)] = array
        return result

    def pad_sequence(self, sequence) -> np.ndarray:
        """Every array padded to the largest shape, stacked."""
        shapes = np.stack([np.array(np.asarray(t).shape) for t in sequence])
        max_shape = tuple(np.max(shapes, axis=0))
        return np.stack([self.pad_array(t, max_shape) for t in sequence])

    def _atoms(self, X_b) -> int:
        """The batch's ``A``: its largest molecule rounded up to
        ``atom_quantum``."""
        q = self.atom_quantum
        max_atoms = max(len(e.node_features) for e in X_b)
        return max(q, ((max_atoms + q - 1) // q) * q)

    def _mat_inputs(self, X_b) -> List[np.ndarray]:
        """``[x, adj, dist, mask]``, ``[B, A, ...]``: ``A`` the largest
        molecule rounded up to ``atom_quantum`` (or the epoch's, for
        uniform batches), pad distances ``FAR``; a pad atom is masked
        out of every attention and readout, so ``A`` does not change an
        answer."""
        encs = list(X_b)
        B = self.batch_size
        A = self._fixed_atoms or self._atoms(encs)
        nf = encs[0].node_features.shape[1]
        x = np.zeros((B, A, nf), dtype=np.float32)
        adj = np.zeros((B, A, A), dtype=np.float32)
        dist = np.full((B, A, A), FAR, dtype=np.float32)
        mask = np.zeros((B, A), dtype=np.float32)
        for i, e in enumerate(encs):
            n = len(e.node_features)
            x[i, :n] = e.node_features
            adj[i, :n, :n] = e.adjacency_matrix
            dist[i, :n, :n] = e.distance_matrix
            mask[i, :n] = 1.0
        return [x, adj, dist, mask]

    def _collect_uniform_batches(self, dataset: NumpyDataset,
                                 deterministic: bool = True,
                                 mode: str = 'fit') -> List:
        """One epoch of host batches, all padded to the epoch's largest
        ``A``, so that ``fit_on_device`` can stack them (the JAX
        package's, with an ``A`` a batch, cannot when they differ)."""
        self._fixed_atoms = max(self._atoms(X_b) for X_b, _, _, _ in
                                dataset.iterbatches(
                                    batch_size=self.batch_size,
                                    deterministic=True))
        try:
            return super()._collect_uniform_batches(dataset, deterministic,
                                                    mode)
        finally:
            self._fixed_atoms = None

    def default_generator(self, dataset: NumpyDataset, epochs: int = 1,
                          mode: str = 'fit', deterministic: bool = True,
                          pad_batches: bool = True):
        """A short last batch keeps ``batch_size`` molecule slots: its
        labels are padded and its empty slots weigh 0.  In ``mode='fit'``
        a classifier's labels become one-hot."""
        for _ in range(epochs):
            for (X_b, y_b, w_b, _) in dataset.iterbatches(
                    batch_size=self.batch_size,
                    deterministic=deterministic, pad_batches=False):
                if len(X_b) < self.batch_size:
                    _, y_b, w_b, _ = pad_batch(self.batch_size,
                                               np.zeros(len(X_b)), y_b, w_b,
                                               None)
                if self.mode == 'classification' and y_b is not None \
                        and mode == 'fit':
                    y_b = np.stack([to_one_hot(y_b[:, t], self.n_classes)
                                    for t in range(self.n_tasks)], axis=1)
                yield (self._mat_inputs(X_b), [y_b], [w_b])

    def get_num_tasks(self) -> int:
        return self.n_tasks

    def get_task_type(self) -> str:
        return self.mode
