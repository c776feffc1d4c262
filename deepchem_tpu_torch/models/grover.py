"""GROVER: the graph transformer with self-supervised pretraining, in both
of its batch layouts.

Counterparts of ``deepchem_tpu/models/grover.py``: the functional-group
checks, ``GroverAtomVocabularyBuilder``, ``GroverBondVocabularyBuilder``,
``GroverFeaturizer``, the four custom-VJP neighbour sums
(``_nei_sum_sym``, ``_nei_sum_bonds`` and their grouped twins), the packed
layout's helpers (``_p_agg``, ``_p_rev``, ``_p_mean_readout``),
``_GroverMPN``, ``_GroverGroupedMPN``, ``_TinySeqAttention``,
``_GroverMTBlock``, ``_PositionwiseFFN``, ``GroverTransEncoder``,
``_GroverPretrainModule``, ``_GroverFinetuneModule`` and ``GroverModel``.
Each module's attribute names are the flax scope names, so one flax tree
loads into either layout (``models/convert.py``
:func:`grover_params_from_flax`).

The flat layout (``packed=False``) pads every neighbour list to
``max_neighbors`` slots that point at the ghost row 0 and sums all of
them.  Its four custom VJPs are ``torch.autograd.Function``s whose
forward is K1 (``csrc/nei_table.cu`` ``nei_sum_kernel``) with every
degree set to the table's width; the backward copies the JAX package's:
the same slot sum of the cotangent for the symmetric atom table, the row
gather ``g[rev_dst]`` for the incoming-bond table.  A grouped ``(G, N,
H)`` sum is one K1 launch over ``[G N, H]`` rows through an offset table
``table + g R``, built on the device once a batch.  Every other gather
that needs a gradient (by ``b2a``, ``b2revb``, the bonds' destination,
and the to-bond slot sums, which JAX transposes with a scatter-add) has
a backward that is P2 over a CSR built when the batch is packed, so a
step adds in a fixed order; ``b2revb`` maps the ghost and every pad slot
to row 0, whose gradient sums all their cotangents.  The readouts are P3
over each molecule's real rows.

The packed layout (``packed=True``, the default) sums through dense 0/1
incidences per molecule with ``torch.bmm`` and ``torch.einsum`` (cuBLAS),
as the JAX package computes them outside any Pallas kernel; the reverse
of bond ``2i`` is ``2i + 1``, a pair flip.
"""

from __future__ import annotations

import collections
import csv
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from deepchem_tpu_torch.chem import Molecule, mol_from_smiles
from deepchem_tpu_torch.data import NumpyDataset
from deepchem_tpu_torch.feat import feature_utils as fu
from deepchem_tpu_torch.feat.base import MolecularFeaturizer
from deepchem_tpu_torch.feat.graph_data import GraphData, bucket_caps
from deepchem_tpu_torch.metrics import to_one_hot
from deepchem_tpu_torch.models.gnn_modular import ModularModel
from deepchem_tpu_torch.models.graph_layers import dense, lecun_normal_
from deepchem_tpu_torch.models.graph_models import (GraphModel,
                                                    _gnn_loss_outputs)
from deepchem_tpu_torch.models.losses import _abs, _maximum
from deepchem_tpu_torch.models.torch_model import TorchModel
from deepchem_tpu_torch.ops import csr_segment, edges_to_csr, gather_rows
from deepchem_tpu_torch.ops.csr_segment import csr_segment_sum
from deepchem_tpu_torch.ops import nei_table



# ---------------------------------------------------------------- host side

def _has_group(mol: Molecule, pattern: str) -> bool:
    """A carbon with two oxygen neighbours, one of them double-bonded (the
    carboxylic acid check; ``pattern`` is not parsed)."""
    for a in mol.atoms:
        if a.atomic_num != 6:
            continue
        bonds = [b for b in mol.atom_bonds(a.index)
                 if mol.atoms[b.other(a.index)].atomic_num == 8]
        if len(bonds) >= 2 and 2.0 in [b.order for b in bonds]:
            return True
    return False


#: predicate checks of ten functional groups: the pretraining targets
_FG_CHECKS = [
    ('carboxylic_acid', lambda m: _has_group(m, 'C(=O)O')),
    ('amine', lambda m: any(a.atomic_num == 7 and a.total_hs >= 1
                            for a in m.atoms)),
    ('hydroxyl', lambda m: any(a.atomic_num == 8 and a.total_hs >= 1
                               for a in m.atoms)),
    ('carbonyl', lambda m: any(
        b.order == 2.0 and {m.atoms[b.a1].atomic_num,
                            m.atoms[b.a2].atomic_num} == {6, 8}
        for b in m.bonds)),
    ('aromatic_ring', lambda m: any(a.is_aromatic for a in m.atoms)),
    ('halogen', lambda m: any(a.atomic_num in (9, 17, 35, 53)
                              for a in m.atoms)),
    ('nitro', lambda m: any(
        a.atomic_num == 7 and sum(
            1 for b in m.atom_bonds(a.index)
            if m.atoms[b.other(a.index)].atomic_num == 8) >= 2
        for a in m.atoms)),
    ('sulfonyl', lambda m: any(a.atomic_num == 16 and a.degree >= 3
                               for a in m.atoms)),
    ('ether', lambda m: any(a.atomic_num == 8 and a.degree == 2
                            for a in m.atoms)),
    ('thiol', lambda m: any(a.atomic_num == 16 and a.total_hs >= 1
                            for a in m.atoms)),
]


class GroverAtomVocabularyBuilder:
    """Atom-context vocabulary: an atom's context is its symbol and the
    sorted multiset of its neighbours' (symbol, bond type); id 0 is
    ``<other>``, the rest by frequency (``max_size`` at most)."""

    def __init__(self, max_size: Optional[int] = None):
        self.max_size = max_size
        self.stoi: Dict[str, int] = {'<other>': 0}

    @staticmethod
    def atom_to_vocab(mol: Molecule, atom) -> str:
        nbrs: collections.Counter = collections.Counter()
        for b in mol.atom_bonds(atom.index):
            o = mol.atoms[b.other(atom.index)]
            nbrs[f'{o.symbol}-{b.type_name()}'] += 1
        ctx = '_'.join(f'{k}{v}' for k, v in sorted(nbrs.items()))
        return f'{atom.symbol}|{ctx}'

    def _contexts(self, mol: Molecule) -> List[str]:
        return [self.atom_to_vocab(mol, a) for a in mol.atoms]

    def build(self, mols: Sequence[Molecule]) -> None:
        counter: collections.Counter = collections.Counter()
        for mol in mols:
            if mol is not None:
                counter.update(self._contexts(mol))
        for key, _ in counter.most_common(self.max_size):
            if key not in self.stoi:
                self.stoi[key] = len(self.stoi)

    @property
    def size(self) -> int:
        return len(self.stoi)

    def encode(self, mol: Molecule, atom) -> int:
        return self.stoi.get(self.atom_to_vocab(mol, atom), 0)

    def build_from_csv(self, csv_path: str,
                       smiles_field: str = 'smiles') -> None:
        """Build from the column ``smiles_field`` of a CSV file; rows
        whose SMILES does not parse are skipped."""
        with open(csv_path, newline='') as f:
            smiles = [row[smiles_field] for row in csv.DictReader(f)]
        mols = []
        for s in smiles:
            try:
                mols.append(mol_from_smiles(s))
            except ValueError:
                continue
        self.build([m for m in mols if m is not None])

    def save(self, fname: str) -> None:
        """Write ``max_size`` and the vocabulary as JSON."""
        with open(fname, 'w') as f:
            json.dump({'max_size': self.max_size, 'stoi': self.stoi}, f)

    @classmethod
    def load(cls, fname: str):
        """A vocabulary written by :meth:`save`."""
        with open(fname) as f:
            data = json.load(f)
        obj = cls(max_size=data.get('max_size'))
        obj.stoi = {k: int(v) for k, v in data['stoi'].items()}
        return obj


class GroverBondVocabularyBuilder(GroverAtomVocabularyBuilder):
    """Bond-context vocabulary: the two end symbols, sorted, around the
    bond type."""

    @staticmethod
    def bond_to_vocab(mol: Molecule, bond) -> str:
        a1, a2 = sorted([mol.atoms[bond.a1].symbol,
                         mol.atoms[bond.a2].symbol])
        return f'{a1}-{bond.type_name()}-{a2}'

    def _contexts(self, mol: Molecule) -> List[str]:
        return [self.bond_to_vocab(mol, b) for b in mol.bonds]

    def encode_bond(self, mol: Molecule, bond) -> int:
        return self.stoi.get(self.bond_to_vocab(mol, bond), 0)


class GroverFeaturizer(MolecularFeaturizer):
    """``GraphData`` with 75 atom features, each bond as two directed
    edges ``(a1 -> a2, a2 -> a1)`` with 6 features (type one-hot,
    conjugated, in ring), the functional-group labels ``fg_label``, and
    with the vocabularies given ``atom_vocab_label`` and
    ``bond_vocab_label`` (one a directed edge), and with
    ``features_generator`` its molecule features as
    ``additional_features``.  A molecule without bonds gets edge features
    ``[0, 6]``."""

    def __init__(self, features_generator=None,
                 atom_vocab: Optional[GroverAtomVocabularyBuilder] = None,
                 bond_vocab: Optional[GroverBondVocabularyBuilder] = None):
        super().__init__()
        self.features_generator = features_generator
        self.atom_vocab = atom_vocab
        self.bond_vocab = bond_vocab

    def _featurize(self, mol: Molecule, **kwargs) -> GraphData:
        feats = fu.atom_features_75_mol(mol)
        src, dst, ef = [], [], []
        for b in mol.bonds:
            src += [b.a1, b.a2]
            dst += [b.a2, b.a1]
            bf = fu.get_bond_type_one_hot(b) + [
                float(b.is_conjugated), float(b.in_ring)]
            ef += [bf, bf]
        ei = np.array([src, dst], dtype=np.int64).reshape(2, -1)
        extra = {}
        if self.atom_vocab is not None:
            extra['atom_vocab_label'] = np.array(
                [self.atom_vocab.encode(mol, a) for a in mol.atoms],
                dtype=np.int32)
        if self.bond_vocab is not None:
            extra['bond_vocab_label'] = np.repeat(np.array(
                [self.bond_vocab.encode_bond(mol, b) for b in mol.bonds],
                dtype=np.int32), 2)
        extra['fg_label'] = np.array([float(chk(mol)) for _, chk in
                                      _FG_CHECKS], dtype=np.float32)
        if self.features_generator is not None:
            extra['additional_features'] = np.asarray(
                self.features_generator._featurize(mol),
                dtype=np.float32).reshape(-1)
        ef_arr = np.asarray(ef, dtype=np.float32).reshape(len(ef), 6)
        return GraphData(feats, ei, ef_arr, **extra)


# ------------------------------------------- the flat layout's custom VJPs

def _full_deg(table: torch.Tensor) -> torch.Tensor:
    """K1's degrees with every slot counted: GROVER sums its pad slots,
    which point at the ghost row 0."""
    return torch.full((table.shape[0],), table.shape[1], dtype=torch.int8,
                      device=table.device)


def _k1(x: torch.Tensor, table: torch.Tensor, counter,
        attr: str = 'launches') -> torch.Tensor:
    """K1 over every slot of ``table`` from the rows of ``x`` ``[R, F]``."""
    return nei_table._nei_sum_forward(x.contiguous(), table, _full_deg(table),
                                      counter, attr)


def grouped_table(table: torch.Tensor, groups: int,
                  rows: int) -> torch.Tensor:
    """``[G N, K]``: group ``g``'s copy of ``table`` ``[N, K]`` offset by
    ``g * rows``, so one K1 launch sums ``[G R, F]`` rows for every
    group."""
    off = torch.arange(groups, dtype=table.dtype,
                       device=table.device) * rows
    return (table[None] + off[:, None, None]).reshape(-1, table.shape[1])


class _NeiSumSym(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, table, counter):
        ctx.save_for_backward(table)
        ctx.counter = counter
        return _k1(x.reshape(table.shape[0], -1), table,
                   counter).reshape(x.shape)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        table, = ctx.saved_tensors
        return _k1(g.reshape(table.shape[0], -1), table, ctx.counter,
                   'backward_launches').reshape(g.shape), None, None


class _NeiSumBonds(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, table, rev_dst, counter):
        ctx.save_for_backward(rev_dst)
        ctx.grouped = x.ndim == 3
        out = _k1(x.reshape(-1, x.shape[-1]), table, counter)
        return out.reshape(x.shape[0], -1, x.shape[-1]) if ctx.grouped \
            else out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        rev_dst, = ctx.saved_tensors
        return g.index_select(1 if ctx.grouped else 0,
                              rev_dst.long()), None, None, None


def nei_sum_sym(messages: torch.Tensor, a2a: torch.Tensor) -> torch.Tensor:
    """``Σ_j messages[a2a[i, j]]`` over every slot of the atom table ``a2a``
    ``[N, K]`` int32 (pad slots at row 0), ``messages`` ``[N, H]``
    float32: K1.  The backward is the JAX package's custom VJP, the same
    slot sum of the cotangent (K1 again).  CUDA launches count in
    ``nei_sum_sym.launches`` and ``.backward_launches``."""
    return _NeiSumSym.apply(messages, a2a, nei_sum_sym)


def nei_sum_bonds(messages: torch.Tensor, a2b: torch.Tensor,
                  rev_dst: torch.Tensor) -> torch.Tensor:
    """``Σ_j messages[a2b[i, j]]`` over every slot of the incoming-bond
    table ``a2b`` ``[N, K]`` (entries in ``[0, E)``), ``messages`` ``[E,
    H]``: K1 into ``[N, H]``.  The backward is the JAX package's custom
    VJP, the row gather ``g[rev_dst]`` ``[E, H]`` (``rev_dst`` the bonds'
    destinations, 0 for the ghost and pad slots).  CUDA launches count in
    ``nei_sum_bonds.launches``."""
    return _NeiSumBonds.apply(messages, a2b, rev_dst, nei_sum_bonds)


def nei_sum_sym_g(messages: torch.Tensor, a2a: torch.Tensor,
                  table_g: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`nei_sum_sym` of each group of ``messages`` ``[G, N, H]``: one
    K1 launch over ``[G N, H]`` through ``table_g`` (:func:`grouped_table`
    of ``a2a``, built here when not given), forward and backward, counted
    in ``nei_sum_sym_g.launches`` and ``.backward_launches``."""
    G, N = messages.shape[:2]
    if table_g is None:
        table_g = grouped_table(a2a, G, N)
    return _NeiSumSym.apply(messages, table_g, nei_sum_sym_g)


def nei_sum_bonds_g(messages: torch.Tensor, a2b: torch.Tensor,
                    rev_dst: torch.Tensor,
                    table_g: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`nei_sum_bonds` of each group of ``messages`` ``[G, E, H]``
    into ``[G, N, H]``: one K1 launch through ``table_g``
    (:func:`grouped_table` of ``a2b`` with offsets ``g E``), counted in
    ``nei_sum_bonds_g.launches``; the backward gathers ``g[:, rev_dst]``."""
    G, E = messages.shape[:2]
    if table_g is None:
        table_g = grouped_table(a2b, G, E)
    return _NeiSumBonds.apply(messages, table_g, rev_dst, nei_sum_bonds_g)


class _SlotSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, table, order, row_ptr):
        ctx.save_for_backward(order, row_ptr)
        return _k1(x, table, slot_sum)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        order, row_ptr = ctx.saved_tensors
        return csr_segment._gather_sum_forward(
            g.contiguous(), order, row_ptr, 'backward_launches'), \
            None, None, None


def slot_sum(x: torch.Tensor, table: torch.Tensor, order: torch.Tensor,
             row_ptr: torch.Tensor) -> torch.Tensor:
    """``Σ_j x[table[i, j]]`` over every slot of ``table`` ``[M, K]``:
    K1, counted in ``slot_sum.launches``.  JAX transposes it with a
    scatter-add; here the gradient ``dx[n] = Σ_{table[i, j] = n} g[i]``
    is P2 over the CSR of the table's entries by value (``order`` ``[M
    K]`` the output row of each entry in a stable sort, ``row_ptr``
    ``[len(x) + 1]``), counted in
    ``fused_gather_segment_sum.backward_launches``."""
    return _SlotSum.apply(x, table, order, row_ptr)


class _GatherRowsG(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, index, order_g, row_ptr_g):
        ctx.save_for_backward(order_g, row_ptr_g)
        ctx.shape = x.shape
        return x.index_select(1, index.long())

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        order_g, row_ptr_g = ctx.saved_tensors
        dx = csr_segment._gather_sum_forward(
            g.reshape(-1, g.shape[-1]).contiguous(), order_g, row_ptr_g,
            'backward_launches')
        return dx.reshape(ctx.shape), None, None, None


def grouped_csr(order: torch.Tensor, row_ptr: torch.Tensor, groups: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CSR of a gather by ``index`` ``[E]`` (``order``, ``row_ptr``)
    repeated for each group of a ``[G, E, H]`` cotangent viewed as ``[G E,
    H]``, into ``[G N, H]``."""
    E = order.shape[0]
    off = torch.arange(groups, dtype=order.dtype, device=order.device) * E
    order_g = (order[None] + off[:, None]).reshape(-1)
    ptr_g = torch.cat([(row_ptr[None, :-1] + off[:, None]).reshape(-1),
                       (off[-1:] + E) if groups else off[:1]])
    return order_g, ptr_g


def gather_rows_g(x: torch.Tensor, index: torch.Tensor,
                  csr_g: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """``x[:, index]`` for ``x`` ``[G, N, H]``: the gradient is one P2
    launch over ``csr_g`` (:func:`grouped_csr`), counted in
    ``fused_gather_segment_sum.backward_launches``."""
    return _GatherRowsG.apply(x, index, *csr_g)


nei_sum_sym.launches = nei_sum_sym.backward_launches = 0
nei_sum_sym_g.launches = nei_sum_sym_g.backward_launches = 0
nei_sum_bonds.launches = nei_sum_bonds_g.launches = 0
slot_sum.launches = 0


class FlatGraph:
    """A flat batch's index tensors, and what is built from them on the
    device once a batch: the bonds' destinations ``rev_dst = b2a[b2revb]``,
    the to-bond tables (``b2a`` beside ``a2a[b2a]``, ``[E, K + 1]``; and
    ``a2b[b2a]``, ``[E, K]``), and for ``groups`` (3 heads) the offset
    tables and CSRs of the grouped sums and gathers."""

    def __init__(self, a2b, b2a, b2revb, a2a, csr: Sequence[torch.Tensor],
                 groups: int):
        self.a2b, self.b2a, self.b2revb, self.a2a = a2b, b2a, b2revb, a2a
        (b2a_o, b2a_p, revb_o, revb_p, dst_o, dst_p, alfb_o, alfb_p,
         blfb_o, blfb_p, self.node_ptr, self.edge_ptr) = csr
        self.b2a_csr, self.revb_csr = (b2a_o, b2a_p), (revb_o, revb_p)
        self.dst_csr = (dst_o, dst_p)
        self.alfb_csr, self.blfb_csr = (alfb_o, alfb_p), (blfb_o, blfb_p)
        b = b2a.long()
        self.rev_dst = b2a.index_select(0, b2revb.long())
        self.alfb = torch.cat([b2a[:, None], a2a.index_select(0, b)], dim=1)
        self.blfb = a2b.index_select(0, b)
        N, E = a2a.shape[0], b2a.shape[0]
        self.a2a_g = grouped_table(a2a, groups, N)
        self.a2b_g = grouped_table(a2b, groups, E)
        self.b2a_csr_g = grouped_csr(*self.b2a_csr, groups)
        self.revb_csr_g = grouped_csr(*self.revb_csr, groups)


def flat_csr(a2b: np.ndarray, b2a: np.ndarray, b2revb: np.ndarray,
             a2a: np.ndarray, gidx: np.ndarray, nmask: np.ndarray,
             emask: np.ndarray, num_graphs: int) -> List[np.ndarray]:
    """Host-side: the CSR arrays a flat batch carries after the JAX
    package's ten (:class:`FlatGraph`'s order), each int32: of the gathers
    by ``b2a`` (into atoms), ``b2revb`` (into bonds) and the bonds'
    destinations, of the to-bond tables' entries by value (``order`` the
    output row of each entry), and the row pointers of each molecule's
    real atoms and bonds, which start after the ghost row."""
    N, E = len(a2a), len(b2a)
    rev_dst = b2a[b2revb]
    out: List[np.ndarray] = []
    for index, rows in ((b2a, N), (b2revb, E), (rev_dst, N)):
        out += list(edges_to_csr(index, rows))
    for table, rows in ((np.concatenate([b2a[:, None], a2a[b2a]], axis=1),
                         N), (a2b[b2a], E)):
        perm, ptr = edges_to_csr(table.reshape(-1), rows)
        out += [(perm // table.shape[1]).astype(np.int32), ptr]
    for ids, mask in ((gidx, nmask), (gidx[b2a], emask)):
        counts = np.bincount(ids[mask > 0], minlength=num_graphs)
        ptr = np.zeros(num_graphs + 1, np.int32)
        np.cumsum(counts[:num_graphs], out=ptr[1:])
        out.append(ptr)
    return out


#: arrays :func:`flat_csr` adds to a flat batch
N_FLAT_CSR = 12


def _flat_mean_readout(x: torch.Tensor, mask: torch.Tensor,
                       row_ptr: torch.Tensor,
                       counts: Optional[torch.Tensor] = None):
    """``graph_pool(x, gidx, B, mask, 'mean')`` of a flat batch: P3 of
    ``x * mask`` over each molecule's real rows (from row 1, past the
    ghost), over the mask's sum there, at least 1.  Returns the means and
    the counts (P3 of the mask), which a second readout of the same rows
    passes back in."""
    feats = (x * mask[:, None])[1:]
    s = csr_segment_sum(feats, row_ptr)
    if counts is None:
        counts = csr_segment_sum(mask[1:, None].contiguous(), row_ptr)
    return s / torch.clamp_min(counts, 1.0), counts


# ------------------------------------------------- the packed layout's sums

def p_agg(x: torch.Tensor, inc: torch.Tensor) -> torch.Tensor:
    """``out[.., b I + i] = Σ_j inc[b, i, j] x[.., b J + j]`` for a 0/1
    incidence ``inc`` ``[B, I, J]``: a batched matmul, ``x`` ``[B J, H]``
    or grouped ``[G, B J, H]``."""
    B, I, J = inc.shape
    inc = inc.to(x.dtype)
    if x.ndim == 2:
        return torch.bmm(inc, x.reshape(B, J, -1)).reshape(B * I, -1)
    G = x.shape[0]
    y = torch.einsum('bij,gbjh->gbih', inc, x.reshape(G, B, J, -1))
    return y.reshape(G, B * I, -1)


def p_rev(x: torch.Tensor) -> torch.Tensor:
    """The reverse bond's row: bonds are stored in (forward, reverse)
    pairs, so row ``2i`` takes ``2i + 1`` and back, a pair flip."""
    n, h = x.shape[-2:]
    return x.reshape(x.shape[:-2] + (n // 2, 2, h)).flip(-2).reshape(x.shape)


def p_mean_readout(x: torch.Tensor, mask: torch.Tensor,
                   num_graphs: int) -> torch.Tensor:
    """Masked mean over each molecule's block of rows."""
    xr = x.reshape(num_graphs, -1, x.shape[-1])
    m = mask.reshape(num_graphs, -1, 1).to(x.dtype)
    return (xr * m).sum(dim=1) / torch.clamp_min(m.sum(dim=1), 1.0)


# ----------------------------------------------------------------- modules

class _Dropout:
    """flax's ``nn.Dropout`` at ``rate`` in training, with masks from a
    generator seeded with ``seed`` on the input's device: a block run again
    by a checkpoint's recompute draws the same masks."""

    def __init__(self, rate: float, training: bool, seed: int = 0):
        self.rate = rate if training else 0.0
        self.seed = seed
        self._gen: Optional[torch.Generator] = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0:
            return x
        if self._gen is None or self._gen.device != x.device:
            self._gen = torch.Generator(x.device).manual_seed(self.seed)
        keep = torch.empty_like(x).bernoulli_(1 - self.rate,
                                              generator=self._gen)
        return x * keep / (1 - self.rate)


def _layer_norm(width: int) -> nn.LayerNorm:
    """flax's ``nn.LayerNorm``: epsilon 1e-6, scale 1, bias 0."""
    return nn.LayerNorm(width, eps=1e-6)


class _GroverMPN(nn.Module):
    """One directed message-passing encoder: ``depth - 1`` rounds of a
    neighbour sum (atom messages through ``a2a``; bond messages through
    ``a2b``, gathered by source, less the reverse bond's message), ``W_h``
    and ReLU, the ghost and pad rows masked after each."""

    def __init__(self, hidden: int, depth: int, atom_messages: bool,
                 input_layer: str = 'none', dropout: float = 0.0,
                 bias: bool = False, packed: bool = False,
                 in_features: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.depth, self.atom_messages = depth, atom_messages
        self.dropout, self.packed = dropout, packed
        if input_layer == 'fc':
            self.W_i = dense(in_features, hidden, generator, bias=bias)
        else:
            self.W_i = None
        self.W_h = dense(hidden, hidden, generator, bias=bias)

    def forward(self, messages, a2nei, b2a, graph: Optional[FlatGraph],
                mask, training: bool = False, seed: int = 0):
        drop = _Dropout(self.dropout, training, seed)
        if self.W_i is not None:
            messages = F.relu(self.W_i(messages))
        messages = messages * mask[:, None]
        for _ in range(self.depth - 1):
            if self.packed:
                messages = p_agg(messages, a2nei) if self.atom_messages \
                    else p_agg(p_agg(messages, a2nei), b2a) - p_rev(messages)
            elif self.atom_messages:
                messages = nei_sum_sym(messages, graph.a2a)
            else:
                nei = nei_sum_bonds(messages, graph.a2b, graph.rev_dst)
                messages = gather_rows(nei, graph.b2a, *graph.b2a_csr) \
                    - gather_rows(messages, graph.b2revb, *graph.revb_csr)
            messages = drop(F.relu(self.W_h(messages))) * mask[:, None]
        return messages


class _GroverGroupedMPN(nn.Module):
    """The q, k and v encoders of every head of a block (``groups`` = 3
    heads) as one grouped computation: the first round aggregates the
    shared input once and fans it out through one ``[H, G H]`` product;
    later rounds sum ``[G, N, H]`` messages in one launch.  ``W_h`` ``[G,
    H, H]`` (``b_h`` ``[G, 1, H]`` with ``bias``).  Needs ``depth >= 2``:
    only from there is it the per-head encoders' computation."""

    def __init__(self, groups: int, hidden: int, depth: int,
                 atom_messages: bool, dropout: float = 0.0,
                 bias: bool = False, packed: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if depth < 2:
            raise ValueError(
                f'_GroverGroupedMPN requires depth >= 2 (got {depth}); the '
                'grouped and per-head encoders are only equivalent from '
                'depth 2')
        self.groups, self.hidden, self.depth = groups, hidden, depth
        self.atom_messages, self.dropout = atom_messages, dropout
        self.packed = packed
        self.W_h = nn.Parameter(torch.empty(groups, hidden, hidden))
        lecun_normal_(self.W_h, generator)
        self.b_h = nn.Parameter(torch.zeros(groups, 1, hidden)) if bias \
            else None

    def _matmul(self, x: torch.Tensor) -> torch.Tensor:
        G, H = self.groups, self.hidden
        if x.ndim == 2:
            y = (x @ self.W_h.transpose(0, 1).reshape(H, G * H)).reshape(
                x.shape[0], G, H).transpose(0, 1)
        else:
            y = torch.bmm(x, self.W_h)
        if self.b_h is not None:
            y = y + self.b_h
        return F.relu(y)

    def _aggregate(self, x, a2nei, b2a, graph: Optional[FlatGraph]):
        if self.packed:
            if self.atom_messages:
                return p_agg(x, a2nei)
            return p_agg(p_agg(x, a2nei), b2a) - p_rev(x)
        if self.atom_messages:
            if x.ndim == 2:
                return nei_sum_sym(x, graph.a2a)
            return nei_sum_sym_g(x, graph.a2a, graph.a2a_g)
        if x.ndim == 2:
            nei = nei_sum_bonds(x, graph.a2b, graph.rev_dst)
            return gather_rows(nei, graph.b2a, *graph.b2a_csr) \
                - gather_rows(x, graph.b2revb, *graph.revb_csr)
        nei = nei_sum_bonds_g(x, graph.a2b, graph.rev_dst, graph.a2b_g)
        return gather_rows_g(nei, graph.b2a, graph.b2a_csr_g) \
            - gather_rows_g(x, graph.b2revb, graph.revb_csr_g)

    def forward(self, f, a2nei, b2a, graph: Optional[FlatGraph], mask,
                training: bool = False, seed: int = 0):
        drop = _Dropout(self.dropout, training, seed)
        m = mask[None, :, None]
        x = drop(self._matmul(self._aggregate(f * mask[:, None], a2nei, b2a,
                                              graph))) * m
        for _ in range(self.depth - 2):
            x = drop(self._matmul(self._aggregate(x, a2nei, b2a, graph))) * m
        return x.contiguous()


class _TinySeqAttention(nn.Module):
    """Multi-head attention over a short sequence (each node's stack of
    ``S`` MPN outputs): ``query``, ``key`` and ``value`` project ``[N, S,
    H]`` to ``num_heads`` heads of ``qkv_features / num_heads``, the
    scores are scaled by ``1 / sqrt(head_dim)`` and softmaxed over the
    keys, and ``out`` projects the heads back.  The JAX package chunks the
    nodes by 4096 to bound a TPU layout's padding; the math is the same
    whole."""

    def __init__(self, num_heads: int, in_features: int, qkv_features: int,
                 out_features: int, dropout_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads, self.dropout_rate = num_heads, dropout_rate
        self.head_dim = qkv_features // num_heads
        width = num_heads * self.head_dim
        self.query = dense(in_features, width, generator)
        self.key = dense(in_features, width, generator)
        self.value = dense(in_features, width, generator)
        self.out = dense(width, out_features, generator)

    def forward(self, q, k, v, training: bool = False, seed: int = 0):
        n, s, _ = q.shape
        nh, hd = self.num_heads, self.head_dim
        qh = self.query(q).reshape(n, s, nh, hd) * (1.0 / float(np.sqrt(hd)))
        kh = self.key(k).reshape(n, -1, nh, hd)
        vh = self.value(v).reshape(n, -1, nh, hd)
        w = torch.softmax(torch.einsum('nsad,ntad->nast', qh, kh), dim=-1)
        w = _Dropout(self.dropout_rate, training, seed)(w)
        o = torch.einsum('nast,ntad->nsad', w, vh).reshape(n, s, nh * hd)
        return self.out(o)


class _GroverMTBlock(nn.Module):
    """A message-passing transformer block: the first block projects its
    input (``W_i``, ReLU, ``input_norm``); each head's q, k and v come
    from its own MPN encoder (all in ``qkv_mpn``), attention runs over
    the heads of each node (``attn``), ``W_o`` projects the heads, and
    with ``res_connection`` the block adds ``res_norm`` of that to its
    input."""

    def __init__(self, hidden: int, num_heads: int, depth: int,
                 atom_messages: bool, in_features: int, dropout: float = 0.0,
                 bias: bool = False, res_connection: bool = True,
                 transform_input: bool = False, packed: bool = False,
                 remat_qkv: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads, self.dropout = num_heads, dropout
        self.res_connection, self.remat_qkv = res_connection, remat_qkv
        if transform_input:
            self.W_i = dense(in_features, hidden, generator, bias=bias)
            self.input_norm = _layer_norm(hidden)
        else:
            self.W_i = self.input_norm = None
        self.qkv_mpn = _GroverGroupedMPN(3 * num_heads, hidden, depth,
                                         atom_messages, dropout, bias,
                                         packed, generator)
        self.attn = _TinySeqAttention(num_heads, hidden, hidden, hidden,
                                      dropout, generator)
        self.W_o = dense(num_heads * hidden, hidden, generator, bias=bias)
        self.res_norm = _layer_norm(hidden) if res_connection else None

    def forward(self, f, a2nei, b2a, graph: Optional[FlatGraph], mask,
                training: bool = False, seed: int = 0):
        drop = _Dropout(self.dropout, training, seed)
        if self.W_i is not None:
            f = drop(self.input_norm(F.relu(self.W_i(f)))) * mask[:, None]
        args = (f, a2nei, b2a, graph, mask, training, seed + 1)
        if self.remat_qkv and torch.is_grad_enabled():
            qkv = checkpoint(self.qkv_mpn, *args, use_reentrant=False)
        else:
            qkv = self.qkv_mpn(*args)
        nh = self.num_heads
        q = qkv[:nh].transpose(0, 1)
        k = qkv[nh:2 * nh].transpose(0, 1)
        v = qkv[2 * nh:].transpose(0, 1)
        x = self.attn(q, k, v, training, seed + 2)
        x = self.W_o(x.reshape(x.shape[0], -1))
        if self.res_connection:
            x = f + drop(self.res_norm(x))
        return x * mask[:, None]


class _PositionwiseFFN(nn.Module):
    """``ff2(dropout(relu(ff1(x))))``."""

    def __init__(self, in_features: int, d_hidden: int, d_output: int,
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        self.ff1 = dense(in_features, d_hidden, generator)
        self.ff2 = dense(d_hidden, d_output, generator)

    def forward(self, x, training: bool = False, seed: int = 0):
        return self.ff2(_Dropout(self.dropout, training, seed)(
            F.relu(self.ff1(x))))


#: the outputs of the encoder, each an FFN of [input features ; sum]
_OUTPUTS = ('atom_from_atom', 'atom_from_bond', 'bond_from_atom',
            'bond_from_bond')


def remat_mode(remat: str, packed: bool, num_atoms: int,
               hidden: int) -> str:
    """What ``remat`` resolves to at ``num_atoms`` atom rows: 'auto' is the
    JAX package's choice by ``num_atoms * hidden``: 'qkv' below 2**22;
    above it 'both' flat, and packed 'none' below 2**23, 'qkv' from
    there."""
    if remat != 'auto':
        return remat
    size = num_atoms * hidden
    if size < 2 ** 22:
        return 'qkv'
    if packed:
        return 'none' if size < 2 ** 23 else 'qkv'
    return 'both'


class GroverTransEncoder(nn.Module):
    """GROVER's dual encoder: ``num_mt_block`` node blocks over atom
    messages and edge blocks over bond messages (``node_block{i}``,
    ``edge_block{i}``), then four embeddings: each atom's features with
    the sum over its neighbours' node states (``atom_from_atom``) or its
    incoming bonds' edge states (``atom_from_bond``), each bond's
    features with its source atom's state plus the source's neighbours'
    less the destination's (``bond_from_atom``), or the source's incoming
    bonds less the reverse bond (``bond_from_bond``); each an FFN and a
    layer norm (``ffn_<name>``, ``<name>_norm``), masked.  ``outputs``
    returns the first so many (finetuning reads two; the JAX package
    computes all four, and its compiler drops the unread ones).

    ``remat``: 'auto', 'both', 'qkv', 'block' or 'none', the levels
    recomputed in the backward (``torch.utils.checkpoint``): 'qkv' each
    block's MPN encoders, 'block' each block, 'both' the two.  'auto'
    takes the JAX package's choice by size (atoms times hidden): 'qkv'
    below 2**22; above it 'both' for the flat layout and, for the packed
    one, 'none' below 2**23 and 'qkv' from there."""

    def __init__(self, hidden: int, node_fdim: int, edge_fdim: int,
                 depth: int = 3, num_mt_block: int = 2, num_heads: int = 4,
                 dropout: float = 0.0, bias: bool = False,
                 res_connection: bool = True, packed: bool = False,
                 remat: str = 'auto',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if remat not in ('auto', 'both', 'qkv', 'block', 'none'):
            raise ValueError(f'bad remat mode {remat!r}')
        self.hidden, self.packed, self.remat = hidden, packed, remat
        self.dropout, self.num_mt_block = dropout, num_mt_block
        self.num_heads = num_heads
        H = hidden
        for i in range(num_mt_block):
            for kind, width in (('node', node_fdim),
                                ('edge', node_fdim + edge_fdim)):
                setattr(self, f'{kind}_block{i}', _GroverMTBlock(
                    H, num_heads, depth, kind == 'node',
                    width if i == 0 else H, dropout, bias, res_connection,
                    transform_input=i == 0, packed=packed,
                    generator=generator))
        for name in _OUTPUTS:
            width = node_fdim if name.startswith('atom') \
                else node_fdim + edge_fdim
            setattr(self, f'ffn_{name}', _PositionwiseFFN(
                width + H, 4 * H, H, dropout, generator))
            setattr(self, f'{name}_norm', _layer_norm(H))

    def remat_mode(self, num_atoms: int) -> str:
        """The levels ``remat`` recomputes at ``num_atoms`` rows."""
        return remat_mode(self.remat, self.packed, num_atoms, self.hidden)

    def forward(self, f_atoms, f_bonds, a2b, b2a, b2revb, a2a, nmask, emask,
                graph: Optional[FlatGraph] = None, training: bool = False,
                seed: int = 0, outputs: int = 4):
        mode = self.remat_mode(f_atoms.shape[0])
        grad = torch.is_grad_enabled()
        node_h, edge_h = f_atoms, f_bonds
        for i in range(self.num_mt_block):
            for kind, a2nei, mask in (('node', a2a, nmask),
                                      ('edge', a2b, emask)):
                block = getattr(self, f'{kind}_block{i}')
                block.remat_qkv = mode in ('both', 'qkv')
                h = node_h if kind == 'node' else edge_h
                args = (h, a2nei, b2a, graph, mask, training,
                        seed + 10 * (2 * i + (kind == 'edge')))
                if mode in ('both', 'block') and grad:
                    h = checkpoint(block, *args, use_reentrant=False)
                else:
                    h = block(*args)
                if kind == 'node':
                    node_h = h
                else:
                    edge_h = h

        if self.packed:
            sums = {
                'atom_from_atom': lambda: p_agg(node_h, a2a),
                'atom_from_bond': lambda: p_agg(edge_h, a2b),
                'bond_from_atom': lambda: p_agg(
                    node_h + p_agg(node_h, a2a), b2a)
                - p_agg(node_h, a2b.transpose(1, 2)),
                'bond_from_bond': lambda: p_agg(p_agg(edge_h, a2b), b2a)
                - p_rev(edge_h)}
        else:
            g = graph
            sums = {
                'atom_from_atom': lambda: nei_sum_sym(node_h, g.a2a),
                'atom_from_bond': lambda: nei_sum_bonds(edge_h, g.a2b,
                                                        g.rev_dst),
                'bond_from_atom': lambda: slot_sum(node_h, g.alfb,
                                                   *g.alfb_csr)
                - gather_rows(node_h, g.rev_dst, *g.dst_csr),
                'bond_from_bond': lambda: slot_sum(edge_h, g.blfb,
                                                   *g.blfb_csr)
                - gather_rows(edge_h, g.b2revb, *g.revb_csr)}
        out = []
        for j, name in enumerate(_OUTPUTS[:outputs]):
            atoms = name.startswith('atom')
            feats = f_atoms if atoms else f_bonds
            y = getattr(self, f'ffn_{name}')(
                torch.cat([feats, sums[name]()], 1), training,
                seed + 100 + j)
            y = _Dropout(self.dropout, training, seed + 200 + j)(
                getattr(self, f'{name}_norm')(y))
            out.append(y * (nmask if atoms else emask)[:, None])
        return tuple(out)


class _GroverModule(nn.Module):
    """What the pretraining and finetuning modules share: the encoder, the
    flat batch's index tensors, the dropout seeds of a step."""

    def _encode(self, f_atoms, f_bonds, a2b, b2a, b2revb, a2a, nmask,
                emask, csr, outputs: int = 4):
        graph = None
        if not self.packed:
            if len(csr) != N_FLAT_CSR:
                raise ValueError(f'a flat GROVER batch carries '
                                 f'{N_FLAT_CSR} CSR arrays after its ten, '
                                 f'got {len(csr)}')
            graph = FlatGraph(a2b, b2a, b2revb, a2a, csr,
                              3 * self.encoder.num_heads)
        seed = 0
        if self.training and self.dropout > 0:
            if self._generator is None:
                self._generator = torch.Generator().manual_seed(
                    self.dropout_seed)
            seed = int(torch.randint(0, 2 ** 62, (1,),
                                     generator=self._generator))
        emb = self.encoder(f_atoms, f_bonds, a2b, b2a, b2revb, a2a, nmask,
                           emask, graph, self.training, seed, outputs)
        return emb, graph, seed

    def _readout(self, x, mask, graph: Optional[FlatGraph], edges: bool,
                 graphs: int, counts=None):
        if self.packed:
            return p_mean_readout(x, mask, graphs), None
        return _flat_mean_readout(
            x, mask, graph.edge_ptr if edges else graph.node_ptr, counts)


class _GroverPretrainModule(_GroverModule):
    """The encoder and the pretraining heads: atom-vocabulary log-softmax
    from ``atom_from_atom`` (``av_head_atom``) and ``atom_from_bond``
    (``av_head_bond``), bond-vocabulary log-softmax of each bond's and
    its reverse's linear maps (``bv_head_*_fwd``, ``_rev``), and
    functional-group logits of each embedding's mean readout
    (``fg_head_<name>``)."""

    def __init__(self, hidden: int, node_fdim: int, edge_fdim: int,
                 depth: int, num_mt_block: int, num_heads: int,
                 dropout: float, atom_vocab_size: int, bond_vocab_size: int,
                 n_fg: int, num_graphs: int, packed: bool = False,
                 remat: str = 'auto',
                 generator: Optional[torch.Generator] = None,
                 dropout_seed: int = 0):
        super().__init__()
        self.packed, self.num_graphs, self.dropout = packed, num_graphs, \
            dropout
        self.node_features, self.edge_features = node_fdim, edge_fdim
        self.dropout_seed, self._generator = dropout_seed, None
        self.encoder = GroverTransEncoder(
            hidden, node_fdim, edge_fdim, depth, num_mt_block, num_heads,
            dropout, packed=packed, remat=remat, generator=generator)
        H = hidden
        self.av_head_atom = dense(H, atom_vocab_size, generator)
        self.av_head_bond = dense(H, atom_vocab_size, generator)
        for name in ('bv_head_atom', 'bv_head_bond'):
            setattr(self, f'{name}_fwd', dense(H, bond_vocab_size, generator))
            setattr(self, f'{name}_rev', dense(H, bond_vocab_size, generator))
        for name in _OUTPUTS:
            setattr(self, f'fg_head_{name}', dense(H, n_fg, generator))

    def forward(self, f_atoms, f_bonds, a2b, b2a, b2revb, a2a, gidx, nmask,
                emask, addf, *csr):
        emb, graph, _ = self._encode(f_atoms, f_bonds, a2b, b2a, b2revb,
                                     a2a, nmask, emask, csr)
        aa, ab, ba, bb = emb
        av_atom = torch.log_softmax(self.av_head_atom(aa), dim=-1)
        av_bond = torch.log_softmax(self.av_head_bond(ab), dim=-1)

        def bond_vocab(e, name):
            rev = p_rev(e) if self.packed \
                else gather_rows(e, graph.b2revb, *graph.revb_csr)
            return torch.log_softmax(getattr(self, f'{name}_fwd')(e)
                                     + getattr(self, f'{name}_rev')(rev),
                                     dim=-1)
        bv_atom = bond_vocab(ba, 'bv_head_atom')
        bv_bond = bond_vocab(bb, 'bv_head_bond')
        fg, counts = [], {}
        for name, x in zip(_OUTPUTS, emb):
            edges = name.startswith('bond')
            g, counts[edges] = self._readout(
                x, emask if edges else nmask, graph, edges, addf.shape[0],
                counts.get(edges))
            fg.append(getattr(self, f'fg_head_{name}')(g))
        return (av_atom, av_bond, bv_atom, bv_bond, *fg)


class _GroverFinetuneModule(_GroverModule):
    """The encoder, mean readouts of ``atom_from_atom`` and
    ``atom_from_bond`` with the molecule features, a dense layer each
    (``mol_atom_from_atom_ffn``, ``mol_atom_from_bond_ffn``) and one
    shared head (``output_head``): each branch's prediction and the head
    of the branches' mean (of their sigmoids for a classifier).  A
    classifier returns ``(probs, logits, la, lb)``, a regressor ``(y, ya,
    yb)``."""

    def __init__(self, hidden: int, node_fdim: int, edge_fdim: int,
                 depth: int, num_mt_block: int, num_heads: int,
                 dropout: float, mode: str, n_tasks: int, n_classes: int,
                 num_graphs: int, ffn_hidden: int = 128, features_dim: int = 0,
                 packed: bool = False, remat: str = 'auto',
                 generator: Optional[torch.Generator] = None,
                 dropout_seed: int = 0):
        super().__init__()
        self.packed, self.num_graphs, self.dropout = packed, num_graphs, \
            dropout
        self.node_features, self.edge_features = node_fdim, edge_fdim
        self.mode, self.n_tasks, self.n_classes = mode, n_tasks, n_classes
        self.dropout_seed, self._generator = dropout_seed, None
        self.encoder = GroverTransEncoder(
            hidden, node_fdim, edge_fdim, depth, num_mt_block, num_heads,
            dropout, packed=packed, remat=remat, generator=generator)
        width = hidden + max(features_dim, 1)
        self.mol_atom_from_atom_ffn = dense(width, ffn_hidden, generator)
        self.mol_atom_from_bond_ffn = dense(width, ffn_hidden, generator)
        out_dim = n_tasks * n_classes if mode == 'classification' \
            else n_tasks
        self.output_head = dense(ffn_hidden, out_dim, generator)

    def forward(self, f_atoms, f_bonds, a2b, b2a, b2revb, a2a, gidx, nmask,
                emask, addf, *csr):
        emb, graph, seed = self._encode(f_atoms, f_bonds, a2b, b2a, b2revb,
                                        a2a, nmask, emask, csr, outputs=2)
        B = addf.shape[0]
        g_atom, counts = self._readout(emb[0], nmask, graph, False, B)
        g_bond, _ = self._readout(emb[1], nmask, graph, False, B, counts)
        drop = _Dropout(self.dropout, self.training, seed + 300)
        h_atom = self.mol_atom_from_atom_ffn(drop(torch.cat([g_atom, addf],
                                                            1)))
        h_bond = self.mol_atom_from_bond_ffn(drop(torch.cat([g_bond, addf],
                                                            1)))
        la, lb = self.output_head(h_atom), self.output_head(h_bond)
        if self.mode == 'classification':
            combined = self.output_head((torch.sigmoid(h_atom)
                                         + torch.sigmoid(h_bond)) / 2)
            shape = (-1, self.n_tasks, self.n_classes)
            logits = combined.reshape(shape)
            return (torch.softmax(logits, dim=-1), logits, la.reshape(shape),
                    lb.reshape(shape))
        return self.output_head((h_atom + h_bond) / 2), la, lb


# ------------------------------------------------------------------- model

def _pretrain_loss(dist: float):
    """The pretraining loss: masked NLL of both atom-vocabulary and both
    bond-vocabulary heads, binary cross entropy of the four
    functional-group heads, and ``dist`` times the branches'
    disagreement (mean squared differences of the vocabulary
    log-probabilities and of the functional-group sigmoids)."""
    def loss_fn(outputs, labels, weights):
        av_a, av_b, bv_a, bv_b, fg_aa, fg_ab, fg_ba, fg_bb = outputs
        av_lab, bv_lab, fg_lab, nmask, emask = labels

        def masked_nll(logp, lab, mask):
            nll = -torch.gather(logp, 1, lab.long()[:, None])[:, 0]
            return torch.sum(nll * mask) / torch.clamp_min(mask.sum(), 1.0)

        def bce(logits, lab):
            return torch.mean(_maximum(logits, 0.0) - logits * lab
                              + torch.log1p(torch.exp(-_abs(logits))))

        def mmse(a, b, mask):
            d = torch.mean((a - b) ** 2, dim=-1)
            return torch.sum(d * mask) / torch.clamp_min(mask.sum(), 1.0)
        la = masked_nll(av_a, av_lab, nmask) + masked_nll(av_b, av_lab, nmask)
        lb = masked_nll(bv_a, bv_lab, emask) + masked_nll(bv_b, bv_lab, emask)
        lf = bce(fg_aa, fg_lab) + bce(fg_ab, fg_lab) + bce(fg_ba, fg_lab) \
            + bce(fg_bb, fg_lab)
        ld = mmse(av_a, av_b, nmask) + mmse(bv_a, bv_b, emask) \
            + torch.mean((torch.sigmoid(fg_aa) - torch.sigmoid(fg_ab)) ** 2) \
            + torch.mean((torch.sigmoid(fg_ba) - torch.sigmoid(fg_bb)) ** 2)
        return la + lb + lf + dist * ld
    return loss_fn


def _finetune_loss(mode: str, dist: float):
    """Each branch's loss, weighted, plus ``dist`` times the mean squared
    difference of the two branches' outputs."""
    base, _ = _gnn_loss_outputs(mode)

    def weighted(losses, weights):
        w = weights[0] if weights else losses.new_ones(())
        if w.ndim < losses.ndim:
            w = w.reshape(w.shape + (1,) * (losses.ndim - w.ndim))
        elif w.ndim > losses.ndim:
            w = w.mean(dim=tuple(range(losses.ndim, w.ndim)))
        return torch.sum(losses * w) / torch.clamp_min(
            torch.broadcast_to(w, losses.shape).sum(), 1e-8)

    def loss_fn(outputs, labels, weights):
        a, b = outputs[-2], outputs[-1]
        return weighted(base(a, labels[0]), weights) \
            + weighted(base(b, labels[0]), weights) \
            + dist * torch.mean((a - b) ** 2)
    return loss_fn


class GroverModel(ModularModel, GraphModel):
    """GROVER for pretraining (``task='pretraining'``, with the atom and
    bond vocabularies) or finetuning (``task='finetuning'``, regression or
    classification), over :class:`GroverFeaturizer` graphs, in the packed
    layout (``packed=True``) or the flat one.

    A batch's inputs are the JAX package's ten arrays: ``f_atoms``,
    ``f_bonds`` (the source atom's features and the bond's), ``a2b``,
    ``b2a``, ``b2revb``, ``a2a``, ``gidx``, ``nmask``, ``emask``,
    ``addf``; packed, ``a2b`` is the ``[B, A, E]`` incoming-bond incidence,
    ``b2a`` the ``[B, E, A]`` source one-hot and ``a2a`` the ``[B, A, A]``
    adjacency.  A flat batch then carries :func:`flat_csr`'s twelve
    arrays.  The flat packer keeps at most ``max_neighbors`` incoming
    bonds an atom, as the JAX package's does.

    The module is built at construction from a generator seeded with
    ``seed`` (which also seeds dropout); load flax parameters with
    :func:`grover_params_from_flax`.  Components ``encoder`` and
    ``heads`` transfer between models (``save_components``,
    ``load_components``), across layouts too.
    """

    uses_edge_features = True
    component_scopes = {'encoder': ['encoder'],
                        'heads': ['head', 'ffn_out', 'mol_atom_from']}
    max_neighbors = 8
    mol_node_quantum = 8
    mol_edge_quantum = 16

    def __init__(self, node_fdim: int = 75, edge_fdim: int = 6,
                 hidden_size: int = 64, depth: int = 2,
                 num_mt_block: int = 1, num_heads: int = 4,
                 dropout: float = 0.0, ffn_hidden_size: int = 128,
                 task: str = 'finetuning', mode: str = 'regression',
                 n_tasks: int = 1, n_classes: int = 2, features_dim: int = 0,
                 atom_vocab: Optional[GroverAtomVocabularyBuilder] = None,
                 bond_vocab: Optional[GroverBondVocabularyBuilder] = None,
                 batch_size: int = 32, dist_coff: float = 0.1,
                 num_layers: Optional[int] = None, packed: bool = True,
                 remat: str = 'auto', seed: int = 0, **kwargs):
        self.packed = packed
        self.n_tasks, self.n_classes = n_tasks, n_classes
        self.task, self.mode = task, mode
        self.atom_vocab, self.bond_vocab = atom_vocab, bond_vocab
        self.node_fdim, self.edge_fdim = node_fdim, edge_fdim
        self.features_dim, self.dist_coff = features_dim, dist_coff
        if num_layers is not None:
            num_mt_block = num_layers
        common = dict(hidden=hidden_size, node_fdim=node_fdim,
                      edge_fdim=edge_fdim, depth=depth,
                      num_mt_block=num_mt_block, num_heads=num_heads,
                      dropout=dropout, num_graphs=batch_size, packed=packed,
                      remat=remat, dropout_seed=seed)
        if task in ('pretraining', 'pretrain'):
            def module(generator):
                return _GroverPretrainModule(
                    atom_vocab_size=atom_vocab.size if atom_vocab else 1,
                    bond_vocab_size=bond_vocab.size if bond_vocab else 1,
                    n_fg=len(_FG_CHECKS), generator=generator, **common)
            loss = _pretrain_loss(dist_coff)
            output_types = ['embedding'] * 8
        else:
            def module(generator):
                return _GroverFinetuneModule(
                    mode=mode, n_tasks=n_tasks, n_classes=n_classes,
                    ffn_hidden=ffn_hidden_size, features_dim=features_dim,
                    generator=generator, **common)
            loss = _finetune_loss(mode, dist_coff)
            output_types = ['prediction', 'loss', 'embedding', 'embedding'] \
                if mode == 'classification' \
                else ['prediction', 'embedding', 'embedding']
        super().__init__(module, loss, output_types=output_types,
                         batch_size=batch_size, seed=seed, **kwargs)

    @property
    def pretraining(self) -> bool:
        return self.task in ('pretraining', 'pretrain')

    def build(self, sample_inputs: Sequence[torch.Tensor]) -> None:
        """Checks the batch's atom and bond feature widths."""
        got = (sample_inputs[0].shape[-1], sample_inputs[1].shape[-1])
        want = (self.node_fdim, self.node_fdim + self.edge_fdim)
        if got != want:
            raise ValueError(f'batch has {got[0]} atom and {got[1]} bond '
                             f'features; the model was built for '
                             f'{want[0]} and {want[1]}')
        TorchModel.build(self, sample_inputs)

    def _batch_layout(self) -> Tuple:
        return (self.packed,)

    def get_loss_func(self):
        """The loss callable: ``f(outputs, labels, weights)``."""
        return self._loss

    @staticmethod
    def atom_vocab_random_mask(atom_vocab, smiles, percent: float = 0.15,
                               seed: Optional[int] = None) -> List[int]:
        """Per-atom labels over ``smiles``: ``ceil(n * percent)`` atoms of
        each molecule, drawn by ``RandomState(seed).permutation``, carry
        their vocabulary id, the rest 0."""
        rng = np.random.RandomState(seed)
        labels: List[int] = []
        for smi in smiles:
            mol = mol_from_smiles(str(smi))
            n = mol.num_atoms
            mlabel = [0] * n
            for p in rng.permutation(n)[:int(np.ceil(n * percent))]:
                mlabel[int(p)] = atom_vocab.stoi.get(
                    type(atom_vocab).atom_to_vocab(mol, mol.atoms[int(p)]),
                    0)
            labels.extend(mlabel)
        return labels

    @staticmethod
    def bond_vocab_random_mask(bond_vocab, smiles, percent: float = 0.15,
                               seed: Optional[int] = None) -> List[int]:
        """Per-bond labels: ``max(1, ceil(n * percent))`` bonds of a
        molecule with ``n`` bonds carry their vocabulary id, the rest
        0."""
        rng = np.random.RandomState(seed)
        labels: List[int] = []
        for smi in smiles:
            mol = mol_from_smiles(str(smi))
            bonds = list(mol.bonds)
            n = len(bonds)
            mlabel = [0] * n
            n_mask = max(1, int(np.ceil(n * percent))) if n else 0
            for p in rng.permutation(n)[:n_mask]:
                mlabel[int(p)] = bond_vocab.stoi.get(
                    type(bond_vocab).bond_to_vocab(mol, bonds[int(p)]), 0)
            labels.extend(mlabel)
        return labels

    # -- batch assembly -----------------------------------------------------
    def _graph_inputs(self, X_b, graphs: Optional[int] = None
                      ) -> List[np.ndarray]:
        """The batch's arrays; packed, with ``graphs`` molecule blocks
        (default ``batch_size``)."""
        if self.packed:
            return self._graph_inputs_packed(X_b, graphs)
        return self._graph_inputs_flat(X_b)

    def _packed_caps(self, max_nodes: int, max_edges: int
                     ) -> Tuple[int, int]:
        """Per-molecule (atom, directed-bond) caps rounded to quanta; the
        bond cap stays even for the pair flip."""
        return bucket_caps(max(max_nodes, 1), max(max_edges, 1),
                           self.mol_node_quantum, self.mol_edge_quantum)

    def _graph_inputs_packed(self, X_b, blocks: Optional[int] = None
                             ) -> List[np.ndarray]:
        graphs = list(X_b)
        B = blocks or self.batch_size
        if self._fixed_caps is not None:
            A, E = self._fixed_caps
        else:
            A, E = self._packed_caps(
                max((g.num_nodes for g in graphs), default=1),
                max((g.num_edges for g in graphs), default=0))
        nf, ef = self.node_fdim, self.edge_fdim
        f_atoms = np.zeros((B * A, nf), np.float32)
        f_bonds = np.zeros((B * E, nf + ef), np.float32)
        adj = np.zeros((B, A, A), np.float32)
        inc = np.zeros((B, A, E), np.float32)
        src_oh = np.zeros((B, E, A), np.float32)
        gidx = np.repeat(np.arange(B, dtype=np.int32), A)
        nmask = np.zeros(B * A, np.float32)
        emask = np.zeros(B * E, np.float32)
        addf = np.zeros((B, max(self.features_dim, 1)), np.float32)
        for i, g in enumerate(graphs):
            n, e = g.num_nodes, g.num_edges
            f_atoms[i * A:i * A + n] = g.node_features[:, :nf]
            nmask[i * A:i * A + n] = 1.0
            if e:
                s, d = g.edge_index[0], g.edge_index[1]
                f_bonds[i * E:i * E + e, :nf] = g.node_features[s, :nf]
                if g.edge_features is not None:
                    f_bonds[i * E:i * E + e, nf:] = g.edge_features[:, :ef]
                adj[i, d, s] = 1.0
                inc[i, d, np.arange(e)] = 1.0
                src_oh[i, np.arange(e), s] = 1.0
                emask[i * E:i * E + e] = 1.0
            self._add_features(addf, i, g)
        # b2revb is unused when packed: bonds are (forward, reverse) pairs
        return [f_atoms, f_bonds, inc, src_oh, np.zeros(1, np.int32), adj,
                gidx, nmask, emask, addf]

    def _add_features(self, addf: np.ndarray, i: int, g) -> None:
        af = getattr(g, 'additional_features', None)
        if af is not None and self.features_dim:
            addf[i, :len(af)] = af[:self.features_dim]

    def _graph_inputs_flat(self, X_b) -> List[np.ndarray]:
        graphs = list(X_b)
        if self._fixed_caps is not None:
            node_cap, edge_cap = self._fixed_caps
        else:
            node_cap, edge_cap = bucket_caps(
                sum(g.num_nodes for g in graphs) + 1,
                sum(g.num_edges for g in graphs) + 1,
                self.node_quantum, self.edge_quantum)
        K = self.max_neighbors
        nf, ef = self.node_fdim, self.edge_fdim
        f_atoms = np.zeros((node_cap, nf), np.float32)
        f_bonds = np.zeros((edge_cap, nf + ef), np.float32)
        a2b = np.zeros((node_cap, K), np.int32)
        b2a = np.zeros(edge_cap, np.int32)
        b2revb = np.zeros(edge_cap, np.int32)
        gidx = np.zeros(node_cap, np.int32)
        nmask = np.zeros(node_cap, np.float32)
        emask = np.zeros(edge_cap, np.float32)
        addf = np.zeros((self.batch_size, max(self.features_dim, 1)),
                        np.float32)
        counts = np.zeros(node_cap, np.int32)
        na, ne = 1, 1                                   # row 0: the ghost
        for i, g in enumerate(graphs):
            n, e = g.num_nodes, g.num_edges
            f_atoms[na:na + n] = g.node_features[:, :nf]
            gidx[na:na + n] = i
            nmask[na:na + n] = 1.0
            if e:
                src = g.edge_index[0] + na
                dst = g.edge_index[1] + na
                f_bonds[ne:ne + e, :nf] = f_atoms[src]
                if g.edge_features is not None:
                    f_bonds[ne:ne + e, nf:] = g.edge_features[:, :ef]
                b2a[ne:ne + e] = src
                b2revb[ne:ne + e] = (np.arange(e) ^ 1) + ne
                emask[ne:ne + e] = 1.0
                # incoming bonds past max_neighbors are dropped
                for j, a in enumerate(dst):
                    if counts[a] < K:
                        a2b[a, counts[a]] = ne + j
                        counts[a] += 1
            self._add_features(addf, i, g)
            na += n
            ne += e
        a2a = b2a[a2b]
        return [f_atoms, f_bonds, a2b, b2a, b2revb, a2a, gidx, nmask, emask,
                addf] + flat_csr(a2b, b2a, b2revb, a2a, gidx, nmask, emask,
                                 self.batch_size)

    def _collect_uniform_batches(self, dataset: NumpyDataset,
                                 deterministic: bool = True,
                                 mode: str = 'fit') -> List:
        """One epoch of host batches padded to one cap: per molecule in
        the packed layout, per batch in the flat one."""
        max_nodes = max_edges = 1
        for (X_b, _, _, _) in dataset.iterbatches(
                batch_size=self.batch_size, deterministic=True,
                pad_batches=False):
            if self.packed:
                max_nodes = max(max_nodes, max(g.num_nodes for g in X_b))
                max_edges = max(max_edges, max(g.num_edges for g in X_b))
            else:
                max_nodes = max(max_nodes,
                                sum(g.num_nodes for g in X_b) + 1)
                max_edges = max(max_edges,
                                sum(g.num_edges for g in X_b) + 1)
        self._fixed_caps = self._packed_caps(max_nodes, max_edges) \
            if self.packed else bucket_caps(max_nodes, max_edges,
                                            self.node_quantum,
                                            self.edge_quantum)
        try:
            return list(self.default_generator(
                dataset, epochs=1, mode=mode, deterministic=deterministic,
                pad_batches=True))
        finally:
            self._fixed_caps = None

    def default_generator(self, dataset: NumpyDataset, epochs: int = 1,
                          mode: str = 'fit', deterministic: bool = True,
                          pad_batches: bool = True):
        """Finetuning: the inputs, the labels (one-hot for a classifier in
        ``mode='fit'``) and weights, both padded with zeros to
        ``batch_size``.  Pretraining: the labels are each atom's and each
        bond's vocabulary id, each molecule's functional groups and the
        atom and bond masks, the weight a single 1.  Outside ``fit`` and
        uniform batches a packed batch has a block a molecule it holds, not
        ``batch_size`` (the JAX package pads every batch to
        ``batch_size``; a molecule's answers do not depend on it)."""
        for _ in range(epochs):
            for (X_b, y_b, w_b, _) in dataset.iterbatches(
                    batch_size=self.batch_size,
                    deterministic=deterministic, pad_batches=False):
                blocks = len(X_b) if self.packed and mode != 'fit' \
                    and self._fixed_caps is None else None
                inputs = self._graph_inputs(X_b, blocks)
                if not self.pretraining:
                    n = len(X_b)
                    if y_b is not None and self.mode == 'classification' \
                            and mode == 'fit':
                        y_b = np.stack([to_one_hot(y_b[:, t], self.n_classes)
                                        for t in range(self.n_tasks)], axis=1)
                    if y_b is not None and n < self.batch_size:
                        pad = self.batch_size - n
                        y_b = np.concatenate([y_b, np.zeros(
                            (pad,) + y_b.shape[1:], y_b.dtype)])
                        if w_b is not None:
                            w_b = np.concatenate([w_b, np.zeros(
                                (pad,) + w_b.shape[1:], w_b.dtype)])
                    yield (inputs, [y_b], [w_b])
                    continue
                yield (inputs, self._pretrain_labels(X_b, inputs),
                       [np.ones(1, np.float32)])

    def _pretrain_labels(self, X_b, inputs) -> List[np.ndarray]:
        node_cap, edge_cap = inputs[0].shape[0], inputs[1].shape[0]
        B = inputs[-1].shape[0] if self.packed else self.batch_size
        av = np.zeros(node_cap, dtype=np.int32)
        bv = np.zeros(edge_cap, dtype=np.int32)
        fg = np.zeros((B, len(_FG_CHECKS)), dtype=np.float32)
        A, E = node_cap // B, edge_cap // B
        pos_n, pos_e = 1, 1
        for i, g in enumerate(X_b):
            n, e = g.num_nodes, g.num_edges
            if self.packed:                 # each molecule's slot base
                pos_n, pos_e = i * A, i * E
            if getattr(g, 'atom_vocab_label', None) is not None:
                av[pos_n:pos_n + n] = g.atom_vocab_label
            if getattr(g, 'bond_vocab_label', None) is not None:
                bv[pos_e:pos_e + e] = g.bond_vocab_label
            if getattr(g, 'fg_label', None) is not None:
                fg[i] = g.fg_label
            if not self.packed:
                pos_n += n
                pos_e += e
        return [av, bv, fg, inputs[7], inputs[8]]

