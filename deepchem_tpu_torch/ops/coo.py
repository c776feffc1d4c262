"""Message passing over the padded COO edge list, on P1, P2 and K3.

Counterparts of ``deepchem_tpu/ops/segment.py``'s ``gather_neighbors_sum``
and ``gather_neighbors_max``, of its ``segment_sum``,
``segment_max_sumgrad`` and ``segment_softmax`` over edge destinations,
and of ``jnp.take`` of node rows by an edge end, as the JAX package's COO
branches call them.  The JAX package scatters by ``edge_dst``; here each
batch carries the CSR of its edges by destination and by source
(:func:`coo_csr`, built when the batch is packed), so every sum is
:func:`fused_gather_segment_sum` (P2) over CSR ranges, every max K3
(:func:`graph_max_pool`) over the rows in destination order, every
softmax P1 (:func:`segment_softmax_sorted`) over the logits in destination
order, and every backward a P2 over the other CSR, K3's or P1's backward
or a gather: no scatter with float atomics.  The edge arrays keep their
order.

Layout: ghost edges (mask 0) run from the last node into the last node,
after every real edge, and no real edge touches the last node (the batch
layout's ghost node).  A stable sort puts the ghost edges at the end of
both orders, so the last node's range in either CSR holds exactly the
ghost edges.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from deepchem_tpu_torch.ops import csr_segment
from deepchem_tpu_torch.ops.csr_segment import edges_to_csr
from deepchem_tpu_torch.ops.segment import (graph_max_pool,
                                            segment_softmax_sorted)


class CooCsr(NamedTuple):
    """The CSR arrays of a batch's edges (``[E]`` or ``[N+1]`` int32).

    ``src_by_dst``: each edge's source, edges in stable destination order;
    ``row_ptr_dst``: node ``i``'s incoming edges are positions
    ``row_ptr_dst[i]:row_ptr_dst[i+1]`` of that order; ``dst_by_src`` and
    ``row_ptr_src`` the same by source; ``perm_dst``: the edge ids in
    destination order; ``inv_dst``: each edge's position in it;
    ``perm_src``: the edge ids in source order."""
    src_by_dst: torch.Tensor
    row_ptr_dst: torch.Tensor
    dst_by_src: torch.Tensor
    row_ptr_src: torch.Tensor
    perm_dst: torch.Tensor
    inv_dst: torch.Tensor
    perm_src: torch.Tensor


#: arrays of a :class:`CooCsr` in a packed batch
N_CSR = len(CooCsr._fields)


def coo_csr(edge_src: np.ndarray, edge_dst: np.ndarray,
            num_nodes: int) -> List[np.ndarray]:
    """Host-side: the :class:`CooCsr` arrays of an edge list, as numpy int32
    arrays in its field order; both orders from a stable ``argsort``, so
    edges of one node keep their order in the list."""
    edge_src = np.asarray(edge_src)
    edge_dst = np.asarray(edge_dst)
    perm_dst, row_ptr_dst = edges_to_csr(edge_dst, num_nodes)
    perm_src, row_ptr_src = edges_to_csr(edge_src, num_nodes)
    inv_dst = np.empty_like(perm_dst)
    inv_dst[perm_dst] = np.arange(len(perm_dst), dtype=np.int32)
    return [edge_src[perm_dst].astype(np.int32), row_ptr_dst,
            edge_dst[perm_src].astype(np.int32), row_ptr_src, perm_dst,
            inv_dst, perm_src]


def _check_layout(edge_src, edge_dst, edge_mask, num_nodes) -> None:
    """On the CPU, raise unless the masked edges are the layout's ghost
    edges (on the card the check would wait for the device; the packer
    makes the layout)."""
    if edge_mask is None or edge_mask.device.type != 'cpu':
        return
    ghost = edge_mask == 0
    last = num_nodes - 1
    ends = (edge_src == last) | (edge_dst == last)
    if bool((ghost != ends).any()) or bool((edge_src[ghost] != last).any()) \
            or bool((edge_dst[ghost] != last).any()):
        raise ValueError('masked edges must be the ghost edges, from and '
                         'into the last node, and no real edge may touch '
                         'it')


def _real_ranges(row_ptr: torch.Tensor, masked: bool):
    """``row_ptr`` with the last node's range (the ghost edges) emptied, and
    whether that range held an edge (``[1]`` bool); unchanged, and no
    ghost, when nothing is masked."""
    if not masked:
        return row_ptr, None
    last = row_ptr[-2:-1]
    return torch.cat([row_ptr[:-1], last]), row_ptr[-1:] > last


def _add_ghost_term(out: torch.Tensor, rows: torch.Tensor,
                    ghost: Optional[torch.Tensor]) -> torch.Tensor:
    """``out[-1] += Σ over the ghost edges of rows[-1] * 0``, in place: +0,
    or NaN where ``rows[-1]`` is not finite, as the JAX package's masked
    sum gives it."""
    if ghost is not None and out.shape[0]:
        out[-1] += torch.where(ghost, rows[-1] * 0.0,
                               torch.zeros_like(rows[-1]))
    return out


class _GatherNeighborsSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, masked, src_by_dst, row_ptr_dst, dst_by_src,
                row_ptr_src):
        ctx.masked = masked
        ctx.save_for_backward(dst_by_src, row_ptr_src)
        rp, ghost = _real_ranges(row_ptr_dst, masked)
        out = csr_segment._gather_sum_forward(x.contiguous(), src_by_dst, rp)
        return _add_ghost_term(out, x, ghost)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        dst_by_src, row_ptr_src = ctx.saved_tensors
        rp, ghost = _real_ranges(row_ptr_src, ctx.masked)
        g = g.contiguous()
        dx = csr_segment._gather_sum_forward(g, dst_by_src, rp,
                                            'backward_launches')
        return (_add_ghost_term(dx, g, ghost),) + (None,) * 5


def gather_neighbors_sum(node_feats: torch.Tensor, edge_src: torch.Tensor,
                         edge_dst: torch.Tensor,
                         edge_mask: Optional[torch.Tensor],
                         csr: CooCsr) -> torch.Tensor:
    """``sum_{j in N(i)} h_j`` for every node ``i`` over the edges whose
    mask is set: the JAX package's ``take`` of the sources times the mask,
    then ``segment_sum`` by destination, with its results on every row
    (a ghost edge adds ``h[last] * 0``: +0, or NaN where ``h[last]`` is not
    finite) and its order of the adds on the CPU.

    The forward is P2 over ``csr.row_ptr_dst``'s real ranges, the
    gradient P2 over ``csr.row_ptr_src``'s gathering ``g[dst]`` (counted
    in ``fused_gather_segment_sum.backward_launches``); the ghost edges'
    term is added to the last row.  ``csr`` is the batch's
    :class:`CooCsr`."""
    _check_layout(edge_src, edge_dst, edge_mask, node_feats.shape[0])
    c = CooCsr(*csr)
    return _GatherNeighborsSum.apply(node_feats, edge_mask is not None,
                                     c.src_by_dst, c.row_ptr_dst,
                                     c.dst_by_src, c.row_ptr_src)


def coo_degrees(csr: CooCsr, masked: bool = True) -> torch.Tensor:
    """Incoming edges per node (int32) from ``csr.row_ptr_dst``, the ghost
    edges not counted where ``masked``: ``node_degrees(edge_dst, N,
    edge_mask)`` of the batch layout, with no scatter."""
    rp, _ = _real_ranges(CooCsr(*csr).row_ptr_dst, masked)
    return (rp[1:] - rp[:-1]).to(torch.int32)


def _rows2d(x: torch.Tensor) -> torch.Tensor:
    """``x`` as ``[rows, features]``, contiguous, for P2."""
    return x.reshape(x.shape[0], -1).contiguous()


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ends, order, row_ptr):
        ctx.save_for_backward(order, row_ptr)
        ctx.shape = x.shape
        return x.index_select(0, ends.long())

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        order, row_ptr = ctx.saved_tensors
        dx = csr_segment._gather_sum_forward(_rows2d(g), order, row_ptr,
                                            'backward_launches')
        return dx.reshape(ctx.shape), None, None, None


def gather_rows(x: torch.Tensor, index: torch.Tensor, order: torch.Tensor,
                row_ptr: torch.Tensor) -> torch.Tensor:
    """``x[index]`` for any ``index`` ``[E]`` into the rows of ``x``, with
    the CSR of ``index`` by value: ``order`` ``[E]`` the positions in a
    stable sort by value, ``row_ptr`` ``[len(x) + 1]`` (``edges_to_csr``
    of ``index``).  The gradient ``dx[n] = Σ_{index[p] = n} g[p]`` is P2
    over that CSR, counted in
    ``fused_gather_segment_sum.backward_launches``: a row that many
    positions name (a ghost row) still sums in a fixed order."""
    return _GatherRows.apply(x, index, order, row_ptr)


def gather_src(x: torch.Tensor, edge_src: torch.Tensor,
               csr: CooCsr) -> torch.Tensor:
    """``x[edge_src]``: each edge's source row (``jnp.take(x, edge_src)``),
    every edge, ghost ones too.  The gradient ``dx[n] = Σ_{src(e) = n}
    g[e]`` is P2 over ``csr.row_ptr_src`` reading the edge rows in source
    order (``csr.perm_src``), counted in
    ``fused_gather_segment_sum.backward_launches``: no ``index_add_``."""
    c = CooCsr(*csr)
    return _GatherRows.apply(x, edge_src, c.perm_src, c.row_ptr_src)


def gather_dst(x: torch.Tensor, edge_dst: torch.Tensor,
               csr: CooCsr) -> torch.Tensor:
    """``x[edge_dst]``, as :func:`gather_src` by destination: the gradient
    is P2 over ``csr.row_ptr_dst`` reading the edge rows by
    ``csr.perm_dst``."""
    c = CooCsr(*csr)
    return _GatherRows.apply(x, edge_dst, c.perm_dst, c.row_ptr_dst)


class _DstSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, edge_dst, perm_dst, row_ptr_dst):
        ctx.save_for_backward(edge_dst)
        ctx.shape = data.shape
        out = csr_segment._gather_sum_forward(_rows2d(data), perm_dst,
                                             row_ptr_dst)
        return out.reshape((out.shape[0],) + tuple(data.shape[1:]))

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        edge_dst, = ctx.saved_tensors
        return g.index_select(0, edge_dst.long()), None, None, None


def dst_segment_sum(data: torch.Tensor, edge_dst: torch.Tensor,
                    csr: CooCsr) -> torch.Tensor:
    """``segment_sum(data, edge_dst, N)`` for edge rows ``data`` ``[E,
    ...]``: P2 over ``csr.row_ptr_dst`` reading the rows in destination
    order (``csr.perm_dst``), so no permuted copy is written; the gradient
    is the gather ``g[edge_dst]``, as in JAX.  Every edge counts, ghost
    ones too: callers multiply by the mask first, as the JAX package
    does."""
    c = CooCsr(*csr)
    return _DstSegmentSum.apply(data, edge_dst, c.perm_dst, c.row_ptr_dst)


def graph_edge_row_ptr(csr: CooCsr,
                       graph_row_ptr: torch.Tensor) -> torch.Tensor:
    """The row pointer by graph over the real edges in destination order:
    graph ``g``'s edges (those into its nodes) are positions
    ``rp[g]:rp[g+1]`` of ``csr.perm_dst``'s order, ``graph_row_ptr`` being
    the graphs' row pointer over the nodes (:func:`csr_row_ptr` of the
    graph index), so ``rp[1:] - rp[:-1]`` counts each graph's edges with
    no scatter.  Edges in destination order are grouped by graph because
    the nodes are; the ghost edges (the last node's range) are left
    out."""
    rp, _ = _real_ranges(CooCsr(*csr).row_ptr_dst, True)
    return rp.index_select(0, graph_row_ptr.long())


class _PermuteRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, inv):
        ctx.save_for_backward(inv)
        return x.index_select(0, perm.long())

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        inv, = ctx.saved_tensors
        return g.index_select(0, inv.long()), None, None


def permute_rows(x: torch.Tensor, perm: torch.Tensor,
                 inv: torch.Tensor) -> torch.Tensor:
    """``x[perm]`` for a permutation ``perm`` whose inverse is ``inv``: the
    gradient is the gather ``g[inv]``, not an ``index_add_``."""
    return _PermuteRows.apply(x, perm, inv)


def dst_segment_softmax(logits: torch.Tensor,
                        edge_mask: Optional[torch.Tensor],
                        csr: CooCsr) -> torch.Tensor:
    """``segment_softmax(logits, edge_dst, N, mask=edge_mask)`` for edge
    logits ``[E]`` or ``[E, H]``: the logits taken in destination order
    (``csr.perm_dst``), P1 (:func:`segment_softmax_sorted`, masked logits at
    ``NEG``, times the mask after) over ``csr.row_ptr_dst``, and the
    weights returned to the edge order through ``csr.inv_dst``; P1's
    backward is P3."""
    c = CooCsr(*csr)
    x = permute_rows(logits, c.perm_dst, c.inv_dst)
    mask = None if edge_mask is None \
        else edge_mask.index_select(0, c.perm_dst.long())
    y = segment_softmax_sorted(x, None, c.row_ptr_dst.shape[0] - 1,
                               mask=mask, row_ptr=c.row_ptr_dst)
    return permute_rows(y, c.inv_dst, c.perm_dst)


def dst_segment_max_sumgrad(data: torch.Tensor,
                            edge_mask: Optional[torch.Tensor],
                            csr: CooCsr) -> torch.Tensor:
    """``segment_max_sumgrad(data, edge_dst, N, mask=edge_mask)`` for edge
    rows ``data`` ``[E, F]``: K3 (:func:`graph_max_pool`, whose contract is
    that function's: empty value 0, a valid NaN resets the max to 0, the
    gradient ``t * sel``) over the rows and mask in destination order
    with ``csr.row_ptr_dst`` as the segments; its gradient comes back to
    the edge order through ``csr.inv_dst``."""
    c = CooCsr(*csr)
    x = permute_rows(data.contiguous(), c.perm_dst, c.inv_dst)
    mask = None if edge_mask is None \
        else edge_mask.index_select(0, c.perm_dst.long()).contiguous()
    return graph_max_pool(x, c.row_ptr_dst, mask)


def gather_neighbors_max(node_feats: torch.Tensor, edge_src: torch.Tensor,
                         edge_mask: Optional[torch.Tensor],
                         csr: CooCsr) -> torch.Tensor:
    """``gather_neighbors_max``: each node's max over the sources of its
    incoming edges whose mask is set (0 where there is none), tied rows
    sharing the gradient: :func:`gather_src` (P2 in the backward), then
    :func:`dst_segment_max_sumgrad` (K3)."""
    return dst_segment_max_sumgrad(gather_src(node_feats, edge_src, csr),
                                   edge_mask, csr)
