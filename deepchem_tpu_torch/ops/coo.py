"""Message passing over the padded COO edge list, on P2 and K3.

Counterparts of ``deepchem_tpu/ops/segment.py``'s ``gather_neighbors_sum``
and of its ``segment_sum`` and ``segment_max_sumgrad`` over edge
destinations, as ``deepchem_tpu/models/pna.py``'s aggregators call them.
The JAX package scatters by ``edge_dst``; here each batch carries the
CSR of its edges by destination and by source (:func:`coo_csr`, built
when the batch is packed), so every sum is :func:`fused_gather_segment_sum`
(P2) over CSR ranges, every max K3 (:func:`graph_max_pool`) over the rows
in destination order, and every backward a P2 over the other CSR, K3's
backward or a gather: no scatter with float atomics.  The edge arrays keep
their order.

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
from deepchem_tpu_torch.ops.segment import graph_max_pool


class CooCsr(NamedTuple):
    """The CSR arrays of a batch's edges (``[E]`` or ``[N+1]`` int32).

    ``src_by_dst``: each edge's source, edges in stable destination order;
    ``row_ptr_dst``: node ``i``'s incoming edges are positions
    ``row_ptr_dst[i]:row_ptr_dst[i+1]`` of that order; ``dst_by_src`` and
    ``row_ptr_src`` the same by source; ``perm_dst``: the edge ids in
    destination order; ``inv_dst``: each edge's position in it."""
    src_by_dst: torch.Tensor
    row_ptr_dst: torch.Tensor
    dst_by_src: torch.Tensor
    row_ptr_src: torch.Tensor
    perm_dst: torch.Tensor
    inv_dst: torch.Tensor


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
            inv_dst]


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


class _DstSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, edge_dst, perm_dst, row_ptr_dst):
        ctx.save_for_backward(edge_dst)
        return csr_segment._gather_sum_forward(data.contiguous(), perm_dst,
                                              row_ptr_dst)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        edge_dst, = ctx.saved_tensors
        return g.index_select(0, edge_dst.long()), None, None, None


def dst_segment_sum(data: torch.Tensor, edge_dst: torch.Tensor,
                    csr: CooCsr) -> torch.Tensor:
    """``segment_sum(data, edge_dst, N)`` for edge rows ``data`` ``[E, F]``:
    P2 over ``csr.row_ptr_dst`` reading the rows in destination order
    (``csr.perm_dst``), so no permuted copy is written; the gradient is the
    gather ``g[edge_dst]``, as in JAX.  Every edge counts, ghost ones too:
    callers multiply by the mask first, as the JAX package does."""
    c = CooCsr(*csr)
    return _DstSegmentSum.apply(data, edge_dst, c.perm_dst, c.row_ptr_dst)


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
    x = _PermuteRows.apply(data.contiguous(), c.perm_dst, c.inv_dst)
    mask = None if edge_mask is None \
        else edge_mask.index_select(0, c.perm_dst.long()).contiguous()
    return graph_max_pool(x, c.row_ptr_dst, mask)
