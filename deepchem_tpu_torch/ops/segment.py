"""Graph segment operations on the padded COO batch layout.

Counterparts of ``deepchem_tpu/ops/segment.py``.  Padding convention:
ghost nodes have mask 0 and belong to ghost graph slot ``num_graphs``;
ghost edges point at the last node.  All reductions stay in bounds and
masks zero what the ghosts contribute.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from deepchem_tpu_torch.kernels import build
from deepchem_tpu_torch.ops.csr_segment import (csr_row_ptr,
                                                csr_segment_softmax,
                                                csr_segment_sum)

NEG = -9e15


def _expand_mask(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (ndim - mask.ndim))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids.long(), data)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, empty_value: float = 0.0) -> torch.Tensor:
    """Per-segment max; ``empty_value`` where a segment has no row."""
    idx = segment_ids.long().reshape(
        segment_ids.shape + (1,) * (data.ndim - 1)).expand_as(data)
    out = torch.full((num_segments,) + tuple(data.shape[1:]), -torch.inf,
                     dtype=data.dtype, device=data.device)
    out = out.scatter_reduce(0, idx, data, 'amax')
    return torch.where(torch.isfinite(out), out,
                       torch.full_like(out, empty_value))


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Per-segment mean; 0 for an empty segment."""
    s = segment_sum(data, segment_ids, num_segments)
    counts = segment_sum(torch.ones(data.shape[:1], dtype=data.dtype,
                                    device=data.device),
                         segment_ids, num_segments)
    return s / _expand_mask(torch.clamp_min(counts, 1.0), s.ndim)


def _max_select(data: torch.Tensor, seg: torch.Tensor, num_segments: int,
                valid: Optional[torch.Tensor], empty_value: float = 0.0
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(mx, sel, den)`` of the max readout with tie averaging, with no
    gradient: ``mx`` is each segment's max over the rows where ``valid``
    (bool ``[N]``, or None for all) is set, ``empty_value`` where there is
    none, where it is not finite (a valid NaN makes it NaN) or not above
    ``NEG / 2``; ``sel`` marks the valid rows that reach their segment's
    ``mx``, and ``den`` counts them."""
    with torch.no_grad():
        v = None if valid is None else _expand_mask(valid, data.ndim)
        d = data if v is None else torch.where(
            v, data, torch.full_like(data, -torch.inf))
        idx = seg.reshape(seg.shape + (1,) * (data.ndim - 1)).expand_as(data)
        mx = torch.full((num_segments,) + tuple(data.shape[1:]), -torch.inf,
                        dtype=data.dtype, device=data.device)
        mx = mx.scatter_reduce(0, idx, d, 'amax')
        # the max of a segment with a valid NaN is NaN on every device
        nan = segment_sum(torch.isnan(d).to(data.dtype), seg,
                          num_segments) > 0
        mx = torch.where(torch.isfinite(mx) & (mx > NEG / 2) & ~nan, mx,
                         torch.full_like(mx, empty_value))
        sel = data >= mx[seg]
        if v is not None:
            sel = sel & v
        den = segment_sum(sel.to(data.dtype), seg, num_segments)
    return mx, sel, den


def _max_sumgrad(data: torch.Tensor, seg: torch.Tensor, num_segments: int,
                 valid: Optional[torch.Tensor], empty_value: float = 0.0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(out, mx, den)``: the mean of the rows :func:`_max_select` picks
    (``empty_value`` where it picks none), differentiable in ``data``.
    As in the JAX package, the sum is of ``data * sel`` over every row of
    the segment, so a non-finite row that is not picked, masked or not,
    makes it NaN, and so does an infinite or NaN cotangent its
    gradient."""
    mx, sel, den = _max_select(data, seg, num_segments, valid, empty_value)
    num = segment_sum(data * sel.to(data.dtype), seg, num_segments)
    out = torch.where(den > 0, num / torch.clamp_min(den, 1.0),
                      torch.full_like(num, empty_value))
    return out, mx, den


def segment_max_sumgrad(data: torch.Tensor, segment_ids: torch.Tensor,
                        num_segments: int,
                        mask: Optional[torch.Tensor] = None,
                        empty_value: float = 0.0) -> torch.Tensor:
    """Per-segment max over the rows whose ``mask`` is set, whose gradient
    goes to the rows that attain it (tied rows share the value and the
    gradient); ``empty_value`` where no row is valid, or where the max is
    not above ``NEG / 2``.  Plain torch for any segment ids: the JAX
    package's formulation, with the max and the tie count carrying no
    gradient."""
    return _max_sumgrad(data, segment_ids.long(), num_segments,
                        None if mask is None else mask > 0, empty_value)[0]


def node_degrees(edge_dst: torch.Tensor, num_nodes: int,
                 edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Incoming edges per node, int32; masked edges do not count."""
    ones = torch.ones(edge_dst.shape[0], dtype=torch.float32,
                      device=edge_dst.device) if edge_mask is None \
        else edge_mask.float()
    return segment_sum(ones, edge_dst, num_nodes).to(torch.int32)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Numerically stable softmax within segments, for segment ids in any
    order (GAT/AttentiveFP attention)."""
    ids = segment_ids.long()
    if mask is not None:
        m = _expand_mask(mask, logits.ndim)
        logits = torch.where(m > 0, logits, torch.full_like(logits, NEG))
    idx = ids.reshape(ids.shape + (1,) * (logits.ndim - 1)).expand_as(logits)
    seg_max = torch.full((num_segments,) + tuple(logits.shape[1:]),
                         -torch.inf, dtype=logits.dtype,
                         device=logits.device)
    seg_max = seg_max.scatter_reduce(0, idx, logits, 'amax')
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    exp = torch.exp(logits - seg_max[ids])
    if mask is not None:
        exp = exp * m
    denom = segment_sum(exp, ids, num_segments)
    return exp / torch.clamp_min(denom[ids], 1e-16)


def segment_softmax_sorted(logits: torch.Tensor,
                           segment_ids_sorted: torch.Tensor,
                           num_segments: int,
                           mask: Optional[torch.Tensor] = None,
                           row_ptr: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """:func:`segment_softmax` for segment ids in NON-DECREASING order,
    through the CSR kernel (:func:`csr_segment_softmax`).  A caller that
    softmaxes over the same ids more than once passes their ``row_ptr``
    (:func:`csr_row_ptr`) so it is built once.

    Masked logits become ``NEG`` before the softmax and the result is
    multiplied by the mask after it, so a fully masked segment gives 0.
    Callers guarantee sortedness (the graph models sort edges by
    destination when they pack a batch); results are garbage otherwise.
    """
    squeeze = logits.ndim == 1
    x = logits[:, None] if squeeze else logits
    m = None
    if mask is not None:
        m = _expand_mask(mask, x.ndim)
        x = torch.where(m > 0, x, torch.full_like(x, NEG))
    if row_ptr is None:
        row_ptr = csr_row_ptr(segment_ids_sorted, num_segments)
    y = csr_segment_softmax(x.contiguous(), row_ptr)
    if m is not None:
        y = y * m
    return y[:, 0] if squeeze else y


# ---------------------------------------------------------------- K3

def _graph_rows(row_ptr: torch.Tensor, num_rows: int,
                node_mask: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The graph of each row (int64; ``G`` for a row past ``row_ptr[G]``)
    and whether the row is valid: in a graph, with its mask set."""
    G = row_ptr.shape[0] - 1
    seg = torch.searchsorted(row_ptr[1:].long(),
                             torch.arange(num_rows, device=row_ptr.device),
                             right=True)
    valid = seg < G
    if node_mask is not None:
        valid = valid & (node_mask > 0)
    return seg, valid


def graph_max_pool_reference(x: torch.Tensor, row_ptr: torch.Tensor,
                             node_mask: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain torch version of K3's forward over graph-contiguous rows
    (graph ``b`` owns rows ``row_ptr[b]:row_ptr[b+1]``; later rows belong
    to no graph): ``(out, mx, den)``, each ``[G, F]``, from
    :func:`segment_max_sumgrad`'s formula.  ``mx`` is the max over the
    valid rows (0 where there is none or it is not above ``NEG / 2``),
    ``den`` the number of valid rows that reach it, ``out`` their mean (0
    where ``den`` is 0)."""
    G = row_ptr.shape[0] - 1
    seg, valid = _graph_rows(row_ptr, x.shape[0], node_mask)
    return tuple(t[:G] for t in _max_sumgrad(x, seg, G + 1, valid))


def graph_max_pool_backward_reference(g: torch.Tensor, x: torch.Tensor,
                                      row_ptr: torch.Tensor,
                                      node_mask: Optional[torch.Tensor],
                                      mx: torch.Tensor,
                                      den: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K3's backward: ``t * sel`` on every row of
    graph ``b``, masked rows included, with ``t = g[b] / den`` where
    ``den > 0`` and 0 where it is 0, and ``sel`` 1 on the valid rows that
    reach the max (the JAX gradient: an infinite or NaN ``t`` makes the
    other rows NaN); 0 on the rows past the last graph."""
    seg, valid = _graph_rows(row_ptr, x.shape[0], node_mask)
    t = torch.where(den > 0, g, torch.zeros_like(g)) / torch.clamp_min(
        den, 1.0)
    # each row's graph, with a zero row past the last graph for seg == G
    mx, t = (F.pad(a, (0, 0, 0, 1))[seg] for a in (mx, t))
    sel = _expand_mask(valid, x.ndim) & (x >= mx)
    return t * sel.to(x.dtype)


def _check_pool(what: str, floats, row_ptr: torch.Tensor,
                node_mask: Optional[torch.Tensor]) -> None:
    """What K3 takes: float32 2-D data, the first ``x`` ``[N, F]``, int32
    ``row_ptr`` ``[G+1]``, a float32 ``[N]`` mask or none, contiguous, on
    one CUDA device."""
    tensors = tuple(floats) + (row_ptr,) + \
        ((node_mask,) if node_mask is not None else ())
    dev = floats[0].device
    if dev.type != 'cuda' or any(t.device != dev for t in tensors):
        raise ValueError(f'{what}: every tensor must lie on one CUDA '
                         f'device, got {[str(t.device) for t in tensors]}')
    if any(t.dtype != torch.float32 for t in floats) \
            or row_ptr.dtype != torch.int32 or (
                node_mask is not None and node_mask.dtype != torch.float32):
        raise TypeError(f'{what}: need float32 data and mask and an int32 '
                        f'row_ptr, got {[t.dtype for t in tensors]}')
    if any(t.ndim != 2 for t in floats) or row_ptr.ndim != 1 \
            or row_ptr.shape[0] < 1 or (
                node_mask is not None
                and tuple(node_mask.shape) != (floats[0].shape[0],)):
        raise ValueError(f'{what}: need 2-D data, row_ptr [G+1] and a mask '
                         f'[N], got {[tuple(t.shape) for t in tensors]}')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f'{what}: every tensor must be contiguous')
    if any(t.numel() >= 2**31 for t in tensors):
        raise ValueError(f'{what}: sizes must fit in int32')


def _graph_max_forward(x, row_ptr, node_mask):
    if all(t.device.type == 'cpu' for t in (x, row_ptr)):
        return graph_max_pool_reference(x, row_ptr, node_mask)
    _check_pool('graph_max_pool', (x,), row_ptr, node_mask)
    G, (N, F) = row_ptr.shape[0] - 1, x.shape
    out, mx, den = (x.new_empty((G, F)) for _ in range(3))
    if G * F:
        build.launch('graph_pool', 'graph_max_pool_fwd_f32',
                     (x, row_ptr, node_mask, out, mx, den), (G, N, F))
        graph_max_pool.launches += 1
    return out, mx, den


def _graph_max_backward(g, x, row_ptr, node_mask, mx, den):
    if all(t.device.type == 'cpu' for t in (g, x, row_ptr)):
        return graph_max_pool_backward_reference(g, x, row_ptr, node_mask,
                                                 mx, den)
    _check_pool('graph_max_pool backward', (x, g, mx, den), row_ptr,
                node_mask)
    G, (N, F) = row_ptr.shape[0] - 1, x.shape
    if G == 0:
        return torch.zeros_like(x)
    dx = torch.empty_like(x)
    if N * F:
        build.launch('graph_pool', 'graph_max_pool_bwd_f32',
                     (g, x, row_ptr, node_mask, mx, den, dx), (G, N, F))
        graph_max_pool.backward_launches += 1
    return dx


class _GraphMaxPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, row_ptr, node_mask):
        out, mx, den = _graph_max_forward(x, row_ptr, node_mask)
        ctx.save_for_backward(x, row_ptr, node_mask, mx, den)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, row_ptr, node_mask, mx, den = ctx.saved_tensors
        return _graph_max_backward(g.contiguous(), x, row_ptr, node_mask,
                                   mx, den), None, None


def graph_max_pool(x: torch.Tensor, row_ptr: torch.Tensor,
                   node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3: per graph and feature, the mean of the valid rows that reach the
    graph's max (so tied maxima share it), over graph-contiguous rows
    ``x`` ``[N, F]`` float32 with ``row_ptr`` ``[G+1]`` int32 and an
    optional float32 ``node_mask`` ``[N]``; returns ``[G, F]``, 0 for a
    graph with no valid row.  Rows past ``row_ptr[G]`` (the ghost slot)
    are dropped.  The gradient goes to the rows that reach the max, each
    taking ``g / den``.

    CPU tensors take :func:`graph_max_pool_reference` and its backward;
    CUDA tensors launch ``graph_max_pool_fwd_kernel`` and
    ``graph_max_pool_bwd_kernel``, counted in ``graph_max_pool.launches``
    and ``.backward_launches`` (each one's float4 path also in
    :func:`graph_max_pool_float4_launches`).  Both give the JAX package's
    results on every input: a valid NaN makes the max NaN and so resets
    it to 0, and a non-finite row that is not selected makes the output
    NaN, as a non-finite cotangent makes the gradient of such rows.
    """
    return _GraphMaxPool.apply(x, row_ptr, node_mask)


graph_max_pool.launches = graph_max_pool.backward_launches = 0


def graph_max_pool_float4_launches() -> Tuple[int, int]:
    """Launches of K3's forward and of its backward since the kernels were
    loaded that took the float4 path (F a multiple of 4; the forward's
    ``x``, the backward's ``g``, ``x``, ``mx``, ``den`` and ``dx`` 16-byte
    aligned); their other launches took one float a unit."""
    counts = (ctypes.c_longlong * 2)()
    build.load('graph_pool').graph_pool_float4_launches(counts)
    return counts[0], counts[1]


def graph_pool(node_feats: torch.Tensor, graph_index: torch.Tensor,
               num_graphs: int, node_mask: Optional[torch.Tensor] = None,
               mode: str = 'sum') -> torch.Tensor:
    """Per-graph readout over nodes: 'sum', 'mean' or 'max' (see
    :func:`graph_max_pool`).  ``num_graphs`` EXCLUDES the ghost slot; the
    result has ``num_graphs`` rows.

    Node rows must be graph-contiguous with ``graph_index`` non-decreasing
    and the ghost slot last, as the batch layout packs them: on the CPU
    :func:`csr_row_ptr` raises otherwise.  'sum' and 'mean' run
    :func:`csr_segment_sum` (P3) over the graphs, 'max'
    :func:`graph_max_pool` (K3).
    """
    if mode not in ('sum', 'mean', 'max'):
        raise ValueError(f'bad pool mode {mode}')
    row_ptr = csr_row_ptr(graph_index, num_graphs)
    if mode == 'max':
        return graph_max_pool(node_feats.contiguous(), row_ptr,
                              None if node_mask is None
                              else node_mask.contiguous())
    feats = node_feats
    if node_mask is not None:
        feats = feats * node_mask[:, None]
    out = csr_segment_sum(feats.contiguous(), row_ptr)
    if mode == 'mean':
        ones = node_mask if node_mask is not None \
            else node_feats.new_ones(node_feats.shape[0])
        counts = csr_segment_sum(ones[:, None].contiguous(), row_ptr)
        out = out / torch.clamp_min(counts, 1.0)
    return out
