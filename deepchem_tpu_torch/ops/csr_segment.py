"""Reductions over CSR edge ranges: the Hopper kernels and their plain
versions.

Counterparts of ``deepchem_tpu/ops/pallas_segment.py``'s
``csr_segment_softmax`` (P1), ``csr_segment_sum`` (P3) and
``fused_gather_segment_sum`` (P2).  Edges are sorted by destination and
``row_ptr`` (``[N+1]`` int32, ``row_ptr[0] == 0``) delimits each node's
range.  The kernels are ``csrc/<name>.cu``.  On CPU tensors each wrapper
computes its function with plain torch ops; on CUDA tensors it launches
the kernel or raises, and counts the launch in ``<wrapper>.launches``.

P1 and P3 are ``torch.autograd.Function``s on both devices, with the JAX
package's backwards: P1's is the softmax VJP ``dx = y * (dy - t[seg])``
with ``t = csr_segment_sum(y * dy)``, so on the card it launches P3; P3's
is the gather ``dmsgs = dy[seg]``.  P2 is forward only, as in JAX, in
float32 or bfloat16; ``ops/coo.py`` puts it in the autograd Functions of
the COO message passing.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from deepchem_tpu_torch.kernels import build


def edges_to_csr(edge_dst: np.ndarray, num_nodes: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: sort edge ids by destination; return ``(perm, row_ptr)``.

    ``perm`` reorders edge-parallel arrays into CSR order; ``row_ptr`` has
    ``num_nodes + 1`` entries.
    """
    edge_dst = np.asarray(edge_dst)
    perm = np.argsort(edge_dst, kind='stable').astype(np.int32)
    counts = np.bincount(edge_dst, minlength=num_nodes)
    row_ptr = np.zeros(num_nodes + 1, dtype=np.int32)
    np.cumsum(counts[:num_nodes], out=row_ptr[1:])
    return perm, row_ptr


def csr_row_ptr(segment_ids_sorted: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``row_ptr`` ``[num_segments + 1]`` int32 of non-decreasing segment
    ids: segment ``i`` owns edges ``row_ptr[i]:row_ptr[i+1]``.  On the CPU
    it raises when the ids decrease; on the card, where that check would
    wait for the device, the caller's layout guarantees the order."""
    ids = segment_ids_sorted
    if ids.device.type == 'cpu' and bool((ids[1:] < ids[:-1]).any()):
        raise ValueError('csr_row_ptr: segment ids must be non-decreasing')
    bounds = torch.arange(num_segments + 1, dtype=segment_ids_sorted.dtype,
                          device=segment_ids_sorted.device)
    return torch.searchsorted(segment_ids_sorted.contiguous(),
                              bounds).to(torch.int32)


def _edge_segments(row_ptr: torch.Tensor,
                   num_edges: int) -> torch.Tensor:
    """The segment of each of ``num_edges`` edges, int64; ``N`` for an
    edge past ``row_ptr[N]``."""
    return torch.searchsorted(row_ptr[1:].long(),
                              torch.arange(num_edges, device=row_ptr.device),
                              right=True)


def _take_rows(t: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """``t[seg]``, with a zero row for ``seg == len(t)``."""
    return F.pad(t, (0, 0, 0, 1)).index_select(0, seg)


# ---------------------------------------------------------------- P1

def csr_segment_softmax_reference(logits: torch.Tensor,
                                  row_ptr: torch.Tensor) -> torch.Tensor:
    """Plain torch version: per-segment max, shifted exp, segment sum, as
    the JAX kernel takes them.  The max is NaN where a logit is NaN, and a
    max that is not finite (no finite logit, +inf or NaN) becomes 0; the
    sum is clamped to at least 1e-16 by a clamp that keeps NaN."""
    E, H = logits.shape
    N = row_ptr.shape[0] - 1
    seg = _edge_segments(row_ptr, E)
    idx = seg[:, None].expand(E, H)
    seg_max = torch.full((N, H), -torch.inf, dtype=logits.dtype,
                         device=logits.device)
    seg_max = seg_max.scatter_reduce(0, idx, logits, 'amax')
    # scatter_reduce's amax may drop a NaN (on the card it does): count them
    nan = torch.zeros_like(seg_max).index_add_(
        0, seg, torch.isnan(logits).to(logits.dtype)) > 0
    seg_max = torch.where(torch.isfinite(seg_max) & ~nan, seg_max,
                          torch.zeros_like(seg_max))
    ex = torch.exp(logits - seg_max[seg])
    denom = torch.zeros_like(seg_max).index_add_(0, seg, ex)
    return ex / torch.clamp_min(denom[seg], 1e-16)


def _check(what: str, floats: Tuple[torch.Tensor, ...],
           ints: Tuple[torch.Tensor, ...],
           float_types: Tuple[torch.dtype, ...] = (torch.float32,)) -> None:
    """What every kernel takes: ``[rows, F]`` data of one of
    ``float_types`` (float32 unless given) and int32 1-D indices,
    contiguous, on one CUDA device, with sizes that fit int32."""
    dev = floats[0].device
    if dev.type != 'cuda' or any(t.device != dev for t in floats + ints):
        raise ValueError(f'{what}: every tensor must lie on one CUDA '
                         f'device, got '
                         f'{[str(t.device) for t in floats + ints]}')
    if any(t.dtype not in float_types for t in floats) \
            or any(t.dtype != torch.int32 for t in ints):
        raise TypeError(f'{what}: need {float_types} data and int32 '
                        f'indices, got '
                        f'{[t.dtype for t in floats + ints]}')
    if any(t.ndim != 2 for t in floats) or any(t.ndim != 1 for t in ints) \
            or ints[-1].shape[0] < 1:
        raise ValueError(f'{what}: need 2-D data, 1-D indices and row_ptr '
                         f'[N+1], got '
                         f'{[tuple(t.shape) for t in floats + ints]}')
    if not all(t.is_contiguous() for t in floats + ints):
        raise ValueError(f'{what}: every tensor must be contiguous')
    if any(t.numel() >= 2**31 for t in floats + ints):
        raise ValueError(f'{what}: sizes must fit in int32')


def _softmax_forward(logits: torch.Tensor,
                     row_ptr: torch.Tensor) -> torch.Tensor:
    if logits.device.type == 'cpu' and row_ptr.device.type == 'cpu':
        return csr_segment_softmax_reference(logits, row_ptr)
    _check('csr_segment_softmax', (logits,), (row_ptr,))
    out = torch.empty_like(logits)
    E, H = logits.shape
    N = row_ptr.shape[0] - 1
    if E * H == 0:
        return out
    if N == 0:
        raise ValueError('row_ptr has no segment for the edges')
    build.launch('csr_segment_softmax', 'csr_segment_softmax_f32',
                 (logits, row_ptr, out), (N, E, H))
    csr_segment_softmax.launches += 1
    return out


class _CsrSegmentSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, row_ptr):
        y = _softmax_forward(logits, row_ptr)
        ctx.save_for_backward(y, row_ptr)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        y, row_ptr = ctx.saved_tensors
        t = csr_segment_sum((y * dy).contiguous(), row_ptr)
        seg = _edge_segments(row_ptr, y.shape[0])
        return y * (dy - _take_rows(t, seg)), None


def csr_segment_softmax(logits: torch.Tensor,
                        row_ptr: torch.Tensor) -> torch.Tensor:
    """Per-segment softmax of CSR-sorted ``logits`` ``[E, H]`` float32
    over ``row_ptr`` ``[N+1]`` int32 with ``row_ptr[N] == E``.  Returns
    ``[E, H]`` weights that sum to 1 within each non-empty segment, with a
    gradient for ``logits`` on both devices.

    CPU tensors take :func:`csr_segment_softmax_reference`; CUDA tensors
    launch the kernel, counted in ``csr_segment_softmax.launches``.  The
    backward runs :func:`csr_segment_sum` (P3) on ``y * dy``.
    """
    return _CsrSegmentSoftmax.apply(logits, row_ptr)


csr_segment_softmax.launches = 0


# ---------------------------------------------------------------- P3

def csr_segment_sum_reference(msgs: torch.Tensor,
                              row_ptr: torch.Tensor) -> torch.Tensor:
    """Plain torch version: ``index_add_`` of each edge into its segment;
    edges past ``row_ptr[N]`` are dropped."""
    N = row_ptr.shape[0] - 1
    seg = _edge_segments(row_ptr, msgs.shape[0])
    out = msgs.new_zeros((N + 1,) + tuple(msgs.shape[1:]))
    return out.index_add_(0, seg, msgs)[:N]


def _segment_sum_forward(msgs: torch.Tensor,
                         row_ptr: torch.Tensor) -> torch.Tensor:
    if msgs.device.type == 'cpu' and row_ptr.device.type == 'cpu':
        return csr_segment_sum_reference(msgs, row_ptr)
    _check('csr_segment_sum', (msgs,), (row_ptr,))
    E, Fm = msgs.shape
    N = row_ptr.shape[0] - 1
    out = msgs.new_empty((N, Fm))
    if N * Fm == 0:
        return out
    if N * Fm >= 2**31:
        raise ValueError('csr_segment_sum: sizes must fit in int32')
    build.launch('csr_segment_sum', 'csr_segment_sum_f32',
                 (msgs, row_ptr, out), (N, E, Fm))
    csr_segment_sum.launches += 1
    return out


class _CsrSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msgs, row_ptr):
        ctx.save_for_backward(row_ptr)
        ctx.num_edges = msgs.shape[0]
        return _segment_sum_forward(msgs, row_ptr)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        row_ptr, = ctx.saved_tensors
        seg = _edge_segments(row_ptr, ctx.num_edges)
        return _take_rows(dy, seg), None


def csr_segment_sum(msgs: torch.Tensor, row_ptr: torch.Tensor
                    ) -> torch.Tensor:
    """``out[i] = sum(msgs[row_ptr[i]:row_ptr[i+1]])`` for CSR-sorted
    ``msgs`` ``[E, F]`` float32 over ``row_ptr`` ``[N+1]`` int32; returns
    ``[N, F]``, with 0 for an empty segment.  Edges past ``row_ptr[N]`` are
    ignored.  Differentiable in ``msgs``: the backward gathers ``dy`` by
    each edge's segment.

    CPU tensors take :func:`csr_segment_sum_reference`; CUDA tensors
    launch the kernel, counted in ``csr_segment_sum.launches``.  The sum of
    a segment is taken in the same order on every run.
    """
    return _CsrSegmentSum.apply(msgs, row_ptr)


csr_segment_sum.launches = 0


# ---------------------------------------------------------------- P2

def _csr_ranges(row_ptr: torch.Tensor, num_edges: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each segment's first edge and its edge count (int64), the ranges
    clamped to ``[0, num_edges]`` as the kernels clamp them."""
    rp = row_ptr.long()
    start = rp[:-1].clamp(0, num_edges)
    end = torch.maximum(rp[1:].clamp(max=num_edges), start)
    return start, end - start


def csr_neighbor_sum_reference(h: torch.Tensor, src_sorted: torch.Tensor,
                               row_ptr: torch.Tensor) -> torch.Tensor:
    """Plain torch version of :func:`fused_gather_segment_sum`.  float32:
    gather the messages ``h[src_sorted]``, then
    :func:`csr_segment_sum_reference`.  bfloat16: slot by slot, the k-th
    edge of every segment at step k, so each segment's edges are added in
    CSR order with every add rounded to bfloat16, as the JAX kernel adds
    them (and with no ``index_add_``, so the same on every run)."""
    if h.dtype != torch.bfloat16:
        return csr_segment_sum_reference(
            h.index_select(0, src_sorted.long()), row_ptr)
    E = src_sorted.shape[0]
    start, count = _csr_ranges(row_ptr, E)
    acc = h.new_zeros((start.shape[0], h.shape[1]))
    if E == 0 or h.shape[0] == 0:
        return acc
    src = src_sorted.long().clamp(0, h.shape[0] - 1)
    for k in range(int(count.max()) if count.numel() else 0):
        has = (count > k)[:, None]
        rows = h.index_select(0, src[(start + k).clamp(max=E - 1)])
        acc = torch.where(has, acc + rows, acc)
    return acc


_P2_ENTRIES = {torch.float32: 'fused_gather_segment_sum_f32',
               torch.bfloat16: 'fused_gather_segment_sum_bf16'}


def _gather_sum_forward(h: torch.Tensor, src_sorted: torch.Tensor,
                        row_ptr: torch.Tensor,
                        attr: str = 'launches') -> torch.Tensor:
    """P2 on any ``h``, with no autograd: the plain version on the CPU, the
    kernel on the card, counted in ``fused_gather_segment_sum.<attr>``
    (``bf16_launches`` for a bfloat16 ``h``)."""
    if all(t.device.type == 'cpu' for t in (h, src_sorted, row_ptr)):
        return csr_neighbor_sum_reference(h, src_sorted, row_ptr)
    _check('fused_gather_segment_sum', (h,), (src_sorted, row_ptr),
           float_types=tuple(_P2_ENTRIES))
    Nh, Fh = h.shape
    E = src_sorted.shape[0]
    N = row_ptr.shape[0] - 1
    out = h.new_empty((N, Fh))
    if N * Fh == 0:
        return out
    if N * Fh >= 2**31:
        raise ValueError('fused_gather_segment_sum: sizes must fit in int32')
    if Nh == 0 and E > 0:
        raise ValueError('fused_gather_segment_sum: edges but no rows in h')
    build.launch('fused_gather_segment_sum', _P2_ENTRIES[h.dtype],
                 (h, src_sorted, row_ptr, out), (N, Nh, E, Fh))
    if h.dtype == torch.bfloat16:
        attr = 'bf16_launches'
    setattr(fused_gather_segment_sum, attr,
            getattr(fused_gather_segment_sum, attr) + 1)
    return out


def fused_gather_segment_sum(h: torch.Tensor, src_sorted: torch.Tensor,
                             row_ptr: torch.Tensor) -> torch.Tensor:
    """``out[i] = sum(h[src_sorted[e]] for e in row_ptr[i]:row_ptr[i+1])``
    for ``h`` ``[N_h, F]`` float32 or bfloat16, ``src_sorted`` ``[E]``
    int32 in CSR order and ``row_ptr`` ``[N+1]`` int32; returns ``[N, F]``
    in ``h``'s type without materialising the messages.  A bfloat16 sum
    adds each segment's edges in CSR order, rounding every add to
    bfloat16, as the JAX kernel does; a float32 one adds them in another
    fixed order on the card.  Forward only, as in JAX: it raises when
    ``h`` needs a gradient (the COO graph ops in ``ops/coo.py`` wrap it in
    autograd Functions).

    CPU tensors take :func:`csr_neighbor_sum_reference`; CUDA tensors
    launch the kernel, counted in ``fused_gather_segment_sum.launches``
    (float32) or ``.bf16_launches`` (bfloat16).
    """
    if torch.is_grad_enabled() and h.requires_grad:
        raise RuntimeError('fused_gather_segment_sum has no backward; call '
                           'it under torch.no_grad() or on a detached h')
    return _gather_sum_forward(h, src_sorted, row_ptr)


#: f32 launches of the forward, f32 launches in the COO ops' backwards,
#: bf16 launches
fused_gather_segment_sum.launches = 0
fused_gather_segment_sum.backward_launches = 0
fused_gather_segment_sum.bf16_launches = 0
