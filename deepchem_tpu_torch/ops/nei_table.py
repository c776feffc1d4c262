"""Padded neighbour-table aggregation with gather-transpose backwards:
the Hopper kernels K1, K2 and K4 and their plain versions.

Counterparts of ``deepchem_tpu/ops/nei_table.py``'s
``build_neighbor_table``, ``build_rev_slot``, ``nei_sum``,
``nei_max_incl_self``, ``nei_gather``, ``nei_sum_edges`` and
``take_src``.  A batch of undirected graphs (both
directions of every edge present) becomes a table ``[N, K]`` int32 whose
row ``i`` lists ``i``'s neighbours in edge order, and int8 degrees
``[N]``: slot ``j`` of row ``i`` is real iff ``j < deg[i]``.  The table of
an undirected graph is its own transpose, so both ops' backwards are
gathers too.  A directed message-passing model (MPNN) builds the same
tables over edge ids instead: each node's incoming edges and its outgoing
ones, whose K1 sums rows of ``[E, F]`` edge data into ``[N, F]``.
The attention layers (GAT, AttentiveFP) gather each slot's row with K4
(:func:`nei_gather`), whose backward is K1 over the cotangent's slot rows
through each slot's reverse slot (:func:`build_rev_slot`).

On CPU tensors each op computes with its plain torch version
(``*_reference``), written as the JAX slot loop; on CUDA tensors it
launches ``csrc/nei_table.cu`` (K4's forward ``csrc/nei_gather.cu``) or
raises, and counts the launch in
``<op>.launches`` (forward) or ``<op>.backward_launches``.  K1 and K2's
forward and backward each have two kernel paths, float4 rows and one
float a lane; the C entry picks one and counts it
(:func:`float4_launches`).  The kernels give the JAX package's results on
every input, NaN and infinities and values below ``NEG`` included: K1
adds a pad slot's row times 0, and K2's forward lets a pad slot offer
``NEG``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from deepchem_tpu_torch.kernels import build
from deepchem_tpu_torch.ops.segment import NEG


def build_neighbor_table(edge_src: np.ndarray, edge_dst: np.ndarray,
                         num_nodes: int, max_nb: int = 10
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """COO edges (both directions present) -> ``(table, nbr_mask)``:
    ``table[i, j]`` is the ``j``-th source of an edge into ``i`` in edge
    order (0-padded), ``nbr_mask[i, j]`` 1.0 for real slots.

    Raises when a node's degree exceeds ``max_nb``: the backwards assume a
    complete table, so dropping neighbours would make both passes wrong.
    """
    edge_src = np.asarray(edge_src, np.int64)
    edge_dst = np.asarray(edge_dst, np.int64)
    order = np.argsort(edge_dst, kind='stable')
    ds, ss = edge_dst[order], edge_src[order]
    counts = np.bincount(ds, minlength=num_nodes)
    max_deg = int(counts.max()) if len(counts) else 0
    if max_deg > max_nb:
        raise ValueError(
            f'node degree {max_deg} exceeds the neighbor-table capacity '
            f'max_nb={max_nb}; raise max_neighbors on the model (the '
            'table aggregation cannot truncate: its gather-transpose '
            'gradients assume a complete table)')
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(ds)) - np.repeat(starts, counts)
    table = np.zeros((num_nodes, max_nb), np.int32)
    table[ds, pos] = ss
    nbr_mask = (np.arange(max_nb)[None, :]
                < counts[:, None]).astype(np.float32)
    return table, nbr_mask


def build_rev_slot(table: np.ndarray, nbr_mask: np.ndarray) -> np.ndarray:
    """``rev_slot[i, j]``: the position of ``i`` in row ``table[i, j]``, the
    slot its neighbour uses for the reverse direction; 0 on pad slots.
    int8 ``[N, K]``.  The graph must be simple and undirected (each
    neighbour once a row), as molecular graphs are: a parallel edge would
    alias to one reverse slot."""
    n = table.shape[0]
    hit = table[table] == np.arange(n)[:, None, None]          # [N, K, K]
    rs = np.argmax(hit, axis=2).astype(np.int8)
    return np.where(nbr_mask > 0, rs, 0).astype(np.int8)


def slot_mask(table: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """``[N, K]`` bool: slot ``j`` of row ``i`` is real iff
    ``j < deg[i]``."""
    slots = torch.arange(table.shape[1], device=table.device)
    return slots[None, :] < deg.long()[:, None]


def nei_sum_reference(h: torch.Tensor, table: torch.Tensor,
                      deg: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K1: ``sum over j < deg[i] of h[table[i, j]]``
    for ``h`` ``[R, F]`` and ``table`` ``[N, K]`` into ``[N, F]``, one slot
    at a time in ascending order."""
    mask = slot_mask(table, deg).to(h.dtype)
    idx = table.long()
    out = h[idx[:, 0]] * mask[:, 0:1]
    for j in range(1, table.shape[1]):
        out = out + h[idx[:, j]] * mask[:, j:j + 1]
    return out


def nei_gather_reference(x: torch.Tensor, table: torch.Tensor,
                         deg: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K4's forward: ``x[table[i, j]]`` times 1.0 on
    a real slot and 0.0 on a pad slot, ``[N, K, ...]`` from ``x`` ``[N,
    ...]``; a pad slot gives a signed zero, or NaN where its row is not
    finite, as the JAX op's mask does."""
    mask = slot_mask(table, deg).to(x.dtype)
    out = x[table.long()]
    return out * mask.reshape(mask.shape + (1,) * (out.ndim - 2))


def nei_max_reference(h: torch.Tensor, table: torch.Tensor,
                      deg: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K2's forward: the max over a node and its
    real neighbours, and its winner ``[N, F]`` int32.  A neighbour takes
    the max only when strictly greater, so self wins a tie, then the
    lowest slot, and a NaN never takes it.  As in the JAX package a pad
    slot offers ``NEG`` with its table entry, so a node whose values are
    all below ``NEG`` takes ``NEG`` from its first pad slot."""
    mask = slot_mask(table, deg)
    n = h.shape[0]
    best = h
    winner = torch.arange(n, dtype=torch.int32,
                          device=h.device)[:, None].expand(h.shape)
    for j in range(table.shape[1]):
        idx = table[:, j]
        cand = torch.where(mask[:, j:j + 1], h[idx.long()],
                           torch.full_like(h, NEG))
        take = cand > best
        best = torch.where(take, cand, best)
        winner = torch.where(take, idx[:, None].expand(h.shape), winner)
    return best, winner.contiguous()


def nei_max_backward_reference(g: torch.Tensor, table: torch.Tensor,
                               deg: torch.Tensor,
                               winner: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K2's backward: ``g[m]`` where ``m`` won its
    own max, plus, for each real slot ``j`` of ``m`` in order, ``g[t]``
    where ``t = table[m, j]`` took its max from ``m``."""
    mask = slot_mask(table, deg)
    self_idx = torch.arange(g.shape[0], dtype=torch.int32,
                            device=g.device)[:, None]
    grad = torch.where(winner == self_idx, g, torch.zeros_like(g))
    for j in range(table.shape[1]):
        idx = table[:, j].long()
        hit = (winner[idx] == self_idx) & mask[:, j:j + 1]
        grad = grad + torch.where(hit, g[idx], torch.zeros_like(g))
    return grad


def _check(what: str, floats, table: torch.Tensor, deg: torch.Tensor,
           ints=(), source=None) -> None:
    """What the kernels take: float32 ``[N, F]`` data (and int32 ``[N,
    F]`` winners), or a float32 ``source`` ``[R, F]`` of any R >= 1, an
    int32 ``[N, K]`` table with ``K <= 32`` and int8 ``[N]`` degrees,
    contiguous, on one CUDA device."""
    src = () if source is None else (source,)
    tensors = src + tuple(floats) + tuple(ints) + (table, deg)
    dev = tensors[0].device
    if dev.type != 'cuda' or any(t.device != dev for t in tensors):
        raise ValueError(f'{what}: every tensor must lie on one CUDA '
                         f'device, got {[str(t.device) for t in tensors]}')
    if any(t.dtype != torch.float32 for t in src + tuple(floats)) \
            or any(t.dtype != torch.int32 for t in tuple(ints) + (table,)) \
            or deg.dtype != torch.int8:
        raise TypeError(f'{what}: need float32 data, an int32 table and '
                        f'int8 degrees, got {[t.dtype for t in tensors]}')
    n = table.shape[0]
    if table.ndim != 2 or table.shape[1] > 32 or tuple(deg.shape) != (n,) \
            or any(t.ndim != 2 or t.shape[0] != n
                   for t in tuple(floats) + tuple(ints)) \
            or any(t.ndim != 2 or t.shape[0] < 1 for t in src):
        raise ValueError(f'{what}: need [N, F] data or an [R >= 1, F] '
                         f'source, an [N, K <= 32] table and [N] degrees, '
                         f'got {[tuple(t.shape) for t in tensors]}')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f'{what}: every tensor must be contiguous')
    if any(t.numel() >= 2**31 for t in tensors) \
            or n * (src[0].shape[1] if src else 1) >= 2**31:
        raise ValueError(f'{what}: sizes must fit in int32')


def float4_launches() -> Tuple[int, int, int]:
    """Launches of K1, of K2's backward and of K2's forward since the
    kernels were loaded that took the float4 path (F a multiple of 4,
    every data pointer 16-byte aligned); their other launches took one
    float a lane."""
    counts = (ctypes.c_longlong * 3)()
    build.load('nei_table').nei_table_float4_launches(counts)
    return counts[0], counts[1], counts[2]


def _nei_sum_forward(h: torch.Tensor, table: torch.Tensor,
                     deg: torch.Tensor, counter, attr: str = 'launches'
                     ) -> torch.Tensor:
    """K1 from the ``[R, F]`` rows ``h`` through the ``[N, K]`` table into
    ``[N, F]``: the kernel on the card, counted in ``counter.<attr>``;
    the plain version on the CPU."""
    if all(t.device.type == 'cpu' for t in (h, table, deg)):
        return nei_sum_reference(h, table, deg)
    _check('nei_sum', (), table, deg, source=h)
    out = h.new_empty((table.shape[0], h.shape[1]))
    if out.numel():
        build.launch('nei_table', 'nei_sum_f32', (h, table, deg, out),
                     (h.shape[0], table.shape[0], table.shape[1],
                      h.shape[1]))
        setattr(counter, attr, getattr(counter, attr) + 1)
    return out


def nei_gather_float4_launches() -> int:
    """Launches of K4's forward since the kernels were loaded that took
    the float4 path (C a multiple of 4, ``x`` and the output 16-byte
    aligned); its other launches took one float a lane."""
    counts = (ctypes.c_longlong * 1)()
    build.load('nei_gather').nei_gather_float4_launches(counts)
    return counts[0]


def _nei_gather_forward(x: torch.Tensor, table: torch.Tensor,
                        deg: torch.Tensor) -> torch.Tensor:
    """K4's forward over ``x`` ``[N, C]``: ``[N, K, C]``, the kernel on the
    card, counted in ``nei_gather.launches``; the plain version on the
    CPU."""
    if all(t.device.type == 'cpu' for t in (x, table, deg)):
        return nei_gather_reference(x, table, deg)
    _check('nei_gather', (x,), table, deg)
    n, k = table.shape
    if n * k * x.shape[1] >= 2**31:
        raise ValueError('nei_gather: sizes must fit in int32')
    out = x.new_empty((n, k, x.shape[1]))
    if out.numel():
        build.launch('nei_gather', 'nei_gather_f32', (x, table, deg, out),
                     (n, k, x.shape[1]))
        nei_gather.launches += 1
    return out


def _nei_max_forward(h: torch.Tensor, table: torch.Tensor,
                     deg: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    if all(t.device.type == 'cpu' for t in (h, table, deg)):
        return nei_max_reference(h, table, deg)
    _check('nei_max_incl_self', (h,), table, deg)
    out = torch.empty_like(h)
    winner = torch.empty(h.shape, dtype=torch.int32, device=h.device)
    if h.numel():
        build.launch('nei_table', 'nei_max_fwd_f32',
                     (h, table, deg, out, winner),
                     (h.shape[0], table.shape[1], h.shape[1]))
        nei_max_incl_self.launches += 1
    return out, winner


def _nei_max_backward(g: torch.Tensor, table: torch.Tensor,
                      deg: torch.Tensor,
                      winner: torch.Tensor) -> torch.Tensor:
    if all(t.device.type == 'cpu' for t in (g, table, deg, winner)):
        return nei_max_backward_reference(g, table, deg, winner)
    _check('nei_max_incl_self backward', (g,), table, deg, (winner,))
    grad = torch.empty_like(g)
    if g.numel():
        build.launch('nei_table', 'nei_max_bwd_f32',
                     (g, table, deg, winner, grad),
                     (g.shape[0], table.shape[1], g.shape[1]))
        nei_max_incl_self.backward_launches += 1
    return grad


class _NeiSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, table, deg):
        if h.shape[0] != table.shape[0]:
            raise ValueError(
                f'nei_sum: {h.shape[0]} rows through a table of '
                f'{table.shape[0]}; its backward needs a square, symmetric '
                'table (edge-id tables take nei_sum_edges or take_src)')
        ctx.save_for_backward(table, deg)
        return _nei_sum_forward(h, table, deg, nei_sum)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        table, deg = ctx.saved_tensors
        return _nei_sum_forward(g.contiguous(), table, deg, nei_sum,
                                'backward_launches'), None, None


class _NeiSumEdges(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, e_table, e_deg, edst, emask):
        ctx.save_for_backward(edst, emask)
        return _nei_sum_forward(h, e_table, e_deg, nei_sum_edges)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        edst, emask = ctx.saved_tensors
        return (g.index_select(0, edst.long()) * emask[:, None], None, None,
                None, None)


class _TakeSrc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, carry, esrc, o_table, o_deg):
        ctx.save_for_backward(o_table, o_deg)
        return carry.index_select(0, esrc.long())

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        o_table, o_deg = ctx.saved_tensors
        return _nei_sum_forward(g.contiguous(), o_table, o_deg, take_src,
                                'backward_launches'), None, None, None


class _NeiGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, table, rev_slot, deg):
        n, k = table.shape
        if x.shape[0] != n:
            raise ValueError(
                f'nei_gather: {x.shape[0]} rows through a table of {n}; its '
                'backward needs a square, symmetric table')
        ctx.x_shape = x.shape
        if ctx.needs_input_grad[0]:
            # row of g [N * K, C] that each slot's reverse slot names; 0 on
            # pad slots, whose terms the mask zeroes
            ctx.save_for_backward(table * k + rev_slot.to(table.dtype), deg)
        out = _nei_gather_forward(x.reshape(n, -1).contiguous(), table, deg)
        return out.reshape((n, k) + tuple(x.shape[1:]))

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        rev_rows, deg = ctx.saved_tensors
        n, k = rev_rows.shape
        grad = _nei_sum_forward(g.reshape(n * k, -1).contiguous(), rev_rows,
                                deg, nei_gather, 'backward_launches')
        return grad.reshape(ctx.x_shape), None, None, None


class _NeiMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, table, deg):
        out, winner = _nei_max_forward(h, table, deg)
        ctx.save_for_backward(table, deg, winner)
        ctx.mark_non_differentiable(winner)
        return out, winner

    @staticmethod
    @once_differentiable
    def backward(ctx, g, _):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        table, deg, winner = ctx.saved_tensors
        return _nei_max_backward(g.contiguous(), table, deg,
                                 winner), None, None


def nei_sum(h: torch.Tensor, table: torch.Tensor,
            deg: torch.Tensor) -> torch.Tensor:
    """K1: ``out[i] = sum over j < deg[i] of h[table[i, j]]`` for ``h``
    ``[N, F]`` float32, ``table`` ``[N, K]`` int32 and ``deg`` ``[N]`` int8,
    plus ``h[table[i, j]] * 0`` for each pad slot ``j >= deg[i]`` (NaN
    where that row is not finite, as in the JAX package), so every table
    entry must lie in ``[0, N)``.
    Differentiable in ``h``; the backward is the same sum of the cotangent
    (the table of an undirected graph is its own transpose), launched only
    when ``h`` needs a gradient.

    CPU tensors take :func:`nei_sum_reference`; CUDA tensors launch
    ``nei_sum_kernel``, counted in ``nei_sum.launches`` and
    ``nei_sum.backward_launches``.
    """
    return _NeiSum.apply(h, table, deg)


def nei_sum_edges(h: torch.Tensor, e_table: torch.Tensor,
                  e_deg: torch.Tensor, edst: torch.Tensor,
                  emask: torch.Tensor) -> torch.Tensor:
    """Edge-to-node sum: K1 from ``h`` ``[E, F]`` float32 through the
    incoming-edge-id table ``e_table`` ``[N, K]`` int32 (entries in ``[0,
    E)``) and ``e_deg`` ``[N]`` int8 into ``[N, F]``.  Each directed edge
    arrives at one node, so the gradient of ``h`` is the row gather
    ``g[edst] * emask`` (``edst`` ``[E]`` the edges' destinations,
    ``emask`` ``[E]`` 1.0 for real edges), as in the JAX package.

    CPU tensors take :func:`nei_sum_reference`; CUDA tensors launch
    ``nei_sum_kernel``, counted in ``nei_sum_edges.launches``.
    """
    return _NeiSumEdges.apply(h, e_table, e_deg, edst, emask)


def take_src(carry: torch.Tensor, esrc: torch.Tensor, o_table: torch.Tensor,
             o_deg: torch.Tensor) -> torch.Tensor:
    """Node-to-edge broadcast ``carry[esrc]`` ``[E, F]`` whose gradient is
    no scatter: K1 of the cotangent ``[E, F]`` through each node's
    outgoing-edge-id table ``o_table`` ``[N, K]`` int32 and ``o_deg``
    ``[N]`` int8, so every edge that leaves a node must stand in its row.

    The backward runs :func:`nei_sum_reference` on CPU tensors and
    launches ``nei_sum_kernel`` on CUDA tensors, counted in
    ``take_src.backward_launches``, when ``carry`` needs a gradient.
    """
    return _TakeSrc.apply(carry, esrc, o_table, o_deg)


def nei_gather(x: torch.Tensor, table: torch.Tensor,
               rev_slot: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """K4: ``out[i, j] = x[table[i, j]]`` on a real slot (``j < deg[i]``)
    and ``x[table[i, j]] * 0`` on a pad slot, ``[N, K, ...]`` from ``x``
    ``[N, ...]`` float32 (its trailing dimensions flattened to C), with
    ``table`` ``[N, K]`` int32 (every entry in ``[0, N)``), ``rev_slot``
    ``[N, K]`` int8 (:func:`build_rev_slot`) and ``deg`` ``[N]`` int8.
    Differentiable in ``x``: ``grad[m] = sum over j of g[table[m, j],
    rev_slot[m, j]]`` times the slot's mask, in ascending ``j`` from the
    term of slot 0, as the JAX op sums it; that is K1 of ``g`` viewed as
    ``[N * K, C]`` through the rows ``table * K + rev_slot``, built on
    ``x``'s device in the forward when ``x`` needs a gradient.

    CPU tensors take :func:`nei_gather_reference` and
    :func:`nei_sum_reference`; CUDA tensors launch ``nei_gather_kernel``
    and ``nei_sum_kernel``, counted in ``nei_gather.launches`` and
    ``nei_gather.backward_launches``.
    """
    return _NeiGather.apply(x, table, rev_slot, deg)


def nei_max_incl_self(h: torch.Tensor, table: torch.Tensor,
                      deg: torch.Tensor, return_winner: bool = False):
    """K2: the elementwise max over a node and its real neighbours
    (Duvenaud GraphPool).  With ``return_winner`` also the node each max
    came from, ``[N, F]`` int32: self wins a tie, then the lowest slot.
    Differentiable in ``h``: the cotangent of each max flows to its winner,
    gathered through the table.

    CPU tensors take :func:`nei_max_reference` and
    :func:`nei_max_backward_reference`; CUDA tensors launch
    ``nei_max_fwd_kernel`` and ``nei_max_bwd_kernel``, counted in
    ``nei_max_incl_self.launches`` and ``.backward_launches``.
    """
    out, winner = _NeiMax.apply(h, table, deg)
    return (out, winner) if return_winner else out


nei_sum.launches = nei_sum.backward_launches = 0
nei_sum_edges.launches = 0
nei_gather.launches = nei_gather.backward_launches = 0
take_src.backward_launches = 0
nei_max_incl_self.launches = nei_max_incl_self.backward_launches = 0
