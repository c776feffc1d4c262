"""Graph layers of GraphConvModel, MPNNModel, GCNModel, GATModel and
AttentiveFPModel over the padded batch layout, and of WeaveModel and
DTNNModel over dense per-molecule blocks.

Counterparts of ``deepchem_tpu/models/graph_layers.py``'s
``MaskedBatchNorm``, ``GraphConv``, ``graph_pool_max``, ``GraphGather``,
``GCNLayer``, ``GATLayer``, ``AttentiveFPLayer``, ``EdgeNetworkMPNN``,
``SetGather``, ``WeaveLayer``, ``WeaveGather``, ``DTNNEmbedding`` and
``DTNNStep`` (the last four on cuBLAS and elementwise ops), and of flax's ``Dense``, ``GRUCell`` and
``OptimizedLSTMCell`` as those layers use them.  On the table paths the
aggregations are the kernels K1 (:func:`nei_sum`, :func:`nei_sum_edges`,
:func:`take_src`'s backward, :func:`nei_gather`'s backward), K2
(:func:`nei_max_incl_self`), K3, K4 (:func:`nei_gather`), P1 and P3
(:func:`graph_pool`, :func:`segment_softmax_sorted`,
:func:`csr_segment_sum`).  Each layer also has the JAX package's COO
branch (edge lists and their CSR, no table), on ``ops/coo.py``:
``GraphConv`` and ``GCNLayer`` sum the neighbours with P2
(:func:`gather_neighbors_sum`, P2 both ways); ``graph_pool_max`` takes
the neighbour max with K3 (:func:`gather_neighbors_max`: a source gather
whose backward is P2, then K3 forward and backward); ``GATLayer`` and
``AttentiveFPLayer`` softmax their edge logits with P1
(:func:`dst_segment_softmax`, P3 in its backward), gather node rows by
edge end with :func:`gather_src` and :func:`gather_dst` (P2 in the
backward) and sum the weighted messages with P2
(:func:`dst_segment_sum`); ``EdgeNetworkMPNN`` gathers the sources with
:func:`gather_src` and sums the messages with P2.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepchem_tpu_torch.ops.coo import (dst_segment_softmax, dst_segment_sum,
                                        gather_dst, gather_neighbors_max,
                                        gather_neighbors_sum, gather_src)
from deepchem_tpu_torch.ops.csr_segment import csr_row_ptr, csr_segment_sum
from deepchem_tpu_torch.ops.nei_table import (nei_gather, nei_max_incl_self,
                                              nei_sum, nei_sum_edges,
                                              slot_mask, take_src)
from deepchem_tpu_torch.ops.segment import (NEG, gather_graph_rows,
                                            gather_table_rows, graph_pool,
                                            segment_softmax_sorted)


def lecun_normal_(t: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  scale: float = 1.0) -> torch.Tensor:
    """Fill a weight ``[out, in]`` as flax's ``lecun_normal`` fills its
    kernel: a normal truncated at two standard deviations with variance
    ``1 / in``; with ``scale``, flax's ``variance_scaling(scale, 'fan_in',
    'truncated_normal')`` (variance ``scale / in``)."""
    # std of the truncated normal is 0.8796 of its parent's; flax rescales
    std = (scale / t.shape[1]) ** 0.5 / .87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                     generator=generator)


def dense(in_features: int, out_features: int,
          generator: Optional[torch.Generator] = None,
          bias: bool = True) -> nn.Linear:
    """``nn.Linear`` initialised as flax's ``Dense``: the weight
    :func:`lecun_normal_`, the bias zero."""
    layer = nn.Linear(in_features, out_features, bias=bias)
    lecun_normal_(layer.weight, generator)
    if bias:
        with torch.no_grad():
            layer.bias.zero_()
    return layer


def _gate_weights(gates: int, in_features: int, features: int,
                  recurrent: bool,
                  generator: Optional[torch.Generator]) -> nn.Parameter:
    """``[gates * features, in_features]``: each gate's block initialised
    as flax initialises that gate's kernel, orthogonal for a recurrent
    one, else :func:`lecun_normal_`."""
    w = torch.empty(gates * features, in_features)
    for b in w.split(features):
        if recurrent:
            with torch.no_grad():
                nn.init.orthogonal_(b, generator=generator)
        else:
            lecun_normal_(b, generator)
    return nn.Parameter(w)


class GRUCell(nn.Module):
    """flax's ``GRUCell``: ``r = sigmoid(W_ir x + b_ir + W_hr h)``, ``z``
    alike, ``n = tanh(W_in x + b_in + r * (W_hn h + b_hn))``, ``h' = (1 -
    z) n + z h``.  Gates r, z, n stacked in ``weight_ih`` and
    ``weight_hh``; the hidden side has only ``bias_hn``, as flax."""

    def __init__(self, in_features: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight_ih = _gate_weights(3, in_features, features, False,
                                       generator)
        self.bias_ih = nn.Parameter(torch.zeros(3 * features))
        self.weight_hh = _gate_weights(3, features, features, True,
                                       generator)
        self.bias_hn = nn.Parameter(torch.zeros(features))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        i_r, i_z, i_n = F.linear(x, self.weight_ih,
                                 self.bias_ih).chunk(3, dim=-1)
        h_r, h_z, h_n = F.linear(h, self.weight_hh).chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * (h_n + self.bias_hn))
        return (1.0 - z) * n + z * h


class LSTMCell(nn.Module):
    """flax's ``OptimizedLSTMCell``: gates i, f, g, o of ``W_i x + W_h h +
    b_h`` (only the hidden side has a bias), ``c' = f c + i g``, ``h' = o
    tanh(c')``.  Takes and returns the carry ``(c, h)`` and ``h'``, as
    flax."""

    def __init__(self, in_features: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight_ih = _gate_weights(4, in_features, features, False,
                                       generator)
        self.weight_hh = _gate_weights(4, features, features, True,
                                       generator)
        self.bias_hh = nn.Parameter(torch.zeros(4 * features))

    def forward(self, carry, x: torch.Tensor):
        c, h = carry
        gates = F.linear(h, self.weight_hh, self.bias_hh) \
            + F.linear(x, self.weight_ih)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (c, h), h


def glorot_uniform_(t: torch.Tensor,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """Fill ``t`` as flax's ``glorot_uniform`` does: uniform on
    ``±sqrt(6 / (fan_in + fan_out))`` with the last axis the output, the
    one before it the input and every leading axis the receptive field,
    so ``[D, F, O]`` has ``fan_in = D·F`` and ``fan_out = D·O``."""
    receptive = math.prod(t.shape[:-2])
    fan_in, fan_out = t.shape[-2] * receptive, t.shape[-1] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return t.uniform_(-limit, limit, generator=generator)


class MaskedBatchNorm(nn.Module):
    """Batch normalisation over the valid (mask 1) rows, with no running
    state: the batch's statistics in training and in evaluation alike, so
    a request's outputs depend on the molecules in it.  ``eps`` 1e-3."""

    def __init__(self, num_features: int, epsilon: float = 1e-3):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if mask is None:
            mean = x.mean(dim=0)
            var = x.var(dim=0, unbiased=False)
        else:
            m = mask[:, None]
            count = torch.clamp_min(m.sum(), 1.0)
            mean = (x * m).sum(dim=0) / count
            var = ((x - mean) ** 2 * m).sum(dim=0) / count
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return y * self.scale + self.bias


class GraphConv(nn.Module):
    """Duvenaud graph convolution with a weight per degree:
    ``out_i = W_self[d_i] h_i + W_nbr[d_i] sum_j h_j + b[d_i]``, the degree
    clipped to ``max_degree``.  Every degree branch is computed densely
    (``[D, N, O]``) and a one-hot selects each node's, as the JAX layer
    does; the neighbour sum is K1 over ``table``, or with no table P2
    (:func:`gather_neighbors_sum`) over ``coo``, the batch's
    ``(edge_src, edge_dst, edge_mask, csr)``."""

    def __init__(self, in_features: int, out_channels: int,
                 max_degree: int = 10,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.max_degree = max_degree
        d = max_degree + 1
        self.W_self = nn.Parameter(glorot_uniform_(
            torch.empty(d, in_features, out_channels), generator))
        self.W_nbr = nn.Parameter(glorot_uniform_(
            torch.empty(d, in_features, out_channels), generator))
        self.b = nn.Parameter(torch.zeros(d, out_channels))

    def forward(self, h: torch.Tensor, table: Optional[torch.Tensor],
                deg: torch.Tensor, coo: Optional[tuple] = None
                ) -> torch.Tensor:
        msgs = nei_sum(h, table, deg) if table is not None \
            else gather_neighbors_sum(h, *coo)
        onehot = F.one_hot(deg.long().clamp(0, self.max_degree),
                           self.max_degree + 1).to(h.dtype)      # [N, D]
        self_all = torch.einsum('nf,dfo->dno', h, self.W_self)
        nbr_all = torch.einsum('nf,dfo->dno', msgs, self.W_nbr)
        out = torch.einsum('dno,nd->no', self_all + nbr_all, onehot)
        return out + onehot @ self.b


def graph_pool_max(h: torch.Tensor, table: Optional[torch.Tensor],
                   deg: torch.Tensor, coo: Optional[tuple] = None
                   ) -> torch.Tensor:
    """GraphPool: the elementwise max over a node and its neighbours: K2
    over ``table``, or with no table ``max(h, gather_neighbors_max)`` over
    ``coo`` (``(edge_src, edge_dst, edge_mask, csr)``; K3, with 0 for a
    node with no neighbour, as the JAX package's COO branch gives it)."""
    if table is not None:
        return nei_max_incl_self(h, table, deg)
    esrc, _, emask, csr = coo
    return torch.maximum(h, gather_neighbors_max(h, esrc, emask, csr))


class GraphGather(nn.Module):
    """Graph-level readout: ``concat[tanh(sum), tanh(max)]`` over each
    graph's valid nodes, P3 for the sum and K3 for the max."""

    def forward(self, h: torch.Tensor, graph_index: torch.Tensor,
                node_mask: torch.Tensor, num_graphs: int) -> torch.Tensor:
        s = graph_pool(h, graph_index, num_graphs, node_mask, 'sum')
        m = graph_pool(h, graph_index, num_graphs, node_mask, 'max')
        return torch.cat([torch.tanh(s), torch.tanh(m)], dim=1)


class GCNLayer(nn.Module):
    """Kipf-Welling graph convolution with symmetric normalisation: with
    ``norm = rsqrt(max(deg, 1))``, ``agg = norm * Σ_neighbours(h * norm)``,
    then ``Dense(agg) + Dense_no_bias(h)``, plus a residual
    ``Dense_no_bias(h)``, then ReLU.  The neighbour sum is K1
    (:func:`nei_sum`) over the neighbour ``table``, or, with no table, P2
    (:func:`gather_neighbors_sum`) over ``coo``, the batch's ``(edge_src,
    edge_dst, edge_mask, csr)``."""

    #: flax scope -> attribute (models/convert.py)
    flax_scopes = {'Dense_0': 'agg', 'Dense_1': 'self_loop',
                   'Dense_2': 'res'}

    def __init__(self, in_features: int, out_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.agg = dense(in_features, out_channels, generator)
        self.self_loop = dense(in_features, out_channels, generator,
                               bias=False)
        self.res = dense(in_features, out_channels, generator, bias=False)

    def forward(self, h: torch.Tensor, table: Optional[torch.Tensor],
                deg: torch.Tensor, coo: Optional[tuple] = None
                ) -> torch.Tensor:
        norm = torch.rsqrt(torch.clamp_min(deg.to(h.dtype), 1.0))[:, None]
        if table is not None:
            agg = nei_sum(h * norm, table, deg)
        else:
            agg = gather_neighbors_sum(h * norm, *coo)
        agg = agg * norm
        return F.relu(self.agg(agg) + self.self_loop(h) + self.res(h))


def _slot_softmax(logits: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """Softmax over the K slots (dim 1) with pad slots' logits at ``NEG``,
    times the slot mask: a node with no real slot gets 0 everywhere.
    ``real`` ``[N, K]`` bool, broadcast over the logits' trailing axes."""
    real = real.reshape(real.shape + (1,) * (logits.ndim - 2))
    att = torch.softmax(logits.masked_fill(~real, NEG), dim=1)
    return att * real.to(logits.dtype)


class GATLayer(nn.Module):
    """Multi-head graph attention over the neighbour slots: ``z =
    Dense_no_bias(h)`` ``[N, H, O]``, per-head logits ``LeakyReLU(a_src .
    z[t] + a_dst . z[i], 0.2)`` for each slot's neighbour ``t`` (K4 of
    ``a_src . z``), a softmax over the slots, and the weighted sum of the
    neighbours' ``z`` (K4 of ``z``), flattened to ``[N, H * O]``.  With
    no table, the COO branch over ``coo``: edge logits ``e_src[src] +
    e_dst[dst]``, P1 over each destination's edges, P2 of ``z[src] *
    att``."""

    #: flax scope -> attribute (models/convert.py)
    flax_scopes = {'Dense_0': 'W'}

    def __init__(self, in_features: int, out_channels: int,
                 n_heads: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_heads, self.out_channels = n_heads, out_channels
        self.W = dense(in_features, n_heads * out_channels, generator,
                       bias=False)
        self.a_src = nn.Parameter(glorot_uniform_(
            torch.empty(n_heads, out_channels), generator))
        self.a_dst = nn.Parameter(glorot_uniform_(
            torch.empty(n_heads, out_channels), generator))

    def forward(self, h: torch.Tensor, table: Optional[torch.Tensor],
                deg: torch.Tensor, rev_slot: Optional[torch.Tensor],
                coo: Optional[tuple] = None) -> torch.Tensor:
        n, H, O = h.shape[0], self.n_heads, self.out_channels
        z = self.W(h).reshape(n, H, O)
        e_src = torch.einsum('nho,ho->nh', z, self.a_src)
        e_dst = torch.einsum('nho,ho->nh', z, self.a_dst)
        if table is None:
            esrc, edst, emask, csr = coo
            logits = F.leaky_relu(gather_src(e_src, esrc, csr)
                                  + gather_dst(e_dst, edst, csr), 0.2)
            att = dst_segment_softmax(logits, emask, csr)        # [E, H]
            msgs = gather_src(z, esrc, csr) * att[:, :, None]
            return dst_segment_sum(msgs, edst, csr).reshape(n, H * O)
        es = nei_gather(e_src, table, rev_slot, deg)              # [N, K, H]
        logits = F.leaky_relu(es + e_dst[:, None, :], 0.2)
        att = _slot_softmax(logits, slot_mask(table, deg))
        zg = nei_gather(z, table, rev_slot, deg)               # [N, K, H, O]
        return torch.einsum('nkh,nkho->nho', att, zg).reshape(n, H * O)


class AttentiveFPLayer(nn.Module):
    """AttentiveFP's graph attention with a GRU update over the neighbour
    slots: ``z = Dense(h)``, slot logits ``Dense_1(LeakyReLU(Dense(
    [z_i ; z_t])))`` (flax's slope 0.01) for each slot's neighbour ``t``
    (K4 of ``z``), a softmax over the slots, the weighted sum of the
    neighbours' ``msg_proj(z)`` (K4), ELU, and :class:`GRUCell` with carry
    ``z`` and input that context.  With no table, the COO branch over
    ``coo``: edge logits of ``[z_dst ; z_src]``, P1 over each
    destination's edges, P2 of ``msg_proj(z)[src] * att``."""

    #: flax scope -> attribute (models/convert.py)
    flax_scopes = {'Dense_0': 'z', 'Dense_1': 'att_h', 'Dense_2': 'att_out',
                   'Dense_3': 'msg_proj', 'GRUCell_0': 'gru'}

    def __init__(self, in_features: int, out_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.z = dense(in_features, out_channels, generator)
        self.att_h = dense(2 * out_channels, out_channels, generator)
        self.att_out = dense(out_channels, 1, generator)
        self.msg_proj = dense(out_channels, out_channels, generator)
        self.gru = GRUCell(out_channels, out_channels, generator)

    def forward(self, h: torch.Tensor, table: Optional[torch.Tensor],
                deg: torch.Tensor, rev_slot: Optional[torch.Tensor],
                coo: Optional[tuple] = None) -> torch.Tensor:
        z = self.z(h)
        if table is None:
            esrc, edst, emask, csr = coo
            cat = torch.cat([gather_dst(z, edst, csr),
                             gather_src(z, esrc, csr)], dim=1)
            logits = self.att_out(F.leaky_relu(self.att_h(cat), 0.01))[:, 0]
            att = dst_segment_softmax(logits, emask, csr)
            msgs = gather_src(self.msg_proj(z), esrc, csr)
            context = F.elu(dst_segment_sum(msgs * att[:, None], edst, csr))
            return self.gru(z, context)
        zs = nei_gather(z, table, rev_slot, deg)                  # [N, K, O]
        cat = torch.cat([z[:, None, :].expand_as(zs), zs], dim=-1)
        logits = self.att_out(F.leaky_relu(self.att_h(cat), 0.01))[..., 0]
        att = _slot_softmax(logits, slot_mask(table, deg))
        msgs = nei_gather(self.msg_proj(z), table, rev_slot, deg)
        context = F.elu(torch.einsum('nk,nko->no', att, msgs))
        return self.gru(z, context)


class EdgeNetworkMPNN(nn.Module):
    """Gilmer MPNN's message phase: a dense embedding of the atoms to
    ``node_dim`` D, a ``[D, D]`` message matrix from each edge's features
    (``Dense(D * D)``, row-major), then ``n_steps`` rounds of: each edge's
    source state (:func:`take_src`) times its matrix, masked, summed into
    its destination (:func:`nei_sum_edges`, K1), and a GRU update of the
    node states.  With no tables, the COO branch over the batch's ``csr``:
    :func:`gather_src` and :func:`dst_segment_sum` (P2)."""

    #: flax scope -> attribute (models/convert.py)
    flax_scopes = {'Dense_0': 'node_dense', 'Dense_1': 'edge_dense',
                   'GRUCell_0': 'gru'}

    def __init__(self, node_features: int, edge_features: int,
                 node_dim: int, n_steps: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.node_dim, self.n_steps = node_dim, n_steps
        self.node_dense = dense(node_features, node_dim, generator)
        self.edge_dense = dense(edge_features, node_dim * node_dim,
                                generator)
        self.gru = GRUCell(node_dim, node_dim, generator)

    def forward(self, h, esrc, edst, ef, emask, e_table=None, e_deg=None,
                o_table=None, o_deg=None, csr=None):
        D = self.node_dim
        carry = self.node_dense(h)
        A = self.edge_dense(ef).reshape(-1, D, D)
        for _ in range(self.n_steps):
            if e_table is None:
                src_h = gather_src(carry, esrc, csr)
            else:
                src_h = take_src(carry, esrc, o_table, o_deg)
            msg = torch.bmm(A, src_h[:, :, None])[:, :, 0] * emask[:, None]
            agg = nei_sum_edges(msg, e_table, e_deg, edst, emask) \
                if e_table is not None else dst_segment_sum(msg, edst, csr)
            carry = self.gru(carry, agg)
        return carry


class SetGather(nn.Module):
    """set2set readout: ``n_steps`` rounds of an LSTM over ``q* = [q ;
    r]``, each node's attention to its graph's query ``q`` (a softmax
    over the graph's valid nodes, P1; the query gathered for each node by
    :func:`gather_graph_rows`, P3 in the backward) and the
    attention-weighted sum of the graph's nodes ``r`` (P3).  Returns
    ``[num_graphs, 2 * node_dim]``.  ``graph_index`` must be
    non-decreasing, the ghost graph
    ``num_graphs`` last, as the packer lays it out."""

    #: flax scope -> attribute (models/convert.py)
    flax_scopes = {'OptimizedLSTMCell_0': 'lstm', 'Dense_0': 'W_q'}

    def __init__(self, node_dim: int, n_steps: int = 6,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.node_dim, self.n_steps = node_dim, n_steps
        self.lstm = LSTMCell(2 * node_dim, node_dim, generator)
        self.W_q = dense(node_dim, node_dim, generator, bias=False)

    def forward(self, h: torch.Tensor, graph_index: torch.Tensor,
                node_mask: torch.Tensor, num_graphs: int) -> torch.Tensor:
        B, D = num_graphs, self.node_dim
        row_ptr = csr_row_ptr(graph_index, B + 1)       # one for all steps
        graph = graph_index.long().clamp(max=B)
        hq = self.W_q(h)
        q_star = h.new_zeros((B, 2 * D))
        carry = (h.new_zeros((B, D)), h.new_zeros((B, D)))
        for _ in range(self.n_steps):
            carry, q = self.lstm(carry, q_star)
            # the ghost graph's query is 0
            q_nodes = gather_graph_rows(F.pad(q, (0, 0, 0, 1)), graph,
                                        row_ptr)
            a = segment_softmax_sorted((hq * q_nodes).sum(dim=1), graph_index,
                                       B + 1, mask=node_mask,
                                       row_ptr=row_ptr)
            # the real graphs' segments only: the ghost's are dropped
            r = csr_segment_sum(h * a[:, None], row_ptr[:B + 1])
            q_star = torch.cat([q, r], dim=1)
        return q_star


class WeaveLayer(nn.Module):
    """Weave's atom and pair co-update on the dense grid: atoms ``[B, A,
    F]``, pairs ``[B, A, A, P]``, ``pair_mask`` ``[B, A, A]``.

    The atoms' update is ``relu(Dense([relu(Dense(a)) ; Σ_j relu(Dense(p_ij))
    m_ij]))``; with ``update_pair`` the pairs' is ``relu(Dense([relu(Dense([a_i
    ; a_j])) ; relu(Dense(p_ij))]))``, else the pairs pass through.  The
    product of ``[a_i ; a_j]`` is taken as ``a W_i`` ``[B, A, 1, H]`` plus
    ``a W_j`` ``[B, 1, A, H]``, the weight split over the two halves,
    so no ``[B, A, A, 2F]`` tensor is made."""

    def __init__(self, atom_features: int, pair_features: int,
                 n_atom_out: int = 50, n_pair_out: int = 50,
                 n_hidden: int = 50, update_pair: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.update_pair = update_pair
        self.atom_hidden = dense(atom_features, n_hidden, generator)
        self.pair_hidden = dense(pair_features, n_hidden, generator)
        self.atom_out = dense(2 * n_hidden, n_atom_out, generator)
        # flax creates the pair update's Dense_3-Dense_5 only when it runs
        self.flax_scopes = {'Dense_0': 'atom_hidden', 'Dense_1': 'pair_hidden',
                            'Dense_2': 'atom_out'}
        if update_pair:
            self.atom_pair = dense(2 * atom_features, n_hidden, generator)
            self.pair_pair = dense(pair_features, n_hidden, generator)
            self.pair_out = dense(2 * n_hidden, n_pair_out, generator)
            self.flax_scopes.update({'Dense_3': 'atom_pair',
                                     'Dense_4': 'pair_pair',
                                     'Dense_5': 'pair_out'})

    def forward(self, atoms: torch.Tensor, pairs: torch.Tensor,
                pair_mask: torch.Tensor):
        aa = F.relu(self.atom_hidden(atoms))
        pa = F.relu(self.pair_hidden(pairs))
        pa_sum = torch.sum(pa * pair_mask[..., None], dim=2)
        a_out = F.relu(self.atom_out(torch.cat([aa, pa_sum], dim=-1)))
        if not self.update_pair:
            return a_out, pairs
        w_i, w_j = self.atom_pair.weight.chunk(2, dim=1)
        ap = F.relu(F.linear(atoms, w_i, self.atom_pair.bias)[:, :, None]
                    + F.linear(atoms, w_j)[:, None])
        pp = F.relu(self.pair_pair(pairs))
        p_out = F.relu(self.pair_out(torch.cat([ap, pp], dim=-1)))
        return a_out, p_out


class WeaveGather(nn.Module):
    """Weave's readout: atoms ``[B, A, F]`` summed over the atoms that
    ``atom_mask`` ``[B, A]`` keeps.  With ``gaussian_expand`` each
    feature first becomes its memberships in 11 Gaussians (fixed means
    and deviations), normalised to sum to 1 (the divisor at least 1e-9),
    so the sum is ``[B, 11 F]``, and ``tanh(Dense)`` takes it back to
    ``[B, F]``."""

    MEANS = (-1.645, -1.080, -0.739, -0.468, -0.228, 0.0, 0.228, 0.468,
             0.739, 1.080, 1.645)
    STDS = (0.283, 0.170, 0.134, 0.118, 0.114, 0.114, 0.114, 0.118,
            0.134, 0.170, 0.283)
    flax_scopes = {'Dense_0': 'dense'}

    def __init__(self, features: int, gaussian_expand: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.gaussian_expand = gaussian_expand
        self.register_buffer('means', torch.tensor(self.MEANS),
                             persistent=False)
        self.register_buffer('stds', torch.tensor(self.STDS),
                             persistent=False)
        self.dense = dense(len(self.MEANS) * features, features, generator) \
            if gaussian_expand else None

    def forward(self, atoms: torch.Tensor,
                atom_mask: torch.Tensor) -> torch.Tensor:
        x = atoms
        if self.gaussian_expand:
            d = (x[..., None] - self.means) / self.stds
            membership = torch.exp(-0.5 * d * d)
            membership = membership / torch.clamp_min(
                membership.sum(-1, keepdim=True), 1e-9)
            x = membership.reshape(x.shape[:-1] + (-1,))
        out = torch.sum(x * atom_mask[..., None], dim=1)
        if self.gaussian_expand:
            out = torch.tanh(self.dense(out))
        return out


class DTNNEmbedding(nn.Module):
    """An embedding of atomic numbers 0 to ``periodic_table_length - 1``,
    initialised as flax's ``truncated_normal(1 / sqrt(n_embedding))``;
    its gradient is :func:`gather_table_rows`' (P2 over the lookups by
    atomic number)."""

    flax_leaves = {'embeddings': 'embeddings'}

    def __init__(self, n_embedding: int = 30,
                 periodic_table_length: int = 83,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        std = 1.0 / math.sqrt(n_embedding)
        self.embeddings = nn.Parameter(torch.empty(periodic_table_length,
                                                   n_embedding))
        with torch.no_grad():
            nn.init.trunc_normal_(self.embeddings, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)

    def forward(self, atomic_numbers: torch.Tensor) -> torch.Tensor:
        # the backward sums each element's rows by P2 in a fixed order,
        # not by index_add_'s float atomics nor by the sort-based kernel
        # of advanced indexing (a third of DTNN's card time a step)
        return gather_table_rows(self.embeddings, atomic_numbers)


class DTNNStep(nn.Module):
    """One DTNN interaction pass: ``emb + W_cf Σ_j tanh(W_fc(emb_j) *
    W_df(d_ij)) m_j`` over atoms ``[B, A, E]``, distance features ``[B,
    A, A, Dd]`` and the atom mask ``[B, A]``.  flax numbers the three
    Dense scopes as they are built: ``W_cf``, ``W_df``, ``W_fc``."""

    flax_scopes = {'Dense_0': 'W_cf', 'Dense_1': 'W_df', 'Dense_2': 'W_fc'}

    def __init__(self, n_embedding: int = 30, n_distance: int = 100,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.W_cf = dense(n_embedding, n_embedding, generator, bias=False)
        self.W_df = dense(n_distance, n_embedding, generator, bias=False)
        self.W_fc = dense(n_embedding, n_embedding, generator)

    def forward(self, atom_emb: torch.Tensor, dist_feats: torch.Tensor,
                atom_mask: torch.Tensor) -> torch.Tensor:
        a = self.W_fc(atom_emb)
        d = self.W_df(dist_feats)
        msg = torch.tanh(a[:, None] * d) * atom_mask[:, None, :, None]
        return atom_emb + self.W_cf(torch.sum(msg, dim=2))


class EGNNLayer(nn.Module):
    """An E(n)-equivariant graph layer (Satorras et al. 2021) on the padded
    COO batch: messages ``m_ij = silu(Dense(silu(Dense([h_i ; h_j ; |x_i
    - x_j|^2 ; e_ij]))))`` times the edge mask over the edges ``j -> i``,
    ``h_i' = h_i + Dense(silu(Dense([h_i ; Σ_j m_ij])))``, and with
    ``update_coords`` ``x_i' = x_i + Σ_j (x_j - x_i) w(m_ij) / max(deg_i,
    1)`` (``w`` a bias-free ``Dense`` of ``m`` drawn at variance ``1e-3 /
    hidden_dim``; ``deg`` the masked in-degree).  Its three sums over the
    destinations (the messages, the degrees, the coordinate update) are P2
    (:func:`dst_segment_sum`), its gathers of ``h`` and ``x`` by an edge's
    ends :func:`gather_src` and :func:`gather_dst` (P2 in the backward).
    Takes ``(h, x, esrc, edst, emask, csr, ef=None)`` and returns ``(h',
    x')``.  flax builds each MLP's outer layer first: ``Dense_0`` and
    ``Dense_1`` are the message MLP's outer and inner layers,
    ``Dense_2`` and ``Dense_3`` the update's, ``Dense_4`` the coordinate
    weight."""

    flax_scopes = {'Dense_0': 'msg.second', 'Dense_1': 'msg.first',
                   'Dense_2': 'update.second', 'Dense_3': 'update.first',
                   'Dense_4': 'coord'}

    def __init__(self, in_features: int, hidden_dim: int,
                 update_coords: bool = True, edge_features: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.update_coords = update_coords
        self.msg = nn.ModuleDict({
            'first': dense(2 * in_features + 1 + edge_features, hidden_dim,
                           generator),
            'second': dense(hidden_dim, hidden_dim, generator)})
        self.update = nn.ModuleDict({
            'first': dense(in_features + hidden_dim, hidden_dim, generator),
            'second': dense(hidden_dim, in_features, generator)})
        if update_coords:
            self.coord = nn.Linear(hidden_dim, 1, bias=False)
            lecun_normal_(self.coord.weight, generator, scale=1e-3)

    def forward(self, h, x, esrc, edst, emask, csr, ef=None):
        diff = gather_dst(x, edst, csr) - gather_src(x, esrc, csr)
        d2 = torch.sum(diff * diff, dim=-1, keepdim=True)
        z = [gather_dst(h, edst, csr), gather_src(h, esrc, csr), d2]
        if ef is not None:
            z.append(ef)
        m = F.silu(self.msg['second'](F.silu(self.msg['first'](
            torch.cat(z, dim=-1)))))
        m = m * emask[:, None]
        agg = dst_segment_sum(m, edst, csr)
        h_new = h + self.update['second'](F.silu(self.update['first'](
            torch.cat([h, agg], dim=-1))))
        if not self.update_coords:
            return h_new, x
        w = self.coord(m)
        deg = dst_segment_sum(emask[:, None], edst, csr)
        dx = dst_segment_sum(-diff * w, edst, csr) / torch.clamp_min(
            deg, 1.0)
        return h_new, x + dx
