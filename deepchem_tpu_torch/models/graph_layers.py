"""Graph layers of GraphConvModel, MPNNModel, GCNModel, GATModel and
AttentiveFPModel over the padded batch layout.

Counterparts of ``deepchem_tpu/models/graph_layers.py``'s
``MaskedBatchNorm``, ``GraphConv``, ``graph_pool_max``, ``GraphGather``,
``GCNLayer``, ``GATLayer``, ``AttentiveFPLayer``, ``EdgeNetworkMPNN`` and
``SetGather``, and of flax's ``Dense``, ``GRUCell`` and
``OptimizedLSTMCell`` as those layers use them, on the table paths: the
aggregations are the kernels K1 (:func:`nei_sum`, :func:`nei_sum_edges`,
:func:`take_src`'s backward, :func:`nei_gather`'s backward), K2
(:func:`nei_max_incl_self`), K3, K4 (:func:`nei_gather`), P1 and P3
(:func:`graph_pool`, :func:`segment_softmax_sorted`,
:func:`csr_segment_sum`), and ``GCNLayer``'s COO branch (edge lists, no
table) P2 (:func:`gather_neighbors_sum`).  The COO branches of the other
layers are not ported.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepchem_tpu_torch.ops.coo import gather_neighbors_sum
from deepchem_tpu_torch.ops.csr_segment import csr_row_ptr, csr_segment_sum
from deepchem_tpu_torch.ops.nei_table import (nei_gather, nei_max_incl_self,
                                              nei_sum, nei_sum_edges,
                                              slot_mask, take_src)
from deepchem_tpu_torch.ops.segment import (NEG, graph_pool,
                                            segment_softmax_sorted)


def lecun_normal_(t: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Fill a weight ``[out, in]`` as flax's ``lecun_normal`` fills its
    kernel: a normal truncated at two standard deviations with variance
    ``1 / in``."""
    # std of the truncated normal is 0.8796 of its parent's; flax rescales
    std = (1.0 / t.shape[1]) ** 0.5 / .87962566103423978
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
    does; the neighbour sum is K1."""

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

    def forward(self, h: torch.Tensor, table: torch.Tensor,
                deg: torch.Tensor) -> torch.Tensor:
        msgs = nei_sum(h, table, deg)
        onehot = F.one_hot(deg.long().clamp(0, self.max_degree),
                           self.max_degree + 1).to(h.dtype)      # [N, D]
        self_all = torch.einsum('nf,dfo->dno', h, self.W_self)
        nbr_all = torch.einsum('nf,dfo->dno', msgs, self.W_nbr)
        out = torch.einsum('dno,nd->no', self_all + nbr_all, onehot)
        return out + onehot @ self.b


def graph_pool_max(h: torch.Tensor, table: torch.Tensor,
                   deg: torch.Tensor) -> torch.Tensor:
    """GraphPool: the elementwise max over a node and its neighbours
    (K2)."""
    return nei_max_incl_self(h, table, deg)


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
    neighbours' ``z`` (K4 of ``z``), flattened to ``[N, H * O]``."""

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

    def forward(self, h: torch.Tensor, table: torch.Tensor,
                deg: torch.Tensor, rev_slot: torch.Tensor) -> torch.Tensor:
        n, H, O = h.shape[0], self.n_heads, self.out_channels
        z = self.W(h).reshape(n, H, O)
        e_src = torch.einsum('nho,ho->nh', z, self.a_src)
        e_dst = torch.einsum('nho,ho->nh', z, self.a_dst)
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
    ``z`` and input that context."""

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

    def forward(self, h: torch.Tensor, table: torch.Tensor,
                deg: torch.Tensor, rev_slot: torch.Tensor) -> torch.Tensor:
        z = self.z(h)
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
    node states."""

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

    def forward(self, h, esrc, edst, ef, emask, e_table, e_deg, o_table,
                o_deg):
        D = self.node_dim
        carry = self.node_dense(h)
        A = self.edge_dense(ef).reshape(-1, D, D)
        for _ in range(self.n_steps):
            src_h = take_src(carry, esrc, o_table, o_deg)
            msg = torch.bmm(A, src_h[:, :, None])[:, :, 0] * emask[:, None]
            agg = nei_sum_edges(msg, e_table, e_deg, edst, emask)
            carry = self.gru(carry, agg)
        return carry


class SetGather(nn.Module):
    """set2set readout: ``n_steps`` rounds of an LSTM over ``q* = [q ;
    r]``, each node's attention to its graph's query ``q`` (a softmax
    over the graph's valid nodes, P1) and the attention-weighted sum of
    the graph's nodes ``r`` (P3).  Returns ``[num_graphs, 2 * node_dim]``.
    ``graph_index`` must be non-decreasing, the ghost graph
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
            q_nodes = F.pad(q, (0, 0, 0, 1)).index_select(0, graph)
            a = segment_softmax_sorted((hq * q_nodes).sum(dim=1), graph_index,
                                       B + 1, mask=node_mask,
                                       row_ptr=row_ptr)
            # the real graphs' segments only: the ghost's are dropped
            r = csr_segment_sum(h * a[:, None], row_ptr[:B + 1])
            q_star = torch.cat([q, r], dim=1)
        return q_star
