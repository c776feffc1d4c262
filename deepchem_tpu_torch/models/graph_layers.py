"""Graph layers of GraphConvModel over the padded batch layout.

Counterparts of ``deepchem_tpu/models/graph_layers.py``'s
``MaskedBatchNorm``, ``GraphConv``, ``graph_pool_max`` and
``GraphGather``, on the neighbour-table path: the aggregations are the
kernels K1 (:func:`nei_sum`), K2 (:func:`nei_max_incl_self`), K3 and P3
(:func:`graph_pool`).  The JAX package's COO path for these layers (edge
lists, no table) is not ported.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepchem_tpu_torch.ops.nei_table import nei_max_incl_self, nei_sum
from deepchem_tpu_torch.ops.segment import graph_pool


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
