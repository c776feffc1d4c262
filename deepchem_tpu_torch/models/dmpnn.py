"""Directed MPNN (Chemprop's D-MPNN) on the incoming-edge-id table.

Counterparts of ``deepchem_tpu/models/dmpnn.py``'s ``_DMPNNModule`` and
``DMPNNModel`` on the table path (``uses_edge_table = True``).  The
featurizer (:class:`DMPNNFeaturizer`) writes each bond as two adjacent
directed edges, so the reverse of edge ``e`` is ``e ^ 1``, and the packer
keeps that order (the edges are not sorted by destination).  With
``uses_edge_table`` set to False on the class, the module takes the JAX
package's COO branch: the batch's CSR in the table's place, each sum of
edge states into their destinations P2 (:func:`dst_segment_sum`), the
gather of those sums by source :func:`gather_src` (P2 in its backward)
and the reverse edges' gather a permutation (a gather both ways).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepchem_tpu_torch.models.graph_layers import dense
from deepchem_tpu_torch.models.graph_models import (GraphModel,
                                                    _SeededDropout, _heads,
                                                    _gnn_loss_outputs)
from deepchem_tpu_torch.models.optimizers import Optimizer
from deepchem_tpu_torch.ops import (N_CSR, CooCsr, dst_segment_sum,
                                    gather_src, graph_pool, nei_sum_edges,
                                    permute_rows, take_src)


class _DMPNNModule(_SeededDropout):
    """Chemprop's encoder and FFN: directed-edge states ``h0 =
    ReLU(W_i [x_src ; e])``; ``depth - 1`` rounds of ``h = ReLU(h0 + W_h
    (in[src(e)] - h[e ^ 1]))``, where ``in`` sums each node's incoming
    edge states (:func:`nei_sum_edges`, K1 over the incoming-edge-id
    table), gathered by source with :func:`take_src` (K1 in its backward,
    over the outgoing-edge table ``e_table ^ 1``), the reverse edges'
    rows a permutation (a gather both ways); node states ``ReLU(W_o [x ; in])``; a sum readout (P3);
    ``ffn_layers`` dense layers with ReLU; the task heads.  Dropout after
    each round and each FFN layer.  Parameters are initialised as flax
    initialises the JAX module, from ``generator``."""

    def __init__(self, n_tasks: int, n_classes: int, mode: str,
                 num_graphs: int, node_features: int = 133,
                 edge_features: int = 14, enc_hidden: int = 300,
                 depth: int = 3, ffn_hidden: int = 300, ffn_layers: int = 3,
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 dropout_seed: int = 0):
        super().__init__()
        self.n_tasks, self.n_classes, self.mode = n_tasks, n_classes, mode
        self.num_graphs, self.depth = num_graphs, depth
        self.node_features, self.edge_features = node_features, edge_features
        self.dropout, self.dropout_seed = dropout, dropout_seed
        D = enc_hidden
        self.W_i = dense(node_features + edge_features, D, generator,
                         bias=False)
        # flax creates W_h's parameters only where a round calls it
        self.W_h = dense(D, D, generator, bias=False) if depth > 1 else None
        self.W_o = dense(node_features + D, D, generator)
        widths = [D] + [ffn_hidden] * ffn_layers
        self.ffn = nn.ModuleList(dense(a, b, generator)
                                 for a, b in zip(widths[:-1], widths[1:]))
        n_out = n_tasks * n_classes if mode == 'classification' else n_tasks
        self.head = dense(widths[-1], n_out, generator)
        # flax scope -> attribute (models/convert.py); W_h keeps its scope
        # name Dense_1 even where depth 1 leaves it without parameters
        self.flax_scopes = {
            'Dense_0': 'W_i', 'Dense_1': 'W_h', 'Dense_2': 'W_o',
            **{f'Dense_{3 + i}': f'ffn.{i}' for i in range(ffn_layers)},
            f'Dense_{3 + ffn_layers}': 'head'}

    def forward(self, nf, esrc, edst, gidx, nmask, emask, *rest):
        # the atoms need no gradient: a plain gather
        esrc = esrc.long()
        ef = rest[-1]
        E = ef.shape[0]
        h0 = F.relu(self.W_i(torch.cat([nf.index_select(0, esrc), ef],
                                       dim=1)))
        # the featurizer's (u -> v, v -> u) adjacent pairs
        rev = torch.arange(E, device=ef.device) ^ 1
        if len(rest) == N_CSR + 1:              # the COO branch
            csr = CooCsr(*rest[:-1])

            def edge_to_node(x):
                return dst_segment_sum(x * emask[:, None], edst, csr)

            def message(node_in, x):
                return gather_src(node_in, esrc, csr) \
                    - permute_rows(x, rev, rev)
        else:
            e_table, e_deg = rest[:2]
            # each node's outgoing edges are the reverses of its incoming
            # ones (pad entries 0 become 1, read times 0)
            o_table = torch.bitwise_xor(e_table, 1)

            def edge_to_node(x):
                return nei_sum_edges(x, e_table, e_deg, edst, emask)

            def message(node_in, x):
                return take_src(node_in, esrc, o_table, e_deg) \
                    - permute_rows(x, rev, rev)
        h = h0
        for _ in range(self.depth - 1):
            h = self._dropout(F.relu(h0 + self.W_h(message(edge_to_node(h),
                                                           h))))
        node_in = edge_to_node(h)
        z = F.relu(self.W_o(torch.cat([nf, node_in], dim=1)))
        x = graph_pool(z, gidx, self.num_graphs, nmask, 'sum')
        for layer in self.ffn:
            x = self._dropout(F.relu(layer(x)))
        return _heads(x, self.head, self.n_tasks, self.n_classes, self.mode)


class DMPNNModel(GraphModel):
    """Chemprop's directed MPNN, fed by :class:`DMPNNFeaturizer` (133 atom
    and 14 bond features, bonds as adjacent edge pairs): ``depth`` rounds
    of edge messages, each summed into its destination by K1 over the
    incoming-edge-id table, a sum readout (P3) and ``ffn_layers`` dense
    layers of ``ffn_hidden``.

    The module is built at construction, with parameters drawn from a
    ``torch.Generator`` seeded with ``seed`` (which also seeds dropout);
    load trained flax parameters with :func:`params_from_flax`.  A
    regressor (the default) trains on squared error, a classifier on
    softmax cross entropy, with :class:`Adam` at ``learning_rate`` unless
    ``optimizer`` is given.
    """

    uses_edge_features = True
    uses_edge_table = True
    has_coo_branch = True

    def __init__(self, n_tasks: int = 1, mode: str = 'regression',
                 n_classes: int = 2, batch_size: int = 100,
                 enc_hidden: int = 300, depth: int = 3,
                 ffn_hidden: int = 300, ffn_layers: int = 3,
                 dropout_p: float = 0.0, number_atom_features: int = 133,
                 number_bond_features: int = 14,
                 learning_rate: float = 0.001,
                 optimizer: Optional[Optimizer] = None,
                 model_dir: Optional[str] = None, log_frequency: int = 100,
                 device=None, seed: int = 0):
        self.n_tasks = n_tasks
        self.mode = mode
        self.n_classes = n_classes
        def module(generator):
            return _DMPNNModule(
                n_tasks=n_tasks, n_classes=n_classes, mode=mode,
                num_graphs=batch_size, node_features=number_atom_features,
                edge_features=number_bond_features, enc_hidden=enc_hidden,
                depth=depth, ffn_hidden=ffn_hidden, ffn_layers=ffn_layers,
                dropout=dropout_p, generator=generator,
                dropout_seed=seed)
        loss, output_types = _gnn_loss_outputs(mode)
        super().__init__(module, loss, output_types=output_types,
                         batch_size=batch_size, model_dir=model_dir,
                         learning_rate=learning_rate, optimizer=optimizer,
                         log_frequency=log_frequency, device=device,
                         seed=seed)
