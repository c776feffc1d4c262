"""DAG model: level-by-level propagation towards each molecule's root.

Counterparts of ``deepchem_tpu/models/dag.py``'s ``DAGTransformer``,
``_DAGModule`` and ``DAGModel``.  ``DAGTransformer`` attaches each
molecule's BFS depth table; the model propagates from the deepest level
towards atom 0 of each molecule (the JAX package's single root), one
level a pass, over the COO edges: each pass gathers the source rows
(:func:`gather_src`, whose backward is P2 over the CSR by source) and
sums the selected messages into their destinations (:func:`dst_segment_sum`,
P2 over the CSR by destination); the readout sums the roots with P3
(:func:`graph_pool`).
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from deepchem_tpu_torch.models.graph_layers import dense
from deepchem_tpu_torch.models.graph_models import (GraphModel, _heads,
                                                    _gnn_loss_outputs)
from deepchem_tpu_torch.models.optimizers import Optimizer
from deepchem_tpu_torch.ops import (N_CSR, CooCsr, dst_segment_sum,
                                    gather_src, graph_pool)
from deepchem_tpu_torch.trans.transformers import Transformer


class DAGTransformer(Transformer):
    """Attaches to each graph its BFS depth table ``dag_depth`` ``[n, n]``
    int32, ``depth[root, atom]`` the graph distance along the graph's
    edges (``n`` where the atom cannot be reached), in ``kwargs`` and as
    an attribute; the graphs are changed in place."""

    def __init__(self, max_atoms: int = 50, dataset=None):
        super().__init__(transform_X=True, dataset=dataset)
        self.max_atoms = max_atoms

    def transform_array(self, X, y, w, ids):
        out = np.empty(len(X), dtype=object)
        for i, g in enumerate(X):
            n = g.num_nodes
            adj: List[List[int]] = [[] for _ in range(n)]
            for e in range(g.num_edges):
                adj[int(g.edge_index[0, e])].append(int(g.edge_index[1, e]))
            depth = np.full((n, n), n, dtype=np.int32)
            for root in range(n):
                depth[root, root] = 0
                dq = deque([root])
                while dq:
                    u = dq.popleft()
                    for v in adj[u]:
                        if depth[root, v] > depth[root, u] + 1:
                            depth[root, v] = depth[root, u] + 1
                            dq.append(v)
            g.kwargs['dag_depth'] = depth
            g.dag_depth = depth
            out[i] = g
        return out, y, w, ids


class _DAGModule(nn.Module):
    """``h = tanh(W_in x)``; for level ``L - 1`` down to 0, every atom at
    that depth from its molecule's root becomes ``tanh(W_in x + W_msg Σ
    h_child)`` over its edges from atoms one level deeper; then the roots'
    ``h`` summed a molecule (P3), ``tanh(Dense)`` and the task heads.
    flax builds ``W_in`` (``Dense_0``, applied twice) and ``W_msg``
    (``Dense_1``, no bias) first, then the readout's ``Dense_2`` and the
    head's ``Dense_3``."""

    flax_scopes = {'Dense_0': 'W_in', 'Dense_1': 'W_msg',
                   'Dense_2': 'readout', 'Dense_3': 'head'}

    def __init__(self, n_tasks: int, n_classes: int, n_graph_feat: int,
                 max_levels: int, mode: str, num_graphs: int,
                 node_features: int = 75,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_tasks, self.n_classes, self.mode = n_tasks, n_classes, mode
        self.max_levels, self.num_graphs = max_levels, num_graphs
        self.node_features = node_features
        self.W_in = dense(node_features, n_graph_feat, generator)
        self.W_msg = dense(n_graph_feat, n_graph_feat, generator, bias=False)
        self.readout = dense(n_graph_feat, n_graph_feat, generator)
        n_out = n_tasks * n_classes if mode == 'classification' else n_tasks
        self.head = dense(n_graph_feat, n_out, generator)

    def forward(self, nf, esrc, edst, gidx, nmask, emask, *rest):
        """``rest``: the batch's :class:`CooCsr` arrays, then each node's
        depth from its molecule's root (``root_depth``)."""
        csr, depth = CooCsr(*rest[:N_CSR]), rest[N_CSR].long()
        base = self.W_in(nf)
        h = torch.tanh(base)
        src_depth = depth[esrc.long()]
        dst_depth = depth[edst.long()]
        for t in range(self.max_levels):
            level = self.max_levels - 1 - t
            sel = ((dst_depth == level) & (src_depth == level + 1)
                   ).to(h.dtype) * emask
            msgs = gather_src(h, esrc, csr) * sel[:, None]
            agg = dst_segment_sum(msgs, edst, csr)
            upd = torch.tanh(base + self.W_msg(agg))
            mask_lvl = (depth == level).to(h.dtype)[:, None]
            h = h * (1 - mask_lvl) + upd * mask_lvl
        root_mask = (depth == 0).to(h.dtype) * nmask
        g = graph_pool(h * root_mask[:, None], gidx, self.num_graphs, nmask,
                       'sum')
        g = torch.tanh(self.readout(g))
        return _heads(g, self.head, self.n_tasks, self.n_classes, self.mode)


class DAGModel(GraphModel):
    """DAG model (Lusci et al. 2013) as the JAX package runs it, fed by
    :class:`ConvMolFeaturizer` and :class:`DAGTransformer`:
    ``min(max_atoms, 12)`` level passes of width ``n_graph_feat`` towards
    atom 0 of each molecule, a sum readout of the roots and the task
    heads.  A batch carries the COO edges, their CSR by destination and by
    source, and last ``root_depth`` ``[N]`` int32: each atom's depth from
    its molecule's atom 0 (0 for a molecule without ``dag_depth``, 1000
    on pad rows).  On the card each pass is P2 forward and P2 in the
    backward, the readout P3.

    The module is built at construction from a ``torch.Generator`` seeded
    with ``seed``; load flax parameters with :func:`params_from_flax`.  A
    classifier trains on softmax cross entropy, a regressor on squared
    error, with :class:`Adam` at ``learning_rate`` unless ``optimizer`` is
    given."""

    uses_coo_csr = True

    def __init__(self, n_tasks: int, max_atoms: int = 50,
                 n_atom_feat: int = 75, n_graph_feat: int = 30,
                 mode: str = 'classification', n_classes: int = 2,
                 batch_size: int = 100, learning_rate: float = 0.001,
                 optimizer: Optional[Optimizer] = None,
                 model_dir: Optional[str] = None, log_frequency: int = 100,
                 device=None, seed: int = 0):
        self.n_tasks = n_tasks
        self.mode = mode
        self.n_classes = n_classes
        self.max_atoms = max_atoms

        def module(generator):
            return _DAGModule(n_tasks, n_classes, n_graph_feat,
                              min(max_atoms, 12), mode, batch_size,
                              n_atom_feat, generator)
        loss, output_types = _gnn_loss_outputs(mode)
        super().__init__(module, loss, output_types=output_types,
                         batch_size=batch_size, model_dir=model_dir,
                         learning_rate=learning_rate, optimizer=optimizer,
                         log_frequency=log_frequency, device=device,
                         seed=seed)

    def _graph_inputs(self, X_b) -> List[np.ndarray]:
        inputs = super()._graph_inputs(X_b)
        root_depth = np.full(inputs[0].shape[0], 1000, dtype=np.int32)
        pos = 0
        for g in X_b:
            n = g.num_nodes
            depth = getattr(g, 'dag_depth', None)
            root_depth[pos:pos + n] = 0 if depth is None else depth[0]
            pos += n
        return inputs + [root_depth]
