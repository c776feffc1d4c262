"""Graph models on the padded COO batch layout: PAGTN, GraphConv, GCN,
GAT, AttentiveFP and MPNN.

Counterparts of ``deepchem_tpu/models/graph_models.py``'s ``GraphModel``
batching (single device), ``_heads``, ``_gnn_loss_outputs``,
``PagtnLayer``, ``_PagtnModule``, ``PagtnModel``, ``_GraphConvModule``,
``GraphConvModel``, ``_StackedGNNModule``, ``GCNModel``, ``GATModel``,
``AttentiveFPModel``, ``_MPNNModule`` and ``MPNNModel``.  A batch of
``GraphData`` becomes fixed-shape padded arrays with masks
(``feat/graph_data.py``), bucketed by node and edge quanta, plus a
neighbour table or edge-id tables for the models that aggregate through
them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepchem_tpu_torch.data import NumpyDataset, pad_batch
from deepchem_tpu_torch.feat.graph_data import BatchGraphData, bucket_caps
from deepchem_tpu_torch.metrics import to_one_hot
from deepchem_tpu_torch.models.graph_layers import (AttentiveFPLayer,
                                                    EdgeNetworkMPNN, GATLayer,
                                                    GCNLayer, GraphConv,
                                                    GraphGather,
                                                    MaskedBatchNorm, SetGather,
                                                    dense, graph_pool_max)
from deepchem_tpu_torch.models.losses import L2Loss, SoftmaxCrossEntropy
from deepchem_tpu_torch.models.optimizers import Optimizer
from deepchem_tpu_torch.models.torch_model import TorchModel
from deepchem_tpu_torch.ops import (N_CSR, CooCsr, coo_csr, coo_degrees,
                                    csr_row_ptr, csr_segment_sum, graph_pool,
                                    segment_softmax_sorted)
from deepchem_tpu_torch.ops.nei_table import (build_neighbor_table,
                                              build_rev_slot)


class GraphModel(TorchModel):
    """Pads ragged graph batches into bucketed static shapes for the
    module.

    A batch's inputs are ``[node_features, edge_src, edge_dst,
    graph_index, node_mask, edge_mask]``, then, per the model's switches:
    the seven arrays of the edges' CSR (:class:`CooCsr`'s fields: with
    ``uses_coo_csr``, or in place of the tables for a model with a COO
    branch, ``has_coo_branch``, whose class has ``uses_neighbor_table``
    and ``uses_edge_table`` set to False, as the JAX package's tests
    switch them); a neighbour table ``[N, max_neighbors]`` int32 and int8
    degrees (``uses_neighbor_table``), then each slot's reverse slot ``[N,
    max_neighbors]`` int8 (``uses_rev_slot``); each node's
    incoming-edge-id table and degrees, then with ``uses_edge_table =
    'both'`` its outgoing ones (``uses_edge_table``); the edge features
    (``uses_edge_features``); and the atoms' positions, zero on pad rows
    (``uses_positions``).  ``sorts_edges_by_dst`` sorts the edges by
    destination, as the CSR segment softmax needs; every other COO op is
    edge-order invariant.
    """

    #: quanta for node/edge caps: padding waste vs number of shapes
    node_quantum = 512
    edge_quantum = 1024
    uses_edge_features = False
    sorts_edges_by_dst = False
    #: models that aggregate through ops/nei_table.py get a padded
    #: neighbour table and the degrees appended to their inputs
    uses_neighbor_table = False
    #: attention models also get each slot's reverse slot (nei_gather)
    uses_rev_slot = False
    #: models that aggregate edges into nodes through edge-id tables:
    #: True for the incoming table, 'both' for the outgoing one too
    uses_edge_table = False
    #: COO message-passing models get their edges' CSR by destination and
    #: by source (ops/coo.py ``coo_csr``); the edge arrays keep their order
    uses_coo_csr = False
    #: models whose modules also run the JAX package's COO branch: with
    #: the table switches off they get the CSR in the tables' place
    has_coo_branch = False
    max_neighbors = 10
    #: models that read the atoms' 3D positions get them ``[N, 3]`` last
    uses_positions = False
    #: when set, every batch pads to these (node_cap, edge_cap): one
    #: bucket for a whole epoch (:meth:`_collect_uniform_batches`)
    _fixed_caps: Optional[Tuple[int, int]] = None
    _sticky_caps: Optional[Tuple[int, int]] = None

    def build(self, sample_inputs: Sequence[torch.Tensor]) -> None:
        """Checks the batch's atom (and bond) feature widths against the
        module's ``node_features`` (and ``edge_features``)."""
        got = [sample_inputs[0].shape[-1]]
        want = [self.module.node_features]
        if self.uses_edge_features:
            got.append(sample_inputs[-1].shape[-1])
            want.append(self.module.edge_features)
        if got != want:
            has = ' and '.join(f'{n} {kind}'
                               for n, kind in zip(got, ('atom', 'bond')))
            raise ValueError(f'batch has {has} features; the model was '
                             f'built for {" and ".join(map(str, want))}')
        super().build(sample_inputs)

    def _ships_coo_csr(self) -> bool:
        """Whether a batch carries the CSR: read when each batch is
        packed, so switching the class's flags takes effect at once."""
        return self.uses_coo_csr or (
            self.has_coo_branch and not self.uses_neighbor_table
            and not self.uses_edge_table)

    def _batch_layout(self) -> Tuple:
        return (self.uses_neighbor_table, self.uses_rev_slot,
                self.uses_edge_table, self._ships_coo_csr())

    def _pack_one(self, graphs: List, node_cap: int, edge_cap: int,
                  num_graphs: int) -> List[np.ndarray]:
        batch = BatchGraphData(graphs)
        d = batch.pad(node_cap, edge_cap, num_graphs=num_graphs)
        if self.sorts_edges_by_dst:
            perm = np.argsort(d['edge_index'][1], kind='stable')
            d['edge_index'] = d['edge_index'][:, perm]
            d['edge_mask'] = d['edge_mask'][perm]
            if 'edge_features' in d:
                d['edge_features'] = d['edge_features'][perm]
        inputs = [d['node_features'], d['edge_index'][0],
                  d['edge_index'][1], d['graph_index'], d['node_mask'],
                  d['edge_mask']]
        if self._ships_coo_csr():
            inputs += coo_csr(d['edge_index'][0], d['edge_index'][1],
                              node_cap)
        if self.uses_neighbor_table:
            real = d['edge_mask'] > 0
            table, nbr_mask = build_neighbor_table(
                d['edge_index'][0][real], d['edge_index'][1][real],
                node_cap, self.max_neighbors)
            # degrees, not the [N, K] float mask: the kernels rebuild it
            inputs += [table, nbr_mask.sum(axis=1).astype(np.int8)]
            if self.uses_rev_slot:       # the attention layers' K4
                inputs.append(build_rev_slot(table, nbr_mask))
        if self.uses_edge_table:
            # each node's incoming edge ids, and with 'both' its outgoing
            # ones: tables over edge rows, pad entries 0
            real = d['edge_mask'] > 0
            e_ids = np.arange(len(d['edge_mask']))[real]
            for end in (1, 0) if self.uses_edge_table == 'both' else (1,):
                table, nbr_mask = build_neighbor_table(
                    e_ids, d['edge_index'][end][real], node_cap,
                    self.max_neighbors)
                inputs += [table, nbr_mask.sum(axis=1).astype(np.int8)]
        if self.uses_edge_features:
            if 'edge_features' not in d:
                raise ValueError('this model needs a featurizer that emits '
                                 'edge features')
            inputs.append(d['edge_features'])
        if self.uses_positions:
            if 'node_pos_features' not in d:
                raise ValueError('this model needs a featurizer that emits '
                                 '3D positions (RDKitConformerFeaturizer)')
            inputs.append(d['node_pos_features'])
        return inputs

    def _graph_inputs(self, X_b: np.ndarray) -> List[np.ndarray]:
        graphs = list(X_b)
        if self._fixed_caps is not None:
            node_cap, edge_cap = self._fixed_caps
        else:
            batch = BatchGraphData(graphs)
            node_cap, edge_cap = bucket_caps(batch.num_nodes + 1,
                                             batch.num_edges,
                                             self.node_quantum,
                                             self.edge_quantum)
        return self._pack_one(graphs, node_cap, edge_cap, self.batch_size)

    def _collect_uniform_batches(self, dataset: NumpyDataset,
                                 deterministic: bool = True,
                                 mode: str = 'fit') -> List:
        """One epoch of host batches padded to one (node_cap, edge_cap)
        bucket that covers every batch.  The caps are sticky: a later
        dataset that fits under them reuses them, and one that does not
        raises them for the next."""
        max_nodes = max_edges = 0
        for (X_b, _, _, _) in dataset.iterbatches(
                batch_size=self.batch_size, deterministic=True,
                pad_batches=False):
            batch = BatchGraphData(list(X_b))
            max_nodes = max(max_nodes, batch.num_nodes + 1)
            max_edges = max(max_edges, max(batch.num_edges, 1))
        caps = bucket_caps(max_nodes, max_edges, self.node_quantum,
                           self.edge_quantum)
        sticky = self._sticky_caps
        if sticky is not None and sticky[0] >= caps[0] \
                and sticky[1] >= caps[1]:
            caps = sticky
        else:
            caps = (max(caps[0], sticky[0] if sticky else 0),
                    max(caps[1], sticky[1] if sticky else 0))
            self._sticky_caps = caps
        self._fixed_caps = caps
        try:
            return list(self.default_generator(
                dataset, epochs=1, mode=mode, deterministic=deterministic,
                pad_batches=True))
        finally:
            self._fixed_caps = None

    def get_num_tasks(self) -> int:
        return self.n_tasks

    def get_task_type(self) -> str:
        return self.mode

    def default_generator(self, dataset: NumpyDataset, epochs: int = 1,
                          mode: str = 'fit', deterministic: bool = True,
                          pad_batches: bool = True):
        """Padded graph batches.  A short last batch keeps ``batch_size``
        graph slots whatever ``pad_batches`` says: its labels are padded,
        its ghost graphs get weight 0, and ``predict`` trims their outputs.
        In ``mode='fit'`` a classifier's labels become one-hot
        ``[B, n_tasks, n_classes]``."""
        for _ in range(epochs):
            for (X_b, y_b, w_b, _) in dataset.iterbatches(
                    batch_size=self.batch_size,
                    deterministic=deterministic):
                n = len(X_b)
                if n < self.batch_size:
                    _, y_b, w_b, _ = pad_batch(self.batch_size, np.zeros(n),
                                               y_b, w_b, None)
                if self.mode == 'classification' and mode == 'fit':
                    y_b = np.stack([to_one_hot(y_b[:, t], self.n_classes)
                                    for t in range(self.n_tasks)], axis=1)
                yield (self._graph_inputs(X_b), [y_b], [w_b])


def _heads(x_graph: torch.Tensor, head: nn.Linear, n_tasks: int,
           n_classes: int, mode: str,
           log_var: Optional[nn.Linear] = None):
    """Task heads shared by graph models: classification gives the class
    probabilities and the logits ``[B, n_tasks, n_classes]``, regression
    the values ``[B, n_tasks]``; with a ``log_var`` head, regression gives
    ``(values, variance, values, log variance)``."""
    out = head(x_graph)
    if mode == 'classification':
        logits = out.reshape(-1, n_tasks, n_classes)
        return torch.softmax(logits, dim=-1), logits
    if log_var is not None:
        lv = log_var(x_graph)
        return out, torch.exp(lv), out, lv
    return out


def _gnn_loss_outputs(mode: str):
    """The loss and output types of a graph model: softmax cross entropy
    on the logits for a classifier, squared error for a regressor."""
    if mode == 'classification':
        return SoftmaxCrossEntropy(), ['prediction', 'loss']
    return L2Loss(), ['prediction']


class PagtnLayer(nn.Module):
    """One Path-Augmented Graph Transformer layer (Chen et al. 2019,
    arXiv:1905.12712) on COO segment ops.

    Linear additive attention over incoming edges: each edge (u->v) scores
    LeakyReLU(W_a [h_u ; e_uv]) per head, normalised with a segment softmax
    over the destination node; messages are attention-weighted projections
    of the same concatenation, summed per destination with
    :func:`csr_segment_sum`.  Edges must arrive sorted by destination.
    """

    def __init__(self, node_features: int, edge_features: int,
                 hidden_features: int, n_heads: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_features = hidden_features
        self.n_heads = n_heads
        pair = node_features + edge_features
        width = n_heads * hidden_features
        self.attn_hidden = dense(pair, width, generator)
        self.attn = dense(width, n_heads, generator)
        self.msg = dense(pair, width, generator)
        self.out = dense(width, node_features, generator)

    def forward(self, h, ef, esrc, edst, emask, row_ptr=None):
        H, Fh = self.n_heads, self.hidden_features
        if row_ptr is None:
            row_ptr = csr_row_ptr(edst, h.shape[0])
        pair = torch.cat([h[esrc], ef], dim=-1)
        logits = self.attn(F.leaky_relu(self.attn_hidden(pair), 0.2))
        alpha = segment_softmax_sorted(logits, edst, h.shape[0], mask=emask,
                                       row_ptr=row_ptr)       # [E, H]
        msg = self.msg(pair).reshape(-1, H, Fh)
        weighted = msg * alpha[..., None] * emask[:, None, None]
        agg = csr_segment_sum(weighted.reshape(-1, H * Fh), row_ptr)
        return F.gelu(self.out(agg), approximate='tanh')


class _SeededDropout(nn.Module):
    """A module whose ``_dropout`` draws its masks from a
    ``torch.Generator`` on the input's device seeded with
    ``dropout_seed``, not from the global RNG, so a run is reproducible."""

    dropout: float = 0.0
    dropout_seed: int = 0
    _dropout_generator: Optional[torch.Generator] = None

    def _dropout(self, h: torch.Tensor,
                 rate: Optional[float] = None) -> torch.Tensor:
        """Zero each entry with probability ``rate`` (by default
        ``dropout``) and scale the rest by ``1 / (1 - rate)``, as flax's
        ``nn.Dropout``; the identity outside ``train()`` mode."""
        rate = self.dropout if rate is None else rate
        if not self.training or rate == 0:
            return h
        gen = self._dropout_generator
        if gen is None or gen.device != h.device:
            gen = torch.Generator(h.device).manual_seed(self.dropout_seed)
            self._dropout_generator = gen
        keep = torch.empty_like(h).bernoulli_(1 - rate, generator=gen)
        return h * keep / (1 - rate)


class _PagtnModule(_SeededDropout):
    """The PAGTN network: embedding, ``num_layers`` PAGTN layers with a
    residual to the embedding, a projection of ``[h ; node features]``,
    sum pooling over each graph and the task heads.

    In ``train()`` mode seeded dropout follows each layer.
    """

    #: flax scope -> attribute (models/convert.py)
    flax_scopes = {'Dense_0': 'readout', 'Dense_1': 'head'}

    def __init__(self, n_tasks: int, n_classes: int, mode: str,
                 num_graphs: int, node_features: int, edge_features: int,
                 hidden_features: int = 32, output_node_features: int = 256,
                 num_layers: int = 5, num_heads: int = 1,
                 dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None,
                 dropout_seed: int = 0):
        super().__init__()
        self.n_tasks, self.n_classes, self.mode = n_tasks, n_classes, mode
        self.num_graphs = num_graphs
        self.node_features, self.edge_features = node_features, edge_features
        width = hidden_features * num_heads
        self.embed = dense(node_features, width, generator)
        self.layers = nn.ModuleList(
            PagtnLayer(width, edge_features, hidden_features, num_heads,
                       generator) for _ in range(num_layers))
        self.dropout = dropout
        self.dropout_seed = dropout_seed
        self.readout = dense(width + node_features, output_node_features,
                             generator)
        n_out = n_tasks * n_classes if mode == 'classification' else n_tasks
        self.head = dense(output_node_features, n_out, generator)

    def forward(self, nf, esrc, edst, gidx, nmask, emask, ef):
        esrc, gidx = esrc.long(), gidx.long()
        h0 = self.embed(nf)
        h = F.leaky_relu(h0, 0.2)
        row_ptr = csr_row_ptr(edst, nf.shape[0])     # shared by the layers
        for layer in self.layers:
            m = layer(h, ef, esrc, edst, emask, row_ptr)
            # residual to the layer-0 embedding each round
            h = self._dropout(F.leaky_relu(h0 + m, 0.2))
        x = F.relu(self.readout(torch.cat([h, nf], dim=-1)))
        g = graph_pool(x, gidx, self.num_graphs, nmask)
        return _heads(g, self.head, self.n_tasks, self.n_classes, self.mode)


class PagtnModel(GraphModel):
    """Path-Augmented Graph Transformer Network for prediction, fed by
    :class:`PagtnMolGraphFeaturizer` (atom one-hots plus shortest-path pair
    features on the complete graph).

    The module is built at construction from ``number_atom_features`` and
    ``number_bond_features`` (the featurizer's 49 and 38 by default), with
    parameters drawn from a ``torch.Generator`` seeded with ``seed``; load
    trained flax parameters with :func:`params_from_flax`.  ``seed`` also
    seeds the dropout masks.  A classifier trains on softmax cross entropy,
    a regressor on squared error, with :class:`Adam` at ``learning_rate``
    unless ``optimizer`` is given.
    """

    # complete-graph edges grow as n^2; a larger quantum keeps the number
    # of padded shapes small
    edge_quantum = 2048
    uses_edge_features = True
    sorts_edges_by_dst = True        # the CSR segment softmax (P1)

    def __init__(self, n_tasks: int, number_atom_features: int = 49,
                 number_bond_features: int = 38, mode: str = 'regression',
                 n_classes: int = 2, output_node_features: int = 256,
                 hidden_features: int = 32, num_layers: int = 5,
                 num_heads: int = 1, dropout: float = 0.1,
                 batch_size: int = 16, learning_rate: float = 0.001,
                 optimizer: Optional[Optimizer] = None,
                 model_dir: Optional[str] = None, log_frequency: int = 100,
                 device=None, seed: int = 0):
        self.n_tasks = n_tasks
        self.mode = mode
        self.n_classes = n_classes
        def module(generator):
            return _PagtnModule(
                n_tasks=n_tasks, n_classes=n_classes, mode=mode,
                num_graphs=batch_size, node_features=number_atom_features,
                edge_features=number_bond_features,
                hidden_features=hidden_features,
                output_node_features=output_node_features,
                num_layers=num_layers, num_heads=num_heads, dropout=dropout,
                generator=generator, dropout_seed=seed)
        loss, output_types = _gnn_loss_outputs(mode)
        super().__init__(module, loss, output_types=output_types,
                         batch_size=batch_size, model_dir=model_dir,
                         learning_rate=learning_rate, optimizer=optimizer,
                         log_frequency=log_frequency, device=device,
                         seed=seed)


class _GraphConvModule(_SeededDropout):
    """The GraphConv network: per layer, :class:`GraphConv`, masked batch
    norm, ReLU, dropout and the neighbour max (:func:`graph_pool_max`);
    then a dense layer with batch norm and ReLU, the
    :class:`GraphGather` readout and the task heads.  Parameters are
    initialised as flax initialises the JAX module, from ``generator``."""

    #: flax scope -> attribute (models/convert.py)
    flax_scopes = {'Dense_0': 'dense', 'Dense_1': 'head',
                   'Dense_2': 'log_var'}

    def __init__(self, n_tasks: int, n_classes: int,
                 graph_conv_layers: Sequence[int], dense_layer_size: int,
                 dropout: float, mode: str, num_graphs: int,
                 node_features: int = 75, batch_normalize: bool = True,
                 uncertainty: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dropout_seed: int = 0):
        super().__init__()
        self.n_tasks, self.n_classes, self.mode = n_tasks, n_classes, mode
        self.num_graphs = num_graphs
        self.node_features = node_features
        self.dropout, self.dropout_seed = dropout, dropout_seed
        widths = [node_features] + list(graph_conv_layers)
        self.convs = nn.ModuleList(
            GraphConv(a, b, generator=generator)
            for a, b in zip(widths[:-1], widths[1:]))
        self.dense = dense(widths[-1], dense_layer_size, generator)
        # MaskedBatchNorm_i of flax: one after each conv, then the dense's
        self.norms = nn.ModuleList(
            MaskedBatchNorm(w) for w in
            list(graph_conv_layers) + [dense_layer_size]) \
            if batch_normalize else None
        self.gather = GraphGather()
        n_out = n_tasks * n_classes if mode == 'classification' else n_tasks
        self.head = dense(2 * dense_layer_size, n_out, generator)
        self.log_var = dense(2 * dense_layer_size, n_tasks, generator) \
            if uncertainty else None

    def forward(self, nf, esrc, edst, gidx, nmask, emask, *rest):
        # the neighbour table and degrees, or the COO branch's CSR
        table, deg, coo = _aggregation_inputs(esrc, edst, emask, rest)
        x = nf
        for i, conv in enumerate(self.convs):
            x = conv(x, table, deg, coo)
            if self.norms is not None:
                x = self.norms[i](x, nmask)
            x = self._dropout(F.relu(x))
            x = graph_pool_max(x, table, deg, coo)
        x = self.dense(x)
        if self.norms is not None:
            x = self.norms[-1](x, nmask)
        x = self._dropout(F.relu(x))
        g = self.gather(x, gidx, nmask, self.num_graphs)
        return _heads(g, self.head, self.n_tasks, self.n_classes, self.mode,
                      self.log_var)


def _aggregation_inputs(esrc, edst, emask, rest):
    """``(table, deg, coo)`` of a batch's inputs after the first six: the
    neighbour table and degrees (``coo`` None), or the :class:`CooCsr`
    arrays of the COO branch, whose ``coo`` is ``(edge_src, edge_dst,
    edge_mask, csr)`` and whose degrees come from the CSR (table None)."""
    if len(rest) == N_CSR:
        csr = CooCsr(*rest)
        return None, coo_degrees(csr), (esrc.long(), edst.long(), emask,
                                        csr)
    return rest[0], rest[1], None


def _uncertainty_loss(outputs, labels, weights) -> torch.Tensor:
    """Gaussian negative log likelihood of the labels under the predicted
    mean and variance, weighted: ``(y - mean)^2 / var + log var``."""
    y, var, _, log_var = outputs
    losses = (labels[0] - y) ** 2 / torch.clamp_min(var, 1e-8) + log_var
    w = weights[0]
    if w.ndim < losses.ndim:
        w = w[..., None]
    return torch.sum(losses * w) / torch.clamp_min(
        torch.broadcast_to(w, losses.shape).sum(), 1e-8)


class GraphConvModel(GraphModel):
    """Duvenaud graph-convolution model, fed by :class:`ConvMolFeaturizer`
    (75 atom features, both directions of every bond).  Aggregation runs
    through the padded neighbour table: K1 and K2 in the layers, P3 and
    K3 in the readout.  With ``uses_neighbor_table`` set to False on the
    class, the layers take the COO branch: P2 for the neighbour sum and
    K3 for the neighbour max (see :class:`GraphModel`).

    The module is built at construction, with parameters drawn from a
    ``torch.Generator`` seeded with ``seed`` (which also seeds dropout);
    load trained flax parameters with :func:`params_from_flax`.  A
    classifier trains on softmax cross entropy, a regressor on squared
    error, an uncertainty regressor (``uncertainty=True``, which needs
    ``dropout > 0``) on the Gaussian likelihood of its predicted variance,
    with :class:`Adam` at ``learning_rate`` unless ``optimizer`` is given.
    """

    uses_neighbor_table = True
    has_coo_branch = True

    def __init__(self, n_tasks: int,
                 graph_conv_layers: Sequence[int] = (64, 64),
                 dense_layer_size: int = 128, dropout: float = 0.0,
                 mode: str = 'classification',
                 number_atom_features: int = 75, n_classes: int = 2,
                 batch_size: int = 100, batch_normalize: bool = True,
                 uncertainty: bool = False, learning_rate: float = 0.001,
                 optimizer: Optional[Optimizer] = None,
                 model_dir: Optional[str] = None, log_frequency: int = 100,
                 device=None, seed: int = 0):
        self.n_tasks = n_tasks
        self.mode = mode
        self.n_classes = n_classes
        if uncertainty and mode != 'regression':
            raise ValueError('uncertainty requires regression mode')
        if uncertainty and dropout == 0.0:
            raise ValueError('uncertainty requires dropout > 0')
        def module(generator):
            return _GraphConvModule(
                n_tasks=n_tasks, n_classes=n_classes,
                graph_conv_layers=tuple(graph_conv_layers),
                dense_layer_size=dense_layer_size, dropout=dropout, mode=mode,
                num_graphs=batch_size, node_features=number_atom_features,
                batch_normalize=batch_normalize, uncertainty=uncertainty,
                generator=generator, dropout_seed=seed)
        if uncertainty:
            loss = _uncertainty_loss
            output_types = ['prediction', 'variance', 'loss', 'loss']
        else:
            loss, output_types = _gnn_loss_outputs(mode)
        super().__init__(module, loss, output_types=output_types,
                         batch_size=batch_size, model_dir=model_dir,
                         learning_rate=learning_rate, optimizer=optimizer,
                         log_frequency=log_frequency, device=device,
                         seed=seed)


class _StackedGNNModule(_SeededDropout):
    """A stack of one kind of table-path graph layer (``'gcn'``: GCNLayer;
    ``'gat'``: GATLayer with ELU after it; ``'attentivefp'``:
    AttentiveFPLayer), each followed by dropout, then the ``readout``
    (``'mean'`` or ``'sum'``, P3) over each graph's valid nodes, a dense
    layer of ``predictor_hidden_feats`` with ReLU and dropout, and the task
    heads.  Parameters are initialised as flax initialises the JAX module,
    from ``generator``."""

    _LAYERS = {'gcn': 'GCNLayer', 'gat': 'GATLayer',
               'attentivefp': 'AttentiveFPLayer'}

    def __init__(self, n_tasks: int, n_classes: int,
                 layer_sizes: Sequence[int], layer_kind: str, mode: str,
                 num_graphs: int, node_features: int = 30,
                 dropout: float = 0.0, predictor_hidden_feats: int = 128,
                 readout: str = 'mean', n_attention_heads: int = 8,
                 generator: Optional[torch.Generator] = None,
                 dropout_seed: int = 0):
        super().__init__()
        if layer_kind not in self._LAYERS:
            raise ValueError(f'bad layer kind {layer_kind}')
        self.n_tasks, self.n_classes, self.mode = n_tasks, n_classes, mode
        self.layer_kind, self.readout = layer_kind, readout
        self.num_graphs = num_graphs
        self.node_features = node_features
        self.dropout, self.dropout_seed = dropout, dropout_seed
        layers, width = [], node_features
        for size in layer_sizes:
            if layer_kind == 'gcn':
                layers.append(GCNLayer(width, size, generator))
                width = size
            elif layer_kind == 'gat':
                layers.append(GATLayer(width, size, n_attention_heads,
                                       generator=generator))
                width = size * n_attention_heads
            else:
                layers.append(AttentiveFPLayer(width, size, generator))
                width = size
        self.layers = nn.ModuleList(layers)
        self.predictor = dense(width, predictor_hidden_feats, generator)
        n_out = n_tasks * n_classes if mode == 'classification' else n_tasks
        self.head = dense(predictor_hidden_feats, n_out, generator)
        # flax scope (or scope path) -> attribute (models/convert.py)
        scope = self._LAYERS[layer_kind]
        self.flax_scopes = {
            'Dense_0': 'predictor', 'Dense_1': 'head',
            **{f'{scope}_{i}/{k}': v for i, layer in enumerate(layers)
               for k, v in layer.flax_scopes.items()}}

    def forward(self, nf, esrc, edst, gidx, nmask, emask, *rest):
        # the neighbour table, degrees and reverse slots, or the COO
        # branch's CSR
        table, deg, coo = _aggregation_inputs(esrc, edst, emask, rest)
        rev_slot = rest[2] if len(rest) == 3 else None
        x = nf
        for layer in self.layers:
            if self.layer_kind == 'gcn':
                x = layer(x, table, deg, coo)
            elif self.layer_kind == 'gat':
                x = F.elu(layer(x, table, deg, rev_slot, coo))
            else:
                x = layer(x, table, deg, rev_slot, coo)
            x = self._dropout(x)
        g = graph_pool(x, gidx, self.num_graphs, nmask, self.readout)
        h = self._dropout(F.relu(self.predictor(g)))
        return _heads(h, self.head, self.n_tasks, self.n_classes, self.mode)


class _StackedGNNModel(GraphModel):
    """The shared constructor of GCN, GAT and AttentiveFP: the module is
    built at construction, with parameters drawn from a ``torch.Generator``
    seeded with ``seed`` (which also seeds dropout); load trained flax
    parameters with :func:`params_from_flax`.  A regressor (the default)
    trains on squared error, a classifier on softmax cross entropy, with
    :class:`Adam` at ``learning_rate`` unless ``optimizer`` is given.
    With ``uses_neighbor_table`` and ``uses_rev_slot`` set to False on the
    class, the layers take their COO branches (see :class:`GraphModel`)."""

    uses_neighbor_table = True
    has_coo_branch = True

    def __init__(self, n_tasks: int, module_kwargs: dict, mode: str,
                 n_classes: int, batch_size: int, learning_rate: float,
                 optimizer: Optional[Optimizer], model_dir: Optional[str],
                 log_frequency: int, device, seed: int):
        self.n_tasks = n_tasks
        self.mode = mode
        self.n_classes = n_classes
        def module(generator):
            return _StackedGNNModule(
                n_tasks=n_tasks, n_classes=n_classes, mode=mode,
                num_graphs=batch_size,
                generator=generator, dropout_seed=seed,
                **module_kwargs)
        loss, output_types = _gnn_loss_outputs(mode)
        super().__init__(module, loss, output_types=output_types,
                         batch_size=batch_size, model_dir=model_dir,
                         learning_rate=learning_rate, optimizer=optimizer,
                         log_frequency=log_frequency, device=device,
                         seed=seed)


class GCNModel(_StackedGNNModel):
    """Graph convolutional network (Kipf and Welling), fed by
    :class:`MolGraphConvFeaturizer` (30 atom features): a
    :class:`GCNLayer` per entry of ``graph_conv_layers`` (each K1 over the
    neighbour table, with a residual), a mean readout (P3), a dense layer
    of ``predictor_hidden_feats`` and the task heads.  See
    :class:`_StackedGNNModel` for the parameters and the loss."""

    def __init__(self, n_tasks: int, graph_conv_layers=(64, 64),
                 dropout: float = 0.0, mode: str = 'regression',
                 n_classes: int = 2, predictor_hidden_feats: int = 128,
                 number_atom_features: int = 30, batch_size: int = 100,
                 learning_rate: float = 0.001,
                 optimizer: Optional[Optimizer] = None,
                 model_dir: Optional[str] = None, log_frequency: int = 100,
                 device=None, seed: int = 0):
        super().__init__(
            n_tasks, dict(layer_sizes=tuple(graph_conv_layers),
                          layer_kind='gcn', node_features=number_atom_features,
                          dropout=dropout,
                          predictor_hidden_feats=predictor_hidden_feats),
            mode, n_classes, batch_size, learning_rate, optimizer, model_dir,
            log_frequency, device, seed)


class GATModel(_StackedGNNModel):
    """Graph attention network, fed by :class:`MolGraphConvFeaturizer` (30
    atom features): a :class:`GATLayer` of ``n_attention_heads`` heads per
    entry of ``graph_attention_layers``, heads flattened and ELU after
    each, the attention over the neighbour slots (LeakyReLU slope 0.2)
    through K4 (and its backward through K1), a mean readout (P3), a dense
    layer of ``predictor_hidden_feats`` and the task heads.  See
    :class:`_StackedGNNModel` for the parameters and the loss."""

    uses_rev_slot = True

    def __init__(self, n_tasks: int, graph_attention_layers=(8, 8),
                 n_attention_heads: int = 8, dropout: float = 0.0,
                 mode: str = 'regression', n_classes: int = 2,
                 predictor_hidden_feats: int = 128,
                 number_atom_features: int = 30, batch_size: int = 100,
                 learning_rate: float = 0.001,
                 optimizer: Optional[Optimizer] = None,
                 model_dir: Optional[str] = None, log_frequency: int = 100,
                 device=None, seed: int = 0):
        super().__init__(
            n_tasks, dict(layer_sizes=tuple(graph_attention_layers),
                          layer_kind='gat', node_features=number_atom_features,
                          dropout=dropout,
                          predictor_hidden_feats=predictor_hidden_feats,
                          n_attention_heads=n_attention_heads),
            mode, n_classes, batch_size, learning_rate, optimizer, model_dir,
            log_frequency, device, seed)


class AttentiveFPModel(_StackedGNNModel):
    """AttentiveFP, fed by :class:`MolGraphConvFeaturizer` (30 atom
    features; bond features are not read): ``num_layers``
    :class:`AttentiveFPLayer` of ``graph_feat_size``, the attention over
    the neighbour slots through K4 (and its backward through K1), a sum
    readout (P3), a dense layer of 128 and the task heads.  See
    :class:`_StackedGNNModel` for the parameters and the loss."""

    uses_rev_slot = True

    def __init__(self, n_tasks: int, num_layers: int = 2,
                 graph_feat_size: int = 200, dropout: float = 0.0,
                 mode: str = 'regression', n_classes: int = 2,
                 number_atom_features: int = 30, batch_size: int = 100,
                 learning_rate: float = 0.001,
                 optimizer: Optional[Optimizer] = None,
                 model_dir: Optional[str] = None, log_frequency: int = 100,
                 device=None, seed: int = 0):
        super().__init__(
            n_tasks, dict(layer_sizes=(graph_feat_size,) * num_layers,
                          layer_kind='attentivefp',
                          node_features=number_atom_features,
                          dropout=dropout, readout='sum'),
            mode, n_classes, batch_size, learning_rate, optimizer, model_dir,
            log_frequency, device, seed)


class _MPNNModule(nn.Module):
    """The Gilmer MPNN: :class:`EdgeNetworkMPNN` (T message steps on the
    edge-id tables), :class:`SetGather` (M set2set steps), a dense layer
    with ReLU and the task heads.  Parameters are initialised as flax
    initialises the JAX module, from ``generator``."""

    #: flax scope (or scope path) -> attribute (models/convert.py)
    flax_scopes = {'EdgeNetworkMPNN_0': 'mpnn', 'SetGather_0': 'set2set',
                   'Dense_0': 'dense', 'Dense_1': 'head',
                   **{f'{scope}/{k}': v
                      for scope, layer in (('EdgeNetworkMPNN_0',
                                            EdgeNetworkMPNN),
                                           ('SetGather_0', SetGather))
                      for k, v in layer.flax_scopes.items()}}

    def __init__(self, n_tasks: int, n_classes: int, mode: str,
                 num_graphs: int, node_features: int, edge_features: int,
                 node_dim: int = 64, n_steps: int = 3,
                 set2set_steps: int = 6,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_tasks, self.n_classes, self.mode = n_tasks, n_classes, mode
        self.num_graphs = num_graphs
        self.node_features, self.edge_features = node_features, edge_features
        self.mpnn = EdgeNetworkMPNN(node_features, edge_features, node_dim,
                                    n_steps, generator)
        self.set2set = SetGather(node_dim, set2set_steps, generator)
        self.dense = dense(2 * node_dim, node_dim, generator)
        n_out = n_tasks * n_classes if mode == 'classification' else n_tasks
        self.head = dense(node_dim, n_out, generator)

    def forward(self, nf, esrc, edst, gidx, nmask, emask, *rest):
        # the edge-id tables, or the COO branch's CSR; the edge features
        # last
        ef = rest[-1]
        if len(rest) == N_CSR + 1:
            h = self.mpnn(nf, esrc.long(), edst, ef, emask,
                          csr=CooCsr(*rest[:-1]))
        else:
            h = self.mpnn(nf, esrc, edst, ef, emask, *rest[:-1])
        g = self.set2set(h, gidx, nmask, self.num_graphs)
        x = F.relu(self.dense(g))
        return _heads(x, self.head, self.n_tasks, self.n_classes, self.mode)


class MPNNModel(GraphModel):
    """Gilmer message-passing network with a set2set readout, fed by
    :class:`MolGraphConvFeaturizer` with ``use_edges=True`` (30 atom and
    11 bond features).  Messages run through each node's incoming and
    outgoing edge-id tables: K1 sums the messages into their destinations
    and takes the gradient of each edge's source state; the readout's
    attention is P1 and its weighted sums P3.  With ``uses_edge_table``
    set to False on the class, the messages take the COO branch: P2 sums
    them and takes the gradient of the sources' gather; the edge features
    follow the CSR (see :class:`GraphModel`).

    The module is built at construction, with parameters drawn from a
    ``torch.Generator`` seeded with ``seed``; load trained flax parameters
    with :func:`params_from_flax`.  A regressor (the default) trains on
    squared error, a classifier on softmax cross entropy, with
    :class:`Adam` at ``learning_rate`` unless ``optimizer`` is given.
    """

    uses_edge_features = True
    uses_edge_table = 'both'
    has_coo_branch = True

    def __init__(self, n_tasks: int, n_atom_feat: int = 30,
                 n_pair_feat: int = 11, T: int = 3, M: int = 6,
                 node_dim: int = 64, mode: str = 'regression',
                 n_classes: int = 2, batch_size: int = 100,
                 learning_rate: float = 0.001,
                 optimizer: Optional[Optimizer] = None,
                 model_dir: Optional[str] = None, log_frequency: int = 100,
                 device=None, seed: int = 0):
        self.n_tasks = n_tasks
        self.mode = mode
        self.n_classes = n_classes
        def module(generator):
            return _MPNNModule(
                n_tasks=n_tasks, n_classes=n_classes, mode=mode,
                num_graphs=batch_size, node_features=n_atom_feat,
                edge_features=n_pair_feat, node_dim=node_dim, n_steps=T,
                set2set_steps=M, generator=generator)
        loss, output_types = _gnn_loss_outputs(mode)
        super().__init__(module, loss, output_types=output_types,
                         batch_size=batch_size, model_dir=model_dir,
                         learning_rate=learning_rate, optimizer=optimizer,
                         log_frequency=log_frequency, device=device,
                         seed=seed)
