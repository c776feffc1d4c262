"""Materials models: CGCNN, LCNN, MEGNet and ElemNet.

Counterparts of ``deepchem_tpu/models/material_models.py``'s
``CGCNNLayer``, ``_CGCNNModule``, ``CGCNNModel``, ``LCNNModel``,
``_MEGNetBlock``, ``_MEGNetModule``, ``MEGNetModel``, ``_ElemNetModule``
and ``ElemNetModel``.  The graph models run on the padded COO batch with
the CSR of its edges (``uses_coo_csr``): each gather of node rows by an
edge end is :func:`gather_src` or :func:`gather_dst`, whose backward is P2
over the other CSR; each sum of edge rows into their destinations is
:func:`dst_segment_sum`, P2 over the CSR by destination; MEGNet's sum of
edge rows into their graphs is P3 over the sums into their nodes
(:func:`csr_segment_sum` by graph); every mean readout is P3
(:func:`graph_pool`).  ElemNet is a dense stack (cuBLAS).  The modules
keep one graph shard: ``num_graphs`` is the batch size.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepchem_tpu_torch.models.convert import layer_scopes
from deepchem_tpu_torch.models.fcnet import _common
from deepchem_tpu_torch.models.graph_layers import dense
from deepchem_tpu_torch.models.graph_models import (GraphModel,
                                                    _SeededDropout,
                                                    _gnn_loss_outputs, _heads)
from deepchem_tpu_torch.models.losses import L2Loss
from deepchem_tpu_torch.models.optimizers import Optimizer
from deepchem_tpu_torch.models.torch_model import TorchModel
from deepchem_tpu_torch.ops import (N_CSR, CooCsr, coo_degrees, csr_row_ptr,
                                    csr_segment_sum, dst_segment_sum,
                                    gather_dst, gather_graph_rows, gather_src,
                                    graph_edge_row_ptr, graph_pool)


class CGCNNLayer(nn.Module):
    """Edge-gated crystal graph convolution (Xie & Grossman 2018): for
    each edge ``z = [h_dst ; h_src ; e]``, the message ``sigmoid(gate(z))
    * softplus(core(z))`` times the edge mask, summed into each
    destination (P2), and ``softplus(h + sum)``."""

    #: flax scope -> attribute (models/convert.py)
    flax_scopes = {'Dense_0': 'gate', 'Dense_1': 'core'}

    def __init__(self, hidden: int, edge_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.gate = dense(2 * hidden + edge_features, hidden, generator)
        self.core = dense(2 * hidden + edge_features, hidden, generator)

    def forward(self, h, esrc, edst, ef, emask, csr):
        z = torch.cat([gather_dst(h, edst, csr), gather_src(h, esrc, csr),
                       ef], dim=1)
        msg = torch.sigmoid(self.gate(z)) * F.softplus(self.core(z)) \
            * emask[:, None]
        return F.softplus(h + dst_segment_sum(msg, edst, csr))


class _CGCNNModule(nn.Module):
    """A dense embedding of the atoms, ``n_conv`` :class:`CGCNNLayer`, a
    mean readout (P3), ``softplus(Dense)`` of ``h_fea_len`` and the task
    heads.  A batch's inputs are the COO arrays, the :class:`CooCsr`
    arrays, then the edge features."""

    def __init__(self, n_tasks: int, n_classes: int, atom_fea_len: int,
                 n_conv: int, h_fea_len: int, mode: str, num_graphs: int,
                 node_features: int, edge_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_tasks, self.n_classes, self.mode = n_tasks, n_classes, mode
        self.num_graphs = num_graphs
        self.node_features, self.edge_features = node_features, edge_features
        self.embed = dense(node_features, atom_fea_len, generator)
        self.convs = nn.ModuleList(
            CGCNNLayer(atom_fea_len, edge_features, generator)
            for _ in range(n_conv))
        self.readout = dense(atom_fea_len, h_fea_len, generator)
        n_out = n_tasks * n_classes if mode == 'classification' else n_tasks
        self.head = dense(h_fea_len, n_out, generator)
        # flax scope (or scope path) -> attribute (models/convert.py)
        self.flax_scopes = {
            'Dense_0': 'embed', 'Dense_1': 'readout', 'Dense_2': 'head',
            **layer_scopes('CGCNNLayer', 'convs', n_conv,
                            CGCNNLayer.flax_scopes)}

    def forward(self, nf, esrc, edst, gidx, nmask, emask, *rest):
        csr, ef = CooCsr(*rest[:N_CSR]), rest[N_CSR]
        esrc, edst = esrc.long(), edst.long()
        h = self.embed(nf)
        for conv in self.convs:
            h = conv(h, esrc, edst, ef, emask, csr)
        g = graph_pool(h, gidx, self.num_graphs, nmask, 'mean')
        g = F.softplus(self.readout(g))
        return _heads(g, self.head, self.n_tasks, self.n_classes, self.mode)


def _engine(batch_size: int, kwargs) -> dict:
    """The engine's arguments out of ``kwargs`` (:func:`_common`'s
    defaults) with ``batch_size``; ``data_parallel``, the JAX package's
    switch, is accepted and dropped: the port keeps one graph shard."""
    kwargs.pop('data_parallel', None)
    return _common(dict(kwargs, batch_size=batch_size))


class CGCNNModel(GraphModel):
    """Crystal Graph CNN (Xie & Grossman 2018) on
    :class:`CGCNNFeaturizer` graphs (92 atom features, 41 Gaussian edge
    features at its defaults): see :class:`_CGCNNModule`.  On the card each
    convolution is one P2 forward (the edge sum) and two in the backward
    (the gathers of ``h`` by destination and by source), the readout P3.
    A classifier trains on softmax cross entropy, a regressor on squared
    error.  Engine arguments: ``learning_rate``, ``optimizer``,
    ``model_dir``, ``log_frequency``, ``device``, ``seed`` (see
    :class:`TorchModel`); ``data_parallel`` is accepted and ignored."""

    uses_coo_csr = True
    uses_edge_features = True

    def __init__(self, n_tasks: int = 1, mode: str = 'regression',
                 n_classes: int = 2, atom_fea_len: int = 64,
                 n_conv: int = 3, h_fea_len: int = 128,
                 batch_size: int = 32, node_features: int = 92,
                 edge_features: int = 41, **kwargs):
        self.n_tasks, self.mode, self.n_classes = n_tasks, mode, n_classes

        def module(generator):
            return _CGCNNModule(n_tasks, n_classes, atom_fea_len, n_conv,
                                h_fea_len, mode, batch_size, node_features,
                                edge_features, generator)
        loss, output_types = _gnn_loss_outputs(mode)
        super().__init__(module, loss, output_types=output_types,
                         **_engine(batch_size, kwargs))


class LCNNModel(GraphModel):
    """Lattice CNN for adsorbate configurations on :class:`LCNNFeaturizer`
    graphs (3 occupancy and 1 distance feature at its defaults): the CGCNN
    network at width 44, 2 convolutions and a readout of 64, regression
    on squared error."""

    uses_coo_csr = True
    uses_edge_features = True

    def __init__(self, n_tasks: int = 1, batch_size: int = 32,
                 node_features: int = 3, edge_features: int = 1, **kwargs):
        self.n_tasks, self.mode, self.n_classes = n_tasks, 'regression', 2

        def module(generator):
            return _CGCNNModule(n_tasks, 2, 44, 2, 64, 'regression',
                                batch_size, node_features, edge_features,
                                generator)
        super().__init__(module, L2Loss(), output_types=['prediction'],
                         **_engine(batch_size, kwargs))


def _mlp2(in_features: int, dim: int, generator) -> nn.ModuleDict:
    """``softplus(Dense(dim)(softplus(Dense(2 dim)(z))))``'s layers: the
    inner ``first`` and the outer ``second``."""
    return nn.ModuleDict({'first': dense(in_features, 2 * dim, generator),
                          'second': dense(2 * dim, dim, generator)})


def _run_mlp2(mlp: nn.ModuleDict, z: torch.Tensor) -> torch.Tensor:
    return F.softplus(mlp['second'](F.softplus(mlp['first'](z))))


class _MEGNetBlock(nn.Module):
    """MEGNet's co-update of edges, nodes and the global state: each edge
    from ``[h_src ; h_dst ; e ; u]``, each node from ``[h ; the mean of its
    incoming edges ; u]``, each graph's ``u`` from ``[mean h ; mean e ;
    u]``, each through a two-layer softplus MLP.  The edges' sum into
    their nodes is P2; the sum of a graph's edges is P3 over its nodes'
    sums (the JAX package's ``segment_sum`` by each edge's graph, added in
    another order); ``u`` reaches the nodes by :func:`gather_graph_rows`
    and the edges by :func:`gather_dst` of that, so its gradient is P3
    over P2, in a fixed order.  flax builds each MLP's
    outer layer first: ``Dense_0``/``Dense_1`` are the edge update's outer
    and inner layers, ``Dense_2``/``Dense_3`` the node update's,
    ``Dense_4``/``Dense_5`` the global one's."""

    flax_scopes = {'Dense_0': 'edge.second', 'Dense_1': 'edge.first',
                   'Dense_2': 'node.second', 'Dense_3': 'node.first',
                   'Dense_4': 'state.second', 'Dense_5': 'state.first'}

    def __init__(self, dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.edge = _mlp2(4 * dim, dim, generator)
        self.node = _mlp2(3 * dim, dim, generator)
        self.state = _mlp2(3 * dim, dim, generator)

    def forward(self, h, e, u, esrc, edst, gidx, nmask, emask,
                num_graphs, csr, graph_rp, in_deg, edge_counts):
        # u by each node's graph (P3 over graph_rp in the backward), then
        # by each edge's destination (P2): u[graph of dst(e)]
        u_nodes = gather_graph_rows(u, gidx, graph_rp)
        ze = torch.cat([gather_src(h, esrc, csr), gather_dst(h, edst, csr),
                        e, gather_dst(u_nodes, edst, csr)], dim=1)
        e_new = _run_mlp2(self.edge, ze) * emask[:, None]
        into_nodes = dst_segment_sum(e_new, edst, csr)
        zn = torch.cat([h, into_nodes / in_deg[:, None], u_nodes], dim=1)
        h_new = _run_mlp2(self.node, zn) * nmask[:, None]
        # the ghost slot's row too: u keeps num_graphs + 1 rows
        h_mean = graph_pool(h_new, gidx, num_graphs + 1, nmask, 'mean')
        # a graph's edges are the edges into its nodes: their sum is P3
        # over the nodes' sums (graph-contiguous rows)
        e_mean = csr_segment_sum(into_nodes, graph_rp) / edge_counts[:, None]
        zu = torch.cat([h_mean, e_mean, u], dim=1)
        return h_new, e_new, _run_mlp2(self.state, zu)


class _MEGNetModule(nn.Module):
    """Dense softplus embeddings of the atoms and the edges, a global
    state ``u`` of zeros with one row a graph and one for the ghost slot,
    ``n_blocks`` :class:`_MEGNetBlock`, then ``[mean readout (P3) ; u]``
    a graph, ``softplus(Dense)`` and the task heads.  The blocks' means
    divide by each node's real in-degree and each graph's real edge count
    (at least 1), read from the CSR's row pointers."""

    def __init__(self, n_tasks: int, n_classes: int, n_blocks: int,
                 dim: int, mode: str, num_graphs: int, node_features: int,
                 edge_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_tasks, self.n_classes, self.mode = n_tasks, n_classes, mode
        self.num_graphs, self.dim = num_graphs, dim
        self.node_features, self.edge_features = node_features, edge_features
        self.embed_nodes = dense(node_features, dim, generator)
        self.embed_edges = dense(edge_features, dim, generator)
        self.blocks = nn.ModuleList(_MEGNetBlock(dim, generator)
                                    for _ in range(n_blocks))
        self.readout = dense(2 * dim, dim, generator)
        n_out = n_tasks * n_classes if mode == 'classification' else n_tasks
        self.head = dense(dim, n_out, generator)
        self.flax_scopes = {
            'Dense_0': 'embed_nodes', 'Dense_1': 'embed_edges',
            'Dense_2': 'readout', 'Dense_3': 'head',
            **layer_scopes('_MEGNetBlock', 'blocks', n_blocks,
                            _MEGNetBlock.flax_scopes)}

    def forward(self, nf, esrc, edst, gidx, nmask, emask, *rest):
        csr, ef = CooCsr(*rest[:N_CSR]), rest[N_CSR]
        esrc, edst, gidx = esrc.long(), edst.long(), gidx.long()
        # graph g's nodes are rows graph_rp[g]:graph_rp[g+1], the ghost
        # slot's last
        graph_rp = csr_row_ptr(gidx, self.num_graphs + 1)
        in_deg = torch.clamp_min(coo_degrees(csr).to(nf.dtype), 1.0)
        real = graph_edge_row_ptr(csr, graph_rp)
        edge_counts = torch.clamp_min((real[1:] - real[:-1]).to(nf.dtype),
                                      1.0)
        h = F.softplus(self.embed_nodes(nf))
        e = F.softplus(self.embed_edges(ef))
        u = nf.new_zeros((self.num_graphs + 1, self.dim))
        for block in self.blocks:
            h, e, u = block(h, e, u, esrc, edst, gidx, nmask, emask,
                            self.num_graphs, csr, graph_rp, in_deg,
                            edge_counts)
        g = torch.cat([graph_pool(h, gidx, self.num_graphs, nmask, 'mean'),
                       u[:self.num_graphs]], dim=1)
        g = F.softplus(self.readout(g))
        return _heads(g, self.head, self.n_tasks, self.n_classes, self.mode)


class MEGNetModel(GraphModel):
    """MatErials Graph Network (Chen et al. 2019) on crystal graphs
    (:class:`CGCNNFeaturizer`'s widths by default): see
    :class:`_MEGNetModule`.  On the card each block is P2 once (the edges
    into their nodes) and twice in its backward (the node gathers), P3
    three times (the graph mean of ``h``, the edges into their graphs);
    the readout is P3 twice."""

    uses_coo_csr = True
    uses_edge_features = True

    def __init__(self, n_tasks: int = 1, mode: str = 'regression',
                 n_classes: int = 2, n_blocks: int = 1, dim: int = 32,
                 batch_size: int = 32, node_features: int = 92,
                 edge_features: int = 41, **kwargs):
        self.n_tasks, self.mode, self.n_classes = n_tasks, mode, n_classes

        def module(generator):
            return _MEGNetModule(n_tasks, n_classes, n_blocks, dim, mode,
                                 batch_size, node_features, edge_features,
                                 generator)
        loss, output_types = _gnn_loss_outputs(mode)
        super().__init__(module, loss, output_types=output_types,
                         **_engine(batch_size, kwargs))


#: ElemNet's dense widths after its 86 inputs
ELEMNET_SIZES = (1024, 1024, 1024, 1024, 512, 512, 512, 256, 256, 256,
                 128, 128, 128, 64, 64, 32)


class _ElemNetModule(_SeededDropout):
    """17 dense layers from the 86 element fractions: 16 with ReLU of
    :data:`ELEMNET_SIZES`, seeded dropout at ``dropout`` after the 4th
    (1024) and the 8th (256), as the JAX module places it, then the
    ``n_tasks`` output."""

    def __init__(self, n_tasks: int, n_features: int = 86,
                 dropout: float = 0.2, dropout_seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout, self.dropout_seed = dropout, dropout_seed
        widths = (n_features,) + ELEMNET_SIZES
        self.layers = nn.ModuleList(
            dense(widths[i], widths[i + 1], generator)
            for i in range(len(ELEMNET_SIZES)))
        self.out = dense(ELEMNET_SIZES[-1], n_tasks, generator)
        self.drops = [s in (1024, 512, 256) and i % 4 == 3
                      for i, s in enumerate(ELEMNET_SIZES)]
        self.flax_scopes = {**{f'Dense_{i}': f'layers.{i}'
                               for i in range(len(ELEMNET_SIZES))},
                            f'Dense_{len(ELEMNET_SIZES)}': 'out'}

    def forward(self, x):
        h = x
        for layer, drop in zip(self.layers, self.drops):
            h = F.relu(layer(h))
            if drop:
                h = self._dropout(h)
        return self.out(h)


class ElemNetModel(TorchModel):
    """ElemNet (Jha et al. 2018): :class:`_ElemNetModule` on
    :class:`ElemNetFeaturizer`'s 86 element fractions, regression on
    squared error.  ``dropout`` (0.2, the JAX module's rate) is drawn from
    a generator seeded with ``seed`` on the input's device, in ``train()``
    mode only.  The module is built at construction from a
    ``torch.Generator`` seeded with ``seed``; load flax parameters with
    :func:`params_from_flax`."""

    def __init__(self, n_tasks: int = 1, batch_size: int = 32,
                 dropout: float = 0.2, learning_rate: float = 0.001,
                 optimizer: Optional[Optimizer] = None,
                 model_dir: Optional[str] = None, log_frequency: int = 100,
                 device=None, seed: int = 0):
        self.n_tasks = n_tasks
        self.mode = 'regression'

        def module(generator):
            return _ElemNetModule(n_tasks, dropout=dropout,
                                  dropout_seed=seed, generator=generator)
        super().__init__(module, L2Loss(), output_types=['prediction'],
                         batch_size=batch_size, model_dir=model_dir,
                         learning_rate=learning_rate, optimizer=optimizer,
                         log_frequency=log_frequency, device=device,
                         seed=seed)

    def get_num_tasks(self) -> int:
        return self.n_tasks

    def get_task_type(self) -> str:
        return 'regression'
