"""InfoGraph and InfoGraph*: graph pretraining by the mutual information
between node and graph embeddings, and its semi-supervised form.

Counterparts of ``deepchem_tpu/models/infograph.py``'s
``_InfoGraphEncoder``, ``_InfoGraphModule``, ``InfoGraphModel`` and
``InfoGraphStarModel``.  The encoder is a stack of :class:`GCNLayer` on
the COO path (P2 forward and backward), the graph embedding a sum readout
(P3), the loss :class:`GlobalMutualInformationLoss`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepchem_tpu_torch.data import NumpyDataset
from deepchem_tpu_torch.models.gnn_modular import ModularModel
from deepchem_tpu_torch.models.graph_layers import GCNLayer, dense
from deepchem_tpu_torch.models.graph_models import GraphModel
from deepchem_tpu_torch.models.losses import GlobalMutualInformationLoss
from deepchem_tpu_torch.models.optimizers import Optimizer
from deepchem_tpu_torch.ops import CooCsr, graph_pool, node_degrees


class _InfoGraphEncoder(nn.Module):
    """``num_layers`` :class:`GCNLayer` of ``dim``; the node embedding is
    every layer's output side by side, ``[N, num_layers * dim]``."""

    def __init__(self, in_features: int, dim: int, num_layers: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            GCNLayer(in_features if i == 0 else dim, dim, generator)
            for i in range(num_layers))

    def forward(self, nf, deg, coo):
        h, cat = nf, []
        for layer in self.layers:
            h = layer(h, None, deg, coo)
            cat.append(h)
        return torch.cat(cat, dim=1)


class _InfoGraphModule(nn.Module):
    """The encoder, a sum readout of its node embeddings, and projection
    heads of two dense layers (ReLU between) for the node and the graph
    embeddings; with ``n_tasks > 0`` (InfoGraph*) a third head predicts
    the tasks from the graph embedding.  Returns ``(prediction, global,
    local, graph_index, node_mask)``, the graph projection in the
    prediction's place without a task head.  Parameters are initialised
    as flax initialises the JAX module, from ``generator``."""

    def __init__(self, in_features: int, dim: int, num_layers: int,
                 num_graphs: int, n_tasks: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.node_features, self.num_graphs = in_features, num_graphs
        self.n_tasks = n_tasks
        width = num_layers * dim
        self.encoder = _InfoGraphEncoder(in_features, dim, num_layers,
                                         generator)
        # flax builds each head's outer Dense before its inner one
        self.local_out = dense(dim, dim, generator)
        self.local_hidden = dense(width, dim, generator)
        self.global_out = dense(dim, dim, generator)
        self.global_hidden = dense(width, dim, generator)
        if n_tasks > 0:
            self.pred_out = dense(dim, n_tasks, generator)
            self.pred_hidden = dense(width, dim, generator)
        # flax scope (or scope path) -> attribute (models/convert.py)
        self.flax_scopes = {
            '_InfoGraphEncoder_0': 'encoder',
            **{f'_InfoGraphEncoder_0/GCNLayer_{i}/{k}': v
               for i in range(num_layers)
               for k, v in GCNLayer.flax_scopes.items()},
            **{f'Dense_{i}': name for i, name in enumerate(
                ('local_out', 'local_hidden', 'global_out', 'global_hidden',
                 'pred_out', 'pred_hidden'))}}

    def forward(self, nf, esrc, edst, gidx, nmask, emask, *csr):
        deg = node_degrees(edst, nf.shape[0], emask)
        coo = (esrc.long(), edst.long(), emask, CooCsr(*csr))
        local = self.encoder(nf, deg, coo)
        global_emb = graph_pool(local, gidx, self.num_graphs, nmask, 'sum')
        local_p = self.local_out(F.relu(self.local_hidden(local)))
        global_p = self.global_out(F.relu(self.global_hidden(global_emb)))
        if self.n_tasks > 0:
            pred = self.pred_out(F.relu(self.pred_hidden(global_emb)))
            return pred, global_p, local_p, gidx, nmask
        return global_p, global_p, local_p, gidx, nmask


class InfoGraphModel(ModularModel, GraphModel):
    """Unsupervised InfoGraph on :class:`MolGraphConvFeaturizer` graphs:
    ``fit`` maximises the mutual information between node and graph
    embeddings (the loss is :class:`GlobalMutualInformationLoss`, with a
    ghost node counted in the last graph and left out by its mask), and
    :meth:`predict_embeddings` gives the graph embeddings.  With
    ``n_tasks > 0`` a supervised head is added and its mean squared error
    joins the loss (:class:`InfoGraphStarModel`).

    Its components are the module's top-level submodules (``encoder``,
    ``local_out``, ...).  The module is built at construction, with
    parameters drawn from a ``torch.Generator`` seeded with ``seed``;
    load trained flax parameters with :func:`params_from_flax`.
    :class:`Adam` at ``learning_rate`` unless ``optimizer`` is given.
    """

    uses_coo_csr = True

    def __init__(self, num_features: int = 30, embedding_dim: int = 64,
                 num_gc_layers: int = 3, batch_size: int = 100,
                 n_tasks: int = 0, mode: str = 'regression',
                 learning_rate: float = 0.001,
                 optimizer: Optional[Optimizer] = None,
                 model_dir: Optional[str] = None, log_frequency: int = 100,
                 device=None, seed: int = 0):
        self.n_tasks = max(n_tasks, 1)
        self.mode = mode
        self.n_classes = 2
        mi_loss = GlobalMutualInformationLoss()
        supervised = n_tasks > 0

        def module(generator):
            return _InfoGraphModule(num_features, embedding_dim,
                                    num_gc_layers, batch_size, n_tasks,
                                    generator)

        def loss_fn(outputs, labels, weights):
            pred, global_p, local_p, gidx, nmask = outputs
            mi = mi_loss(global_p, local_p,
                         gidx.long().clamp_max(global_p.shape[0] - 1),
                         node_mask=nmask)
            if supervised and labels and labels[0] is not None:
                return mi + torch.mean(torch.square(pred - labels[0]))
            return mi
        super().__init__(module, loss_fn,
                         output_types=['prediction', 'embedding',
                                       'embedding', 'embedding',
                                       'embedding'],
                         batch_size=batch_size, model_dir=model_dir,
                         learning_rate=learning_rate, optimizer=optimizer,
                         log_frequency=log_frequency, device=device,
                         seed=seed)

    def predict_embeddings(self, dataset: NumpyDataset):
        """The graph embeddings (the graph projection) of ``dataset``."""
        out = self.predict(dataset, output_types=['embedding'])
        return out[0] if isinstance(out, list) else out


class InfoGraphStarModel(InfoGraphModel):
    """Semi-supervised InfoGraph*: :class:`InfoGraphModel` with a head for
    ``n_tasks`` regression tasks."""

    def __init__(self, num_features: int = 30, embedding_dim: int = 64,
                 n_tasks: int = 1, **kwargs):
        super().__init__(num_features=num_features,
                         embedding_dim=embedding_dim, n_tasks=n_tasks,
                         **kwargs)
