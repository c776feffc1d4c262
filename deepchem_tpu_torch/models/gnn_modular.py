"""Modular GNN pretraining: the SNAP-style tasks of GNNModular (edge
prediction, node masking, Deep Graph Infomax, then supervised fine-tuning)
and the modular-model contract (named components, freezing, per-component
checkpoints).

Counterparts of ``deepchem_tpu/models/gnn_modular.py``'s ``ModularModel``,
``_GNNModularModule`` and ``GNNModular``.  The encoder is a stack of
:class:`GCNLayer` on the COO path: each layer's neighbour sum is P2 over
the batch's CSR (forward and backward), the readouts P3.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from deepchem_tpu_torch.data import NumpyDataset
from deepchem_tpu_torch.models.graph_layers import GCNLayer, dense
from deepchem_tpu_torch.models.graph_models import (GraphModel,
                                                    _gnn_loss_outputs, _heads)
from deepchem_tpu_torch.models.losses import SigmoidCrossEntropy
from deepchem_tpu_torch.models.optimizers import Optimizer
from deepchem_tpu_torch.ops import CooCsr, graph_pool, node_degrees


class ModularModel:
    """Named components of a model's module, with freezing and
    per-component checkpoints.

    A component is a set of the module's parameters: those whose name
    holds one of the prefixes ``component_scopes`` lists under the
    component's name, or, for a name it does not list, the name itself
    (the JAX package matches its flax scope paths the same way; the port
    matches its own parameter names, which keep the JAX module's scope
    names where a model lists ``component_scopes``)."""

    #: component name -> prefixes of its parameters' names
    component_scopes: Dict[str, Sequence[str]] = {}

    def _prefixes(self, names: Sequence[str]) -> List[str]:
        out: List[str] = []
        for name in names:
            out += list(self.component_scopes.get(name, [name]))
        return out

    def build_components(self) -> Dict[str, Dict[str, nn.Module]]:
        """The module's top-level submodules grouped by component: with
        ``component_scopes``, each component's submodules whose name holds
        one of its prefixes; without, each submodule its own component."""
        children = dict(self.module.named_children())
        if not self.component_scopes:
            return {name: {name: m} for name, m in children.items()}
        return {name: {c: m for c, m in children.items()
                       if any(p in c for p in prefixes)}
                for name, prefixes in self.component_scopes.items()}

    @property
    def components(self) -> Dict[str, Dict[str, nn.Module]]:
        return self.build_components()

    def build_model(self) -> nn.Module:
        """The assembled model: the module holds every component."""
        return self.module

    def loss_func(self, inputs, labels, weights) -> torch.Tensor:
        """The model's loss over a forward pass in ``eval()`` mode, with a
        gradient: ``inputs``, ``labels`` and ``weights`` are tensors on the
        model's device."""
        self.module.eval()
        out = self.module(*inputs)
        outputs = list(out) if isinstance(out, (list, tuple)) else [out]
        return self._compute_loss(outputs, list(labels), list(weights))

    def freeze_components(self, names: Sequence[str]) -> None:
        """Train the named components no more: their gradients are set to 0
        before every optimizer update (the update itself still runs, as in
        the JAX package)."""
        self._frozen = getattr(self, '_frozen', set()) | set(names)

    def unfreeze_components(self, names: Sequence[str]) -> None:
        self._frozen = getattr(self, '_frozen', set()) - set(names)

    def _transform_gradients(self) -> None:
        prefixes = self._prefixes(sorted(getattr(self, '_frozen', ())))
        if not prefixes:
            return
        for name, p in self.module.named_parameters():
            if p.grad is not None and any(pref in name for pref in prefixes):
                p.grad.zero_()

    def save_components(self, model_dir: Optional[str] = None) -> None:
        """Every parameter of the module to ``components.pt`` in
        ``model_dir`` (default the model's)."""
        model_dir = model_dir or self.model_dir
        os.makedirs(model_dir, exist_ok=True)
        torch.save({k: v.detach().cpu() for k, v in
                    self.module.state_dict().items()},
                   os.path.join(model_dir, 'components.pt'))

    def load_components(self, model_dir: Optional[str] = None,
                        components: Optional[Sequence[str]] = None) -> None:
        """Load :meth:`save_components`' file: every parameter, or with
        ``components`` only the parameters of those components that the
        file holds."""
        model_dir = model_dir or self.model_dir
        saved = torch.load(os.path.join(model_dir, 'components.pt'),
                           map_location='cpu', weights_only=True)
        if components is None:
            self.module.load_state_dict(saved)
            return
        prefixes = self._prefixes(components)
        with torch.no_grad():
            for key, t in self.module.state_dict().items():
                if any(p in key for p in prefixes) and key in saved:
                    t.copy_(saved[key])


_TASKS = ('edge_pred', 'mask_nodes', 'infomax', 'regression',
          'classification')


class _GNNModularModule(nn.Module):
    """``num_layers`` :class:`GCNLayer` of ``emb_dim`` (``encoder_gcn<i>``,
    the COO path) and one task's head: ``edge_pred`` scores each edge and
    a shifted pair (``roll(edge_dst, 7)``) by the dot product of their
    ends' embeddings; ``mask_nodes`` decodes each node's features
    (``node_decoder``); ``infomax`` scores each node against its graph's
    summary (``sigmoid(infomax_head(mean readout))``) and against the
    previous graph's; ``regression`` and ``classification`` a mean readout
    and ``head``.  Parameters are initialised as flax initialises the JAX
    module, from ``generator``."""

    def __init__(self, emb_dim: int, num_layers: int, num_graphs: int,
                 task: str, n_tasks: int, n_classes: int,
                 node_feature_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.emb_dim, self.num_graphs, self.task = emb_dim, num_graphs, task
        self.n_tasks, self.n_classes = n_tasks, n_classes
        self.node_features = node_feature_dim
        self.mode = 'classification' if task == 'classification' \
            else 'regression'
        self.encoders = [f'encoder_gcn{i}' for i in range(num_layers)]
        width = node_feature_dim
        for name in self.encoders:
            setattr(self, name, GCNLayer(width, emb_dim, generator))
            width = emb_dim
        if task == 'mask_nodes':
            self.node_decoder = dense(emb_dim, node_feature_dim, generator)
        elif task == 'infomax':
            self.infomax_head = dense(emb_dim, emb_dim, generator)
        elif task in ('regression', 'classification'):
            n_out = n_tasks * n_classes if task == 'classification' \
                else n_tasks
            self.head = dense(emb_dim, n_out, generator)
        # flax scope path -> attribute (models/convert.py)
        self.flax_scopes = {f'{name}/{k}': v for name in self.encoders
                            for k, v in GCNLayer.flax_scopes.items()}

    def forward(self, nf, esrc, edst, gidx, nmask, emask, *csr):
        esrc, edst = esrc.long(), edst.long()
        deg = node_degrees(edst, nf.shape[0], emask)
        coo = (esrc, edst, emask, CooCsr(*csr))
        h = nf
        for name in self.encoders:
            h = getattr(self, name)(h, None, deg, coo)
        if self.task == 'edge_pred':
            hs = h.index_select(0, esrc)
            pos = torch.sum(hs * h.index_select(0, edst), dim=1)
            neg_dst = torch.roll(edst, 7)
            neg = torch.sum(hs * h.index_select(0, neg_dst), dim=1)
            return pos, neg, emask
        if self.task == 'mask_nodes':
            return (self.node_decoder(h),)
        g = graph_pool(h, gidx, self.num_graphs, nmask, 'mean')
        if self.task == 'infomax':
            summary = torch.sigmoid(self.infomax_head(g))
            graph = gidx.long().clamp_max(self.num_graphs)
            zero = summary.new_zeros((1, self.emb_dim))
            pos = torch.sum(h * torch.cat([summary, zero]).index_select(
                0, graph), dim=1)
            shifted = torch.roll(summary, 1, dims=0)
            neg = torch.sum(h * torch.cat([shifted, zero]).index_select(
                0, graph), dim=1)
            return pos, neg, nmask
        return _heads(g, self.head, self.n_tasks, self.n_classes, self.mode)


def _pair_loss(outputs, labels, weights) -> torch.Tensor:
    """Sigmoid cross entropy of positive scores against 1 and negative ones
    against 0, over the rows whose mask is set, averaged over both."""
    pos, neg, mask = outputs
    sce = SigmoidCrossEntropy()
    lp = sce(pos, torch.ones_like(pos)) * mask
    ln = sce(neg, torch.zeros_like(neg)) * mask
    return (lp.sum() + ln.sum()) / (2 * torch.clamp_min(mask.sum(), 1.0))


def _reconstruction_loss(outputs, labels, weights) -> torch.Tensor:
    """Mean squared error of the decoded node features (every row, ghost
    nodes too) against the unmasked ones."""
    return torch.mean(torch.square(outputs[0] - labels[0]))


class GNNModular(ModularModel, GraphModel):
    """SNAP-style pretraining on :class:`MolGraphConvFeaturizer` graphs (30
    atom features): ``task`` is ``'edge_pred'``, ``'mask_nodes'``,
    ``'infomax'``, ``'regression'`` or ``'classification'``.  The encoder
    component (``encoder_gcn<i>``) carries over between tasks through
    :meth:`save_components`, :meth:`load_components` and
    :meth:`freeze_components`; the head component is ``head``,
    ``node_decoder`` or ``infomax_head``.

    ``mask_nodes`` zeroes 15 % of each batch's nodes, drawn from
    ``RandomState(0)`` afresh in each call of :meth:`default_generator`,
    and reconstructs their features.  ``gnn_type`` is accepted and
    ignored: the encoder is GCN, as in the JAX package.  The module is
    built at construction, with parameters drawn from a
    ``torch.Generator`` seeded with ``seed``; load trained flax parameters
    with :func:`params_from_flax`.  :class:`Adam` at ``learning_rate``
    unless ``optimizer`` is given.
    """

    uses_coo_csr = True
    component_scopes = {'encoder': ['encoder_'],
                        'head': ['head', 'node_decoder', 'infomax_head']}

    def __init__(self, gnn_type: str = 'gcn', num_layers: int = 3,
                 emb_dim: int = 64, task: str = 'edge_pred',
                 n_tasks: int = 1, n_classes: int = 2,
                 node_feature_dim: int = 30, batch_size: int = 100,
                 mode: Optional[str] = None, learning_rate: float = 0.001,
                 optimizer: Optional[Optimizer] = None,
                 model_dir: Optional[str] = None, log_frequency: int = 100,
                 device=None, seed: int = 0):
        if task not in _TASKS:
            raise ValueError(f'task must be one of {_TASKS}, got {task!r}')
        self.n_tasks, self.n_classes, self.task = n_tasks, n_classes, task
        self.mode = mode or ('classification' if task == 'classification'
                             else 'regression')

        def module(generator):
            return _GNNModularModule(
                emb_dim=emb_dim, num_layers=num_layers,
                num_graphs=batch_size, task=task, n_tasks=n_tasks,
                n_classes=n_classes, node_feature_dim=node_feature_dim,
                generator=generator)
        if task in ('edge_pred', 'infomax'):
            loss, output_types = _pair_loss, ['embedding'] * 3
        elif task == 'mask_nodes':
            loss, output_types = _reconstruction_loss, ['prediction']
        else:
            loss, output_types = _gnn_loss_outputs(self.mode)
        super().__init__(module, loss, output_types=output_types,
                         batch_size=batch_size, model_dir=model_dir,
                         learning_rate=learning_rate, optimizer=optimizer,
                         log_frequency=log_frequency, device=device,
                         seed=seed)

    def default_generator(self, dataset: NumpyDataset, epochs: int = 1,
                          mode: str = 'fit', deterministic: bool = True,
                          pad_batches: bool = True):
        """Padded graph batches; for ``mask_nodes``, the node features with
        15 % of the nodes zeroed (``RandomState(0).rand(N) < 0.15`` per
        batch, one generator a call) as inputs, the unmasked features as
        labels and weights of 1 per node."""
        if self.task != 'mask_nodes':
            yield from super().default_generator(
                dataset, epochs, mode, deterministic, pad_batches)
            return
        rng = np.random.RandomState(0)
        for _ in range(epochs):
            for (X_b, _, _, _) in dataset.iterbatches(
                    batch_size=self.batch_size, deterministic=deterministic,
                    pad_batches=False):
                inputs = self._graph_inputs(X_b)
                nf = inputs[0].copy()
                target = nf.copy()
                nf[rng.rand(len(nf)) < 0.15] = 0.0
                inputs[0] = nf
                yield (inputs, [target],
                       [np.ones((len(nf), 1), np.float32)])
