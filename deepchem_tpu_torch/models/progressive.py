"""Progressive multitask networks.

Counterparts of ``deepchem_tpu/models/progressive.py``'s
``_ProgressiveModule``, ``ProgressiveMultitaskClassifier`` and
``ProgressiveMultitaskRegressor``: a column of dense layers per task,
task ``t``'s layer ``i`` (``i > 0``) reading, through an adapter, the
layer ``i - 1`` activations of every earlier task, detached, so no
gradient reaches an earlier column through a lateral.  The products are
``nn.Linear`` on cuBLAS, as the JAX package's ``nn.Dense``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepchem_tpu_torch.models.fcnet import (_FingerprintModel,
                                             _OneHotLabels, _common)
from deepchem_tpu_torch.models.graph_layers import dense
from deepchem_tpu_torch.models.graph_models import _SeededDropout
from deepchem_tpu_torch.models.losses import L2Loss, SoftmaxCrossEntropy


class _ProgressiveModule(_SeededDropout):
    """Per task ``t`` and layer ``i``: ``z = task{t}_dense{i}(h)``, plus
    for ``t, i > 0`` ``task{t}_lateral{i}(relu(task{t}_adapter{i}(
    task{t}_alpha{i} * [acts of tasks < t at layer i - 1])))``; ``h =
    relu(z)`` and dropout; each task's ``task{t}_out``.  Attribute names
    are the flax scopes.  Returns class probabilities and logits ``[B, T,
    n_outputs]`` for a classifier, else values ``[B, T]``."""

    def __init__(self, n_features: int, n_tasks: int, n_outputs: int,
                 layer_sizes: Sequence[int], alpha_init_stddev: float,
                 dropout: float, classification: bool,
                 generator=None, dropout_seed: int = 0):
        super().__init__()
        self.n_tasks, self.layer_sizes = n_tasks, tuple(layer_sizes)
        self.classification = classification
        self.dropout, self.dropout_seed = dropout, dropout_seed
        self.flax_leaves = {}
        widths = [n_features] + list(layer_sizes)
        for t in range(n_tasks):
            for i, size in enumerate(layer_sizes):
                setattr(self, f'task{t}_dense{i}',
                        dense(widths[i], size, generator))
                if t > 0 and i > 0:
                    name = f'task{t}_alpha{i}'
                    alpha = torch.empty(1)
                    with torch.no_grad():
                        alpha.normal_(0.0, alpha_init_stddev,
                                      generator=generator)
                    setattr(self, name, nn.Parameter(alpha))
                    self.flax_leaves[name] = name
                    setattr(self, f'task{t}_adapter{i}',
                            dense(t * widths[i], size, generator))
                    setattr(self, f'task{t}_lateral{i}',
                            dense(size, size, generator, bias=False))
            setattr(self, f'task{t}_out',
                    dense(widths[-1], n_outputs, generator))

    def forward(self, x: torch.Tensor):
        acts, outputs = [], []
        for t in range(self.n_tasks):
            h, task_acts = x, []
            for i in range(len(self.layer_sizes)):
                z = getattr(self, f'task{t}_dense{i}')(h)
                if t > 0 and i > 0:
                    prev = torch.cat([acts[s][i - 1].detach()
                                      for s in range(t)], dim=1)
                    alpha = getattr(self, f'task{t}_alpha{i}')
                    a = F.relu(getattr(self, f'task{t}_adapter{i}')(
                        alpha * prev))
                    z = z + getattr(self, f'task{t}_lateral{i}')(a)
                h = self._dropout(F.relu(z))
                task_acts.append(h)
            acts.append(task_acts)
            outputs.append(getattr(self, f'task{t}_out')(h))
        out = torch.stack(outputs, dim=1)
        if self.classification:
            return torch.softmax(out, dim=-1), out
        return out[:, :, 0]


def _first(value):
    return value[0] if isinstance(value, (list, tuple)) else value


class ProgressiveMultitaskClassifier(_OneHotLabels, _FingerprintModel):
    """A progressive network of ``layer_sizes`` columns, one a task, with
    softmax cross entropy on the logits ``[B, n_tasks, n_classes]``.  The
    first of ``alpha_init_stddevs`` and ``dropouts`` is used, as in the
    JAX package; engine arguments as :class:`MultitaskClassifier`'s."""

    def __init__(self, n_tasks: int, n_features: int,
                 layer_sizes: Sequence[int] = (1000,),
                 alpha_init_stddevs: float = 0.02, dropouts: float = 0.5,
                 n_classes: int = 2, **kwargs):
        self.n_tasks, self.n_features = n_tasks, n_features
        self.n_classes = n_classes
        common = _common(kwargs)
        seed = common['seed']

        def module(generator):
            return _ProgressiveModule(
                n_features, n_tasks, n_classes, tuple(layer_sizes),
                _first(alpha_init_stddevs), _first(dropouts), True,
                generator, seed)
        super().__init__(module, SoftmaxCrossEntropy(),
                         ['prediction', 'loss'], **common)


class ProgressiveMultitaskRegressor(_FingerprintModel):
    """The regression form of :class:`ProgressiveMultitaskClassifier`: one
    value a task, squared error."""

    def __init__(self, n_tasks: int, n_features: int,
                 layer_sizes: Sequence[int] = (1000,),
                 alpha_init_stddevs: float = 0.02, dropouts: float = 0.5,
                 **kwargs):
        self.n_tasks, self.n_features = n_tasks, n_features
        common = _common(kwargs)
        seed = common['seed']

        def module(generator):
            return _ProgressiveModule(
                n_features, n_tasks, 1, tuple(layer_sizes),
                _first(alpha_init_stddevs), _first(dropouts), False,
                generator, seed)
        super().__init__(module, L2Loss(), ['prediction'], **common)

    def fit_task(self, dataset, task: int, nb_epoch: int = 10,
                 **kwargs) -> float:
        """Train one task's column: :meth:`fit_generator` over
        ``nb_epoch`` epochs with every other task's sample weights zeroed,
        so only that task's loss has a gradient."""
        def gen():
            for inputs, labels, weights in self.default_generator(
                    dataset, epochs=nb_epoch, **kwargs):
                w = np.array(weights[0], copy=True)
                if w.ndim > 1 and w.shape[1] == self.n_tasks:
                    mask = np.zeros_like(w)
                    mask[:, task] = 1.0
                    w = w * mask
                yield inputs, labels, [w]
        return self.fit_generator(gen())

    def get_task_type(self) -> str:
        return 'regression'
