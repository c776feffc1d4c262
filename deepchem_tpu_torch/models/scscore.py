"""The synthetic complexity score: ``ScScoreModel``.

Counterpart of ``deepchem_tpu/models/scscore.py``: one MLP scores both
fingerprints of a (precursor, product) pair, and a hinge on the
difference trains the product's score above the precursor's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepchem_tpu_torch.models.fcnet import _FingerprintModel, _common
from deepchem_tpu_torch.models.graph_layers import dense
from deepchem_tpu_torch.models.graph_models import _SeededDropout


class _ScScoreNet(_SeededDropout):
    """Dense layers with ReLU and dropout, then ``1 + (scale - 1) *
    sigmoid(out(x))``: a score in ``[1, scale]``."""

    def __init__(self, n_features: int, layer_sizes: Sequence[int],
                 dropout: float, score_scale: float = 5.0,
                 generator: Optional[torch.Generator] = None,
                 dropout_seed: int = 0):
        super().__init__()
        widths = [n_features] + list(layer_sizes)
        self.layers = nn.ModuleList(dense(a, b, generator)
                                    for a, b in zip(widths[:-1], widths[1:]))
        self.out = dense(widths[-1], 1, generator)
        self.score_scale = score_scale
        self.dropout, self.dropout_seed = dropout, dropout_seed

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = self._dropout(F.relu(layer(x)))
        return 1.0 + (self.score_scale - 1.0) * torch.sigmoid(self.out(x))


class _ScScoreModule(nn.Module):
    """The net on one fingerprint batch, or on both of a pair."""

    def __init__(self, n_features: int, layer_sizes: Sequence[int],
                 dropout: float, score_scale: float = 5.0, generator=None,
                 dropout_seed: int = 0):
        super().__init__()
        self.net = _ScScoreNet(n_features, layer_sizes, dropout, score_scale,
                               generator, dropout_seed)
        n = len(layer_sizes)
        # flax scope path -> attribute (models/convert.py)
        self.flax_scopes = {'_ScScoreNet_0': 'net',
                            **{f'_ScScoreNet_0/Dense_{i}': f'layers.{i}'
                               for i in range(n)},
                            f'_ScScoreNet_0/Dense_{n}': 'out'}

    def forward(self, x1: torch.Tensor, x2: Optional[torch.Tensor] = None):
        s1 = self.net(x1)
        return s1 if x2 is None else (s1, self.net(x2))


def _hinge_loss(outputs, labels, weights) -> torch.Tensor:
    """``mean(relu(1 - (s2 - s1)))``: the second score of each pair should
    exceed the first by 1."""
    s1, s2 = outputs[0], outputs[1]
    return torch.mean(F.relu(1.0 - (s2 - s1)))


class ScScoreModel(_FingerprintModel):
    """SCScore on pairs of fingerprints stacked on axis 1, ``(batch, 2,
    n_features)``: sample ``i`` is (easier, harder molecule).  ``predict``
    returns both scores of each pair; :meth:`predict_mols` scores single
    fingerprints.  The first of ``dropouts`` is used; engine arguments as
    :class:`MultitaskClassifier`'s."""

    def __init__(self, n_features: int = 1024,
                 layer_sizes: Sequence[int] = (300, 300, 300),
                 dropouts: float = 0.0, score_scale: float = 5.0, **kwargs):
        self.n_features = n_features
        if isinstance(dropouts, (list, tuple)):
            dropouts = dropouts[0]
        common = _common(kwargs)
        seed = common['seed']

        def module(generator):
            return _ScScoreModule(n_features, tuple(layer_sizes), dropouts,
                                  score_scale, generator, seed)
        super().__init__(module, _hinge_loss, ['prediction', 'prediction'],
                         **common)

    def default_generator(self, dataset, epochs: int = 1, mode: str = 'fit',
                          deterministic: bool = True,
                          pad_batches: bool = True):
        for _ in range(epochs):
            for (X_b, y_b, w_b, _) in dataset.iterbatches(
                    batch_size=self.batch_size, deterministic=deterministic,
                    pad_batches=pad_batches):
                X_b = np.asarray(X_b, dtype=np.float32)
                if X_b.ndim == 3 and X_b.shape[1] == 2:
                    yield ([X_b[:, 0], X_b[:, 1]], [y_b], [w_b])
                else:
                    yield ([X_b], [y_b], [w_b])

    def predict_mols(self, fingerprints: np.ndarray) -> np.ndarray:
        """The score ``[n, 1]`` of each fingerprint row."""
        x = torch.from_numpy(np.asarray(fingerprints, dtype=np.float32))
        self.module.eval()
        with torch.no_grad():
            return self.module(x.to(self.device)).cpu().numpy()

    def get_num_tasks(self) -> int:
        return 1

    def get_task_type(self) -> str:
        return 'regression'
