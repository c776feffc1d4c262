"""Influence relevance voting: ``MultitaskIRVClassifier``.

Counterpart of ``deepchem_tpu/models/irv.py``.  Its input is
:class:`IRVTransformer`'s features, per task ``[sim_1..sim_K,
y_1..y_K]`` of the ``K`` most similar labelled samples.
"""

from __future__ import annotations

import torch
from torch import nn

from deepchem_tpu_torch.models.fcnet import _FingerprintModel, _common
from deepchem_tpu_torch.models.losses import SigmoidCrossEntropy


class _IRVModule(nn.Module):
    """Each neighbour's vote ``sigmoid(W[0] sim_k + W[1] exp(-k) + b) (2
    y_k - 1)``, summed per task, plus ``b2``: the logits ``[B, T]`` and
    the class probabilities ``[B, T, 2]``.  ``W`` starts at (1, 1), ``b``
    and ``b2`` at 0."""

    flax_leaves = {'W': 'W', 'b2': 'b2'}

    def __init__(self, n_tasks: int, K: int):
        super().__init__()
        self.n_tasks, self.K = n_tasks, K
        self.W = nn.Parameter(torch.ones(2))
        self.b = nn.Parameter(torch.zeros(1))
        self.b2 = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor):
        K = self.K
        x = x.reshape(-1, self.n_tasks, 2 * K)
        sims, ys = x[:, :, :K], x[:, :, K:]
        ranks = torch.arange(1, K + 1, dtype=x.dtype, device=x.device)
        V = self.W[0] * sims + self.W[1] * torch.exp(-ranks) + self.b[0]
        logits = torch.sum(torch.sigmoid(V) * (2.0 * ys - 1.0), dim=2) \
            + self.b2[0]
        probs = torch.sigmoid(logits)
        return torch.stack([1.0 - probs, probs], dim=2), logits


class MultitaskIRVClassifier(_FingerprintModel):
    """IRV over :class:`IRVTransformer` features of ``K`` neighbours a
    task, trained on sigmoid cross entropy of its logits against the 0/1
    labels.  ``batch_size`` defaults to 50; the other engine arguments as
    :class:`MultitaskClassifier`'s."""

    def __init__(self, n_tasks: int, K: int = 10, **kwargs):
        self.n_tasks, self.K, self.n_classes = n_tasks, K, 2
        kwargs.setdefault('batch_size', 50)
        super().__init__(lambda generator: _IRVModule(n_tasks, K),
                         SigmoidCrossEntropy(), ['prediction', 'loss'],
                         **_common(kwargs))

    def get_task_type(self) -> str:
        return 'classification'


IRVClassifier = MultitaskIRVClassifier
