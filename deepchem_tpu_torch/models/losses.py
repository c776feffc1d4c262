"""Per-sample losses: counterparts of ``deepchem_tpu/models/losses.py``'s
``Loss``, ``L2Loss`` and ``SoftmaxCrossEntropy``.  Each returns the
unreduced loss; the engine weights and averages it
(``TorchModel._compute_loss``)."""

from __future__ import annotations

from typing import Tuple

import torch


def _make_shapes_consistent(output: torch.Tensor, labels: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop a trailing axis of size 1 from whichever side has one more
    axis than the other."""
    if output.ndim == labels.ndim:
        return output, labels
    if output.ndim == labels.ndim + 1 and output.shape[-1] == 1:
        return output.squeeze(-1), labels
    if labels.ndim == output.ndim + 1 and labels.shape[-1] == 1:
        return output, labels.squeeze(-1)
    return output, labels


class Loss:
    """Base class: ``loss(output, labels)`` gives per-sample losses."""

    def _compute(self, output: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, output: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
        return self._compute(output, labels)


class L2Loss(Loss):
    """Squared error."""

    def _compute(self, output, labels):
        output, labels = _make_shapes_consistent(output, labels)
        return torch.square(output - labels)


class SoftmaxCrossEntropy(Loss):
    """Cross entropy of logits over the last axis against one-hot
    labels."""

    def _compute(self, output, labels):
        output, labels = _make_shapes_consistent(output, labels)
        return -torch.sum(labels * torch.log_softmax(output, dim=-1), dim=-1)
