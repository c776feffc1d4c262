"""Per-sample losses: counterparts of ``deepchem_tpu/models/losses.py``'s
``Loss`` and its general losses (the model-specific ones wait for their
models).  Each returns the unreduced loss; the engine weights and
averages it (``TorchModel._compute_loss``)."""

from __future__ import annotations

import math
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


class L1Loss(Loss):
    """Absolute error."""

    def _compute(self, output, labels):
        output, labels = _make_shapes_consistent(output, labels)
        return torch.abs(output - labels)


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


class HuberLoss(Loss):
    """Squared error within ``delta``, linear beyond it."""

    def __init__(self, delta: float = 1.0):
        self.delta = delta

    def _compute(self, output, labels):
        output, labels = _make_shapes_consistent(output, labels)
        d = torch.abs(output - labels)
        return torch.where(d <= self.delta, 0.5 * d * d,
                           self.delta * (d - 0.5 * self.delta))


class HingeLoss(Loss):
    """``max(0, 1 - labels * output)`` for labels in {-1, 1}."""

    def _compute(self, output, labels):
        output, labels = _make_shapes_consistent(output, labels)
        return _maximum(1.0 - labels * output, 0.0)


class SquaredHingeLoss(Loss):
    """The square of :class:`HingeLoss`."""

    def _compute(self, output, labels):
        output, labels = _make_shapes_consistent(output, labels)
        return torch.square(_maximum(1.0 - labels * output, 0.0))


class PoissonLoss(Loss):
    """The mean of ``output - labels * log(output + 1e-8)`` over the whole
    batch, as the JAX package reduces it."""

    def _compute(self, output, labels):
        output, labels = _make_shapes_consistent(output, labels)
        return torch.mean(output - labels * torch.log(output + 1e-8))


class BinaryCrossEntropy(Loss):
    """Cross entropy of probabilities, clipped to ``[1e-7, 1 - 1e-7]``."""

    def _compute(self, output, labels):
        output, labels = _make_shapes_consistent(output, labels)
        p = _clip(output, _EPS, 1 - _EPS)
        return -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p))


class CategoricalCrossEntropy(Loss):
    """Cross entropy of probabilities over the last axis, clipped below at
    1e-7."""

    def _compute(self, output, labels):
        output, labels = _make_shapes_consistent(output, labels)
        return -torch.sum(labels * torch.log(_clip(output, _EPS, 1.0)),
                          dim=-1)


class SigmoidCrossEntropy(Loss):
    """Cross entropy of logits against labels in [0, 1], computed as
    ``max(x, 0) - x z + log1p(exp(-|x|))``."""

    def _compute(self, output, labels):
        x, z = _make_shapes_consistent(output, labels)
        return _maximum(x, 0.0) - x * z + torch.log1p(
            torch.exp(-torch.abs(x)))


class SparseSoftmaxCrossEntropy(Loss):
    """Cross entropy of logits over the last axis against integer class
    labels."""

    def _compute(self, output, labels):
        if labels.ndim == output.ndim and labels.shape[-1] == 1:
            labels = labels.squeeze(-1)
        logp = torch.log_softmax(output, dim=-1)
        return -torch.gather(logp, -1,
                             labels.to(torch.int64)[..., None])[..., 0]


class VAE_ELBO(Loss):
    """KL divergence of ``N(mu, exp(logvar))`` from ``N(0, 1)`` times
    ``kl_scale``, plus the reconstruction's binary cross entropy averaged
    over each sample's features; ``output = [mu, logvar, x_hat]``."""

    def _compute_elbo(self, mu, logvar, x_hat, x, kl_scale=1.0):
        kl = VAE_KLDivergence()._compute_kl(mu, logvar)
        rec = torch.mean(BinaryCrossEntropy()._compute(x_hat, x),
                         dim=tuple(range(1, x.ndim)))
        return kl_scale * kl + rec

    def _compute(self, output, labels):
        mu, logvar, x_hat = output
        return self._compute_elbo(mu, logvar, x_hat, labels)


class VAE_KLDivergence(Loss):
    """KL divergence of ``N(mu, exp(logvar))`` from ``N(0, 1)`` per sample;
    ``output = [mu, logvar]``."""

    def _compute_kl(self, mu, logvar):
        return 0.5 * torch.sum(torch.square(mu) + torch.exp(logvar) - 1.0
                               - logvar, dim=-1)

    def _compute(self, output, labels):
        mu, logvar = output
        return self._compute_kl(mu, logvar)


class ShannonEntropy(Loss):
    """Entropy in bits of Bernoulli probabilities, clipped to ``[1e-7, 1 -
    1e-7]`` and averaged over the last axis."""

    def _compute(self, output, labels):
        p = _clip(output, _EPS, 1 - _EPS)
        return torch.mean(-(p * torch.log(p) + (1 - p) * torch.log(1 - p)),
                          dim=-1) / math.log(2.0)


_EPS = 1e-7


def _maximum(x: torch.Tensor, v: float) -> torch.Tensor:
    """``max(x, v)`` whose gradient splits evenly where ``x == v``, as
    ``jnp.maximum``'s does."""
    return torch.maximum(x, x.new_tensor(v))


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: ``min(max(x, lo), hi)``, half the gradient at either
    bound."""
    return torch.minimum(_maximum(x, lo), x.new_tensor(hi))
