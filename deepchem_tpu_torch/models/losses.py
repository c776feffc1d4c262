"""Per-sample losses: counterparts of ``deepchem_tpu/models/losses.py``'s
``Loss`` and its general losses, each returning the unreduced loss that
the engine weights and averages (``TorchModel._compute_loss``), and the
graph self-supervised losses of the pretraining models (InfoGraph's
mutual information, edge prediction, node and edge masking, Deep Graph
Infomax), each called with its own arguments and returning a scalar.
GROVER's pretraining loss and the NT-Xent loss with multiple
positives.  The other model-specific losses wait for their models."""

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


class GroverPretrainLoss(Loss):
    """The mean of the atom-vocabulary and bond-vocabulary cross entropies
    (integer labels) plus the mean of the functional groups' sigmoid cross
    entropy."""

    def __call__(self, atom_vocab_logits, bond_vocab_logits, fg_logits,
                 atom_vocab_labels, bond_vocab_labels, fg_labels):
        av = SparseSoftmaxCrossEntropy()(atom_vocab_logits,
                                         atom_vocab_labels).mean()
        bv = SparseSoftmaxCrossEntropy()(bond_vocab_logits,
                                         bond_vocab_labels).mean()
        fg = SigmoidCrossEntropy()(fg_logits, fg_labels).mean()
        return av + bv + fg

    def _compute(self, output, labels):
        raise NotImplementedError('call with the three logits and their '
                                  'labels')


class NTXentMultiplePositives(Loss):
    """NT-Xent: rows of ``z1`` and ``z2`` normalised (norm plus 1e-8), the
    cosine similarities of all ``2n`` over ``temperature`` with each
    row's own taken out (-1e9), and the mean cross entropy of each row's
    pair in the other view."""

    def __init__(self, temperature: float = 0.5):
        self.temperature = temperature

    def __call__(self, z1, z2):
        z1 = z1 / (torch.linalg.norm(z1, dim=-1, keepdim=True) + 1e-8)
        z2 = z2 / (torch.linalg.norm(z2, dim=-1, keepdim=True) + 1e-8)
        n = z1.shape[0]
        z = torch.cat([z1, z2], dim=0)
        eye = torch.eye(2 * n, dtype=z.dtype, device=z.device)
        sim = z @ z.T / self.temperature - 1e9 * eye
        idx = torch.arange(n, device=z.device)
        pos = torch.cat([idx + n, idx])
        logp = torch.log_softmax(sim, dim=-1)
        return -torch.gather(logp, 1, pos[:, None]).mean()

    def _compute(self, output, labels):
        return self.__call__(output, labels)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no linear cut-off."""
    return torch.logaddexp(x, torch.zeros_like(x))


class GlobalMutualInformationLoss(Loss):
    """InfoGraph's Jensen-Shannon estimate of the mutual information
    between node and graph embeddings, negated: ``sim = local @ global.T``
    ``[N, G]``; a node's own graph is its positive pair, every other graph
    a negative; ``E_neg[softplus(sim)] - E_pos[-softplus(-sim)]``, each the
    mean over its pairs, rows of masked nodes left out.  A graph index
    outside ``[0, G)`` has no positive pair."""

    def __call__(self, global_enc, local_enc, batch_graph_index,
                 node_mask=None):
        sim = local_enc @ global_enc.T
        num_graphs = global_enc.shape[0]
        pos_mask = (batch_graph_index.long()[:, None] == torch.arange(
            num_graphs, device=sim.device)).to(sim.dtype)
        neg_mask = 1.0 - pos_mask
        if node_mask is not None:
            pos_mask = pos_mask * node_mask[:, None]
            neg_mask = neg_mask * node_mask[:, None]
        e_pos = torch.sum(-_softplus(-sim) * pos_mask) \
            / torch.clamp_min(pos_mask.sum(), 1.0)
        e_neg = torch.sum(_softplus(sim) * neg_mask) \
            / torch.clamp_min(neg_mask.sum(), 1.0)
        return e_neg - e_pos

    def _compute(self, output, labels):
        raise NotImplementedError('call with (global, local, graph_index)')


class LocalMutualInformationLoss(GlobalMutualInformationLoss):
    """The same estimator on local patches."""


class EdgePredictionLoss(Loss):
    """Link prediction: the mean sigmoid cross entropy of positive edge
    scores against 1 plus that of negative ones against 0."""

    def __call__(self, pos_scores, neg_scores):
        sce = SigmoidCrossEntropy()
        return torch.mean(sce(pos_scores, torch.ones_like(pos_scores))) \
            + torch.mean(sce(neg_scores, torch.zeros_like(neg_scores)))

    def _compute(self, output, labels):
        return self.__call__(output, labels)


class GraphNodeMaskingLoss(Loss):
    """Masked-node attribute prediction: the mean softmax cross entropy of
    the logits against integer labels."""

    def __call__(self, node_logits, masked_labels):
        return SparseSoftmaxCrossEntropy()(node_logits,
                                           masked_labels).mean()

    def _compute(self, output, labels):
        return self.__call__(output, labels)


class GraphEdgeMaskingLoss(GraphNodeMaskingLoss):
    """Masked-edge attribute prediction, as :class:`GraphNodeMaskingLoss`."""


class DeepGraphInfomaxLoss(Loss):
    """Deep Graph Infomax's discriminator loss: :class:`EdgePredictionLoss`
    of the positive and negative scores."""

    def __call__(self, pos_scores, neg_scores):
        return EdgePredictionLoss()(pos_scores, neg_scores)

    def _compute(self, output, labels):
        return self.__call__(output, labels)


_EPS = 1e-7


def _maximum(x: torch.Tensor, v: float) -> torch.Tensor:
    """``max(x, v)`` whose gradient splits evenly where ``x == v``, as
    ``jnp.maximum``'s does."""
    return torch.maximum(x, x.new_tensor(v))


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` whose gradient at 0 is 1, as ``jnp.abs``'s is (torch's is
    0)."""
    return torch.where(x >= 0, x, -x)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: ``min(max(x, lo), hi)``, half the gradient at either
    bound."""
    return torch.minimum(_maximum(x, lo), x.new_tensor(hi))
