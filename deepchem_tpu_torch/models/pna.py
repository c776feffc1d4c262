"""Principal Neighbourhood Aggregation: per message-passing layer, several
aggregators of the edge messages (mean, max, min, std) each under several
degree scalers (identity, amplification, attenuation).

Counterparts of ``deepchem_tpu/models/pna.py``'s aggregators, scalers,
``PNALayer``, ``_PNAModule`` and ``PNAModel``.  The aggregations run over
the batch's CSR of its edges by destination: the sums on P2
(:func:`dst_segment_sum`), the max and min on K3
(:func:`dst_segment_max_sumgrad`), the gathers of node rows by an edge's
source or destination :func:`gather_src` and :func:`gather_dst` (P2 in
the backward: no float atomics); the readout is a mean on P3.  Each
aggregator takes ``(msgs, edst, n, emask, csr)``: the JAX package's
arguments and the batch's :class:`CooCsr`.  The variance (std, var) is
taken in two passes, where the JAX package takes ``E[x^2] - E[x]^2``: the
same function, without its cancellation in float32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from deepchem_tpu_torch.models.graph_layers import dense
from deepchem_tpu_torch.models.graph_models import (GraphModel,
                                                    _gnn_loss_outputs, _heads)
from deepchem_tpu_torch.models.optimizers import Optimizer
from deepchem_tpu_torch.ops import (CooCsr, dst_segment_max_sumgrad,
                                    dst_segment_sum, gather_dst, gather_src,
                                    graph_pool, node_degrees)
from deepchem_tpu_torch.ops.segment import segment_sum


def _counts(edst, n, emask) -> torch.Tensor:
    """Each node's incoming edges with the mask set, ``[n, 1]``, at least
    1 (exact integer sums in plain torch)."""
    return torch.clamp_min(segment_sum(emask, edst, n), 1.0)[:, None]


def _variance(msgs, edst, n, emask, csr, mean=None):
    """The masked variance of ``msgs`` over each node's incoming edges, in
    two passes: the mean, then the mean of the squared deviations from it.
    The JAX package takes ``E[x^2] - E[x]^2``, which cancels where a node's
    messages nearly agree; in float32 that lost up to 7e-6 of a PNA
    gradient against float64, the two passes 1e-7."""
    if mean is None:
        mean = aggregate_mean(msgs, edst, n, emask, csr)
    dev = (msgs - gather_dst(mean, edst, csr)) * emask[:, None]
    return dst_segment_sum(torch.square(dev), edst, csr) / _counts(
        edst, n, emask)


def aggregate_mean(msgs, edst, n, emask, csr):
    return dst_segment_sum(msgs * emask[:, None], edst, csr) / _counts(
        edst, n, emask)


def aggregate_max(msgs, edst, n, emask, csr):
    return dst_segment_max_sumgrad(msgs, emask, csr)


def aggregate_min(msgs, edst, n, emask, csr):
    return -dst_segment_max_sumgrad(-msgs, emask, csr)


def aggregate_std(msgs, edst, n, emask, csr, mean=None):
    """``sqrt(max(variance, 1e-6))``; ``mean``, where the caller has it, is
    :func:`aggregate_mean`'s of the same messages."""
    return torch.sqrt(torch.clamp_min(
        _variance(msgs, edst, n, emask, csr, mean), 1e-6))


AGGREGATORS = {'mean': aggregate_mean, 'max': aggregate_max,
               'min': aggregate_min, 'std': aggregate_std}


def aggregate_sum(msgs, edst, n, emask, csr):
    return dst_segment_sum(msgs * emask[:, None], edst, csr)


def aggregate_var(msgs, edst, n, emask, csr):
    return _variance(msgs, edst, n, emask, csr)


def aggregate_moment(msgs, edst, n, emask, csr, moment: int = 3):
    """The standardised ``moment``-th moment: ``sign(m) |m + 1e-10|^(1 /
    moment)`` of the masked mean of ``(msgs - mean[edst])^moment``."""
    mean = aggregate_mean(msgs, edst, n, emask, csr)
    dev = msgs - gather_dst(mean, edst, csr) * emask[:, None]
    m_n = aggregate_mean(dev ** moment, edst, n, emask, csr)
    return torch.sign(m_n) * torch.abs(m_n + 1e-10) ** (1.0 / moment)


def scale_identity(h, deg, avg_d):
    return h


def scale_amplification(h, deg, avg_d):
    return h * (torch.log(deg + 1.0) / avg_d)[:, None]


def scale_attenuation(h, deg, avg_d):
    return h * (avg_d / torch.log(deg + 2.0))[:, None]


SCALERS = {'identity': scale_identity,
           'amplification': scale_amplification,
           'attenuation': scale_attenuation}


class PNALayer(nn.Module):
    """Edge messages ``ReLU(Dense([h_src ; h_dst]))``, each aggregator of
    them over each node's incoming edges under each scaler, then
    ``ReLU(Dense([h ; every scaled aggregate]))``."""

    #: flax scope -> attribute (models/convert.py)
    flax_scopes = {'Dense_0': 'msg', 'Dense_1': 'out'}

    def __init__(self, in_features: int, out_dim: int,
                 aggregators: Sequence[str] = ('mean', 'max', 'min', 'std'),
                 scalers: Sequence[str] = ('identity', 'amplification',
                                           'attenuation'),
                 avg_d: float = 2.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.aggregators, self.scalers = tuple(aggregators), tuple(scalers)
        self.avg_d = avg_d
        self.msg = dense(2 * in_features, out_dim, generator)
        self.out = dense(in_features + len(self.aggregators)
                         * len(self.scalers) * out_dim, out_dim, generator)

    def forward(self, h, esrc, edst, emask, deg, csr):
        n = h.shape[0]
        z = torch.cat([gather_src(h, esrc, csr), gather_dst(h, edst, csr)],
                      dim=1)
        msgs = F.relu(self.msg(z))
        degf = deg.to(h.dtype)
        feats, mean = [], None
        for agg_name in self.aggregators:
            if agg_name in ('mean', 'std'):      # one mean for both
                if mean is None:
                    mean = aggregate_mean(msgs, edst, n, emask, csr)
                agg = mean if agg_name == 'mean' else aggregate_std(
                    msgs, edst, n, emask, csr, mean)
            else:
                agg = AGGREGATORS[agg_name](msgs, edst, n, emask, csr)
            for sc_name in self.scalers:
                feats.append(SCALERS[sc_name](agg, degf, self.avg_d))
        return F.relu(self.out(torch.cat([h] + feats, dim=1)))


class _PNAModule(nn.Module):
    """A dense embedding of the atoms, ``num_layers`` :class:`PNALayer`
    (residual), a mean readout (P3), a dense layer with ReLU and the task
    heads.  Parameters are initialised as flax initialises the JAX module,
    from ``generator``."""

    def __init__(self, n_tasks: int, n_classes: int, hidden_dim: int,
                 num_layers: int, mode: str, num_graphs: int,
                 aggregators: Sequence[str], scalers: Sequence[str],
                 node_features: int = 30, residual: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_tasks, self.n_classes, self.mode = n_tasks, n_classes, mode
        self.num_graphs, self.residual = num_graphs, residual
        self.node_features = node_features
        self.embed = dense(node_features, hidden_dim, generator)
        self.layers = nn.ModuleList(
            PNALayer(hidden_dim, hidden_dim, aggregators, scalers,
                     generator=generator) for _ in range(num_layers))
        self.readout = dense(hidden_dim, hidden_dim, generator)
        n_out = n_tasks * n_classes if mode == 'classification' else n_tasks
        self.head = dense(hidden_dim, n_out, generator)
        # flax scope (or scope path) -> attribute (models/convert.py)
        self.flax_scopes = {
            'Dense_0': 'embed', 'Dense_1': 'readout', 'Dense_2': 'head',
            **{f'PNALayer_{i}': f'layers.{i}' for i in range(num_layers)},
            **{f'PNALayer_{i}/{k}': v for i in range(num_layers)
               for k, v in PNALayer.flax_scopes.items()}}

    def forward(self, nf, esrc, edst, gidx, nmask, emask, *csr):
        esrc, edst = esrc.long(), edst.long()
        csr = CooCsr(*csr)
        deg = node_degrees(edst, nf.shape[0], emask)
        h = self.embed(nf)
        for layer in self.layers:
            h_new = layer(h, esrc, edst, emask, deg, csr)
            h = h + h_new if self.residual else h_new
        g = graph_pool(h, gidx, self.num_graphs, nmask, 'mean')
        g = F.relu(self.readout(g))
        return _heads(g, self.head, self.n_tasks, self.n_classes, self.mode)


class PNAModel(GraphModel):
    """Principal Neighbourhood Aggregation on :class:`MolGraphConvFeaturizer`
    graphs (30 atom features): ``num_layers`` :class:`PNALayer` of
    ``hidden_dim`` with the given ``aggregators`` (keys of
    :data:`AGGREGATORS`) and ``scalers`` (keys of :data:`SCALERS`), a mean
    readout and the task heads.  The module is built at construction, with
    parameters drawn from a ``torch.Generator`` seeded with ``seed``; load
    trained flax parameters with :func:`params_from_flax`.  A regressor
    (the default) trains on squared error, a classifier on softmax cross
    entropy, with :class:`Adam` at ``learning_rate`` unless ``optimizer``
    is given."""

    uses_coo_csr = True

    def __init__(self, n_tasks: int = 1, hidden_dim: int = 64,
                 num_layers: int = 3,
                 aggregators: Sequence[str] = ('mean', 'max', 'min', 'std'),
                 scalers: Sequence[str] = ('identity', 'amplification',
                                           'attenuation'),
                 mode: str = 'regression', n_classes: int = 2,
                 batch_size: int = 100, number_atom_features: int = 30,
                 learning_rate: float = 0.001,
                 optimizer: Optional[Optimizer] = None,
                 model_dir: Optional[str] = None, log_frequency: int = 100,
                 device=None, seed: int = 0):
        unknown = [a for a in aggregators if a not in AGGREGATORS] + [
            s for s in scalers if s not in SCALERS]
        if unknown:
            raise ValueError(f'unknown aggregators or scalers: {unknown}')
        self.n_tasks, self.mode, self.n_classes = n_tasks, mode, n_classes

        def module(generator):
            return _PNAModule(n_tasks=n_tasks, n_classes=n_classes,
                              hidden_dim=hidden_dim, num_layers=num_layers,
                              mode=mode, num_graphs=batch_size,
                              aggregators=tuple(aggregators),
                              scalers=tuple(scalers),
                              node_features=number_atom_features,
                              generator=generator)
        loss, output_types = _gnn_loss_outputs(mode)
        super().__init__(module, loss, output_types=output_types,
                         batch_size=batch_size, model_dir=model_dir,
                         learning_rate=learning_rate, optimizer=optimizer,
                         log_frequency=log_frequency, device=device,
                         seed=seed)
