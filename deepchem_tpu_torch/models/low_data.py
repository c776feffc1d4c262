"""One-shot and low-data learning: matching networks over a graph encoder.

Counterparts of ``deepchem_tpu/models/low_data.py``: ``cosine_dist``,
``AttnLSTMEmbedding``, ``IterRefLSTMEmbedding``, ``_GraphEncoder``,
``_FewShotModule`` and ``SupportGraphClassifier``.  An episode is a
support set of ``n_pos`` positives and ``n_neg`` negatives of one task and
a query batch of ``n_test`` graphs; one encoder embeds both (the port's
:class:`GCNLayer` on its COO branch, P2 forward and in the backward, then
a mean readout, P3), the attention LSTMs refine the embeddings, and each
query's probability is the softmax of its cosine similarities to the
support set times the support labels.  Episodes come from
``data/supports.py``'s generators, drawn from the classifier's own seeded
``np.random.RandomState``.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from deepchem_tpu_torch.data import NumpyDataset
from deepchem_tpu_torch.data.supports import (EpisodeGenerator,
                                              SupportGenerator,
                                              get_task_dataset)
from deepchem_tpu_torch.feat.graph_data import BatchGraphData, bucket_caps
from deepchem_tpu_torch.models.graph_layers import GCNLayer, LSTMCell, dense
from deepchem_tpu_torch.models.losses import _clip
from deepchem_tpu_torch.models.optimizers import Adam
from deepchem_tpu_torch.models.torch_model import resolve_device
from deepchem_tpu_torch.ops import CooCsr, coo_csr, coo_degrees, graph_pool

logger = logging.getLogger(__name__)


def cosine_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Row-wise cosine similarities ``[n_x, n_y]``, norms clamped at
    1e-7."""
    xn = x / torch.clamp_min(torch.linalg.vector_norm(x, dim=1,
                                                      keepdim=True), 1e-7)
    yn = y / torch.clamp_min(torch.linalg.vector_norm(y, dim=1,
                                                      keepdim=True), 1e-7)
    return xn @ yn.T


class AttnLSTMEmbedding(nn.Module):
    """Matching networks' attention LSTM (Vinyals et al. 2016): the test
    embeddings refined by ``max_depth`` steps of one LSTM cell over ``[q ;
    r]``, ``r`` their attention read of the support set.  Returns ``(x +
    q, xp)``.  flax scope: ``LSTMCell_0``."""

    flax_scopes = {'LSTMCell_0': 'cell'}

    def __init__(self, n_feat: int, max_depth: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_feat, self.max_depth = n_feat, max_depth
        self.cell = LSTMCell(2 * n_feat, n_feat, generator)

    def forward(self, x, xp):
        q = torch.zeros_like(x)
        carry = (x.new_zeros((x.shape[0], self.n_feat)),
                 x.new_zeros((x.shape[0], self.n_feat)))
        for _ in range(self.max_depth):
            a = torch.softmax(cosine_dist(x + q, xp), dim=-1)
            r = a @ xp
            carry, q = self.cell(carry, torch.cat([q, r], dim=1))
        return x + q, xp


class IterRefLSTMEmbedding(nn.Module):
    """Iterative refinement: the test and the support embeddings refined
    from each other, ``max_depth`` steps of a support LSTM and a test LSTM.
    Returns ``(x + p, xp + q)``.  flax scopes: ``support_lstm``,
    ``test_lstm``."""

    flax_scopes = {'support_lstm': 'support_lstm', 'test_lstm': 'test_lstm'}

    def __init__(self, n_feat: int, max_depth: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_feat, self.max_depth = n_feat, max_depth
        self.support_lstm = LSTMCell(2 * n_feat, n_feat, generator)
        self.test_lstm = LSTMCell(2 * n_feat, n_feat, generator)

    def forward(self, x, xp):
        p = torch.zeros_like(x)
        q = torch.zeros_like(xp)
        z = xp
        s_carry = (xp.new_zeros((xp.shape[0], self.n_feat)),) * 2
        t_carry = (x.new_zeros((x.shape[0], self.n_feat)),) * 2
        for _ in range(self.max_depth):
            a = torch.softmax(cosine_dist(z + q, xp), dim=-1)
            r = a @ xp
            x_a = torch.softmax(cosine_dist(x + p, z), dim=-1)
            s = x_a @ z
            s_carry, q = self.support_lstm(s_carry, torch.cat([q, r], dim=1))
            t_carry, p = self.test_lstm(t_carry, torch.cat([p, s], dim=1))
            z = r
        return x + p, xp + q


class _GraphEncoder(nn.Module):
    """A padded COO graph batch -> ``[num_graphs, n_feat]``: ``GCNLayer``s
    with ReLU (P2 over the batch's CSR; degrees from its row pointer), a
    mean readout (P3) and ``tanh(Dense(n_feat))``.  ``num_graphs`` is a
    call argument, so one encoder embeds the support and the query
    batches.  flax scopes: ``GCNLayer_<i>``, ``Dense_0``."""

    def __init__(self, node_features: int, n_feat: int,
                 layer_sizes: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = [node_features] + list(layer_sizes)
        self.layers = nn.ModuleList(GCNLayer(a, b, generator) for a, b in
                                    zip(widths[:-1], widths[1:]))
        self.out = dense(widths[-1], n_feat, generator)

    def forward(self, nf, esrc, edst, gidx, nmask, emask, *csr,
                num_graphs: int):
        csr = CooCsr(*csr)
        deg = coo_degrees(csr)
        coo = (esrc.long(), edst.long(), emask, csr)
        x = nf
        for layer in self.layers:
            x = layer(x, None, deg, coo)
        g = graph_pool(x, gidx, num_graphs, nmask, 'mean')
        return torch.tanh(self.out(g))


class _FewShotModule(nn.Module):
    """Support and queries through one :class:`_GraphEncoder`, refined by
    :class:`AttnLSTMEmbedding` (``kind='attn'``) or
    :class:`IterRefLSTMEmbedding` (``'res'``) or neither (``'siamese'``),
    then ``P(positive | query) = softmax(cos(query, support)) @ s_y``:
    ``[n_test]``.  flax scopes: ``encoder/GCNLayer_<i>``,
    ``encoder/Dense_0``, ``AttnLSTMEmbedding_0`` or
    ``IterRefLSTMEmbedding_0``."""

    def __init__(self, kind: str, node_features: int, n_feat: int,
                 layer_sizes: Sequence[int], n_support: int, n_test: int,
                 max_depth: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if kind not in ('siamese', 'attn', 'res'):
            raise ValueError(kind)
        self.kind, self.n_support, self.n_test = kind, n_support, n_test
        self.node_features = node_features
        self.encoder = _GraphEncoder(node_features, n_feat, layer_sizes,
                                     generator)
        n = len(layer_sizes)
        self.flax_scopes = {
            'encoder': 'encoder', 'encoder/Dense_0': 'out',
            **{f'encoder/GCNLayer_{i}': f'layers.{i}' for i in range(n)},
            **{f'encoder/GCNLayer_{i}/{k}': v for i in range(n)
               for k, v in GCNLayer.flax_scopes.items()}}
        if kind == 'attn':
            self.embedding = AttnLSTMEmbedding(n_feat, max_depth, generator)
            name = 'AttnLSTMEmbedding_0'
        elif kind == 'res':
            self.embedding = IterRefLSTMEmbedding(n_feat, max_depth,
                                                  generator)
            name = 'IterRefLSTMEmbedding_0'
        if kind != 'siamese':
            self.flax_scopes.update(
                {name: 'embedding', **{f'{name}/{k}': v for k, v in
                                       self.embedding.flax_scopes.items()}})

    def forward(self, s_inputs, s_y, q_inputs):
        xs = self.encoder(*s_inputs, num_graphs=self.n_support)
        xq = self.encoder(*q_inputs, num_graphs=self.n_test)
        if self.kind != 'siamese':
            xq, xs = self.embedding(xq, xs)
        a = torch.softmax(cosine_dist(xq, xs), dim=-1)
        return a @ s_y


class SupportGraphClassifier:
    """A one-shot graph classifier trained on episodes (``model``:
    ``'siamese'``, ``'attn'`` or ``'res'``), as the JAX package's: ``fit``
    samples (support, query) episodes across the dataset's tasks with
    :class:`EpisodeGenerator` and takes one Adam step an episode on the
    weighted binary cross entropy of the ``n_test`` query slots (the
    probabilities clipped to ``[1e-6, 1 - 1e-6]``; slots past a short
    batch weigh 0); ``predict_on_support`` and ``evaluate`` condition on
    a support set, matching-networks style.  Graphs are padded to caps
    from the dataset's largest graph.  The module is built at the first
    episode (its atom width from the graphs) from a ``torch.Generator``
    seeded with ``seed``; episodes are drawn from
    ``np.random.RandomState(seed)``.  Runs on ``device`` (the current CUDA
    device unless ``'cpu'``)."""

    def __init__(self, model: str = 'siamese', n_pos: int = 1,
                 n_neg: int = 9, n_test: int = 16, n_feat: int = 64,
                 layer_sizes: Sequence[int] = (64, 64),
                 max_depth: int = 3, learning_rate: float = 1e-3,
                 node_quantum: int = 128, edge_quantum: int = 256,
                 seed: int = 0, device=None):
        if model not in ('siamese', 'attn', 'res'):
            raise ValueError(model)
        self.device = resolve_device(device)
        self.kind = model
        self.n_pos, self.n_neg, self.n_test = n_pos, n_neg, n_test
        self.n_support = n_pos + n_neg
        self.n_feat, self.layer_sizes = n_feat, tuple(layer_sizes)
        self.max_depth = max_depth
        self.node_quantum, self.edge_quantum = node_quantum, edge_quantum
        self.optimizer = Adam(learning_rate=learning_rate)
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self.module: Optional[_FewShotModule] = None
        self._opt = None
        self._caps: Optional[Tuple[int, int]] = None

    # ---------------- packing ----------------

    def _dataset_caps(self, dataset: NumpyDataset) -> Tuple[int, int]:
        sizes = [(g.num_nodes, g.num_edges) for g in dataset.X]
        max_n = max(s[0] for s in sizes)
        max_e = max(max(s[1], 1) for s in sizes)
        per = max(self.n_support, self.n_test)
        return bucket_caps(max_n * per + 1, max_e * per, self.node_quantum,
                           self.edge_quantum)

    def _pack(self, graphs: List, num_graphs: int) -> List[np.ndarray]:
        """The JAX package's six arrays, then the edges' CSR."""
        node_cap, edge_cap = self._caps
        d = BatchGraphData(list(graphs)).pad(node_cap, edge_cap,
                                             num_graphs=num_graphs)
        src, dst = d['edge_index']
        return [d['node_features'], src, dst, d['graph_index'],
                d['node_mask'], d['edge_mask'],
                *coo_csr(src, dst, node_cap)]

    def _pack_episode(self, support: NumpyDataset, batch: NumpyDataset):
        s_in = self._pack(support.X, self.n_support)
        s_y = np.asarray(support.y, dtype=np.float32).reshape(-1)
        qX = list(batch.X)
        qy = np.asarray(batch.y, dtype=np.float32).reshape(-1)
        qw = np.ones(self.n_test, dtype=np.float32)
        if len(qX) < self.n_test:
            qw[len(qX):] = 0.0
            pad = self.n_test - len(qX)
            qX = qX + [qX[0]] * pad
            qy = np.concatenate([qy, np.zeros(pad, dtype=np.float32)])
        q_in = self._pack(qX[:self.n_test], self.n_test)
        return s_in, s_y, q_in, qy[:self.n_test], qw

    def _tensors(self, arrays) -> List[torch.Tensor]:
        return [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in arrays]

    def _to_device(self, episode):
        s_in, s_y, q_in, q_y, q_w = episode
        return (self._tensors(s_in), *self._tensors([s_y]),
                self._tensors(q_in), *self._tensors([q_y, q_w]))

    # ---------------- training ----------------

    def _build(self, episode) -> None:
        gen = torch.Generator().manual_seed(self.seed)
        self.module = _FewShotModule(
            self.kind, episode[0][0].shape[1], self.n_feat,
            self.layer_sizes, self.n_support, self.n_test, self.max_depth,
            gen).to(self.device)
        self._opt = self.optimizer._create_torch_optimizer(
            self.module.parameters())

    def loss(self, p: torch.Tensor, q_y: torch.Tensor,
             q_w: torch.Tensor) -> torch.Tensor:
        """The episode's weighted binary cross entropy."""
        p = _clip(p, 1e-6, 1.0 - 1e-6)
        ll = -(q_y * torch.log(p) + (1.0 - q_y) * torch.log(1.0 - p))
        return torch.sum(ll * q_w) / torch.clamp_min(torch.sum(q_w), 1.0)

    def _step(self, episode) -> torch.Tensor:
        s_in, s_y, q_in, q_y, q_w = episode
        self.module.train()
        self._opt.zero_grad()
        loss = self.loss(self.module(s_in, s_y, q_in), q_y, q_w)
        loss.backward()
        self._opt.step()
        return loss.detach()

    def fit(self, dataset: NumpyDataset, nb_epochs: int = 1,
            n_episodes_per_epoch: int = 100, log_every: int = 50) -> float:
        """Train on episodes sampled across the dataset's tasks; returns
        the last episode's loss."""
        if self._caps is None:
            self._caps = self._dataset_caps(dataset)
        loss = 0.0
        for epoch in range(nb_epochs):
            n_tasks = dataset.y.shape[1] if dataset.y.ndim > 1 else 1
            gen = EpisodeGenerator(
                dataset, self.n_pos, self.n_neg, self.n_test,
                max(1, n_episodes_per_epoch // max(n_tasks, 1)), self.rng)
            for i, (task, support, batch) in enumerate(gen):
                ep = self._to_device(self._pack_episode(support, batch))
                if self.module is None:
                    self._build(ep)
                loss = float(self._step(ep))
                if log_every and i % log_every == 0:
                    logger.info('epoch %d episode %d loss %.4f', epoch, i,
                                loss)
        return loss

    # ---------------- inference ----------------

    def predict_on_support(self, support: NumpyDataset,
                           test: NumpyDataset) -> np.ndarray:
        """P(positive) for every test graph, conditioned on ``support``."""
        if self.module is None:
            raise ValueError('call fit() first')
        s_in = self._tensors(self._pack(support.X, self.n_support))
        s_y, = self._tensors([np.asarray(support.y,
                                         dtype=np.float32).reshape(-1)])
        preds = []
        X = list(test.X)
        self.module.eval()
        with torch.no_grad():
            for i in range(0, len(X), self.n_test):
                chunk = X[i:i + self.n_test]
                n = len(chunk)
                if n < self.n_test:
                    chunk = chunk + [chunk[0]] * (self.n_test - n)
                q_in = self._tensors(self._pack(chunk, self.n_test))
                preds.append(self.module(s_in, s_y, q_in).cpu().numpy()[:n])
        return np.concatenate(preds)

    def evaluate(self, dataset: NumpyDataset, metric,
                 n_pos: Optional[int] = None, n_neg: Optional[int] = None,
                 n_trials: int = 10) -> Tuple[dict, dict]:
        """For each sampled (task, support), the metric of the predictions
        on the task's other rows; returns each task's mean and standard
        deviation over its trials (a trial whose rows hold one class is
        skipped)."""
        n_pos = n_pos or self.n_pos
        n_neg = n_neg or self.n_neg
        if self._caps is None:
            self._caps = self._dataset_caps(dataset)
        task_scores: dict = {}
        for task, support in SupportGenerator(dataset, n_pos, n_neg,
                                              n_trials, self.rng):
            task_ds = get_task_dataset(dataset, task)
            support_ids = set(support.ids)
            keep = [i for i, d in enumerate(task_ds.ids)
                    if d not in support_ids]
            rest = NumpyDataset(task_ds.X[keep], task_ds.y[keep],
                                task_ds.w[keep], task_ds.ids[keep])
            y_pred = self.predict_on_support(support, rest)
            y_true = np.asarray(rest.y).reshape(-1)
            if len(np.unique(y_true)) < 2:
                continue
            score = metric.metric(y_true, y_pred) \
                if hasattr(metric, 'metric') else metric(y_true, y_pred)
            task_scores.setdefault(task, []).append(float(score))
        means = {t: float(np.mean(s)) for t, s in task_scores.items()}
        stds = {t: float(np.std(s)) for t, s in task_scores.items()}
        return means, stds
