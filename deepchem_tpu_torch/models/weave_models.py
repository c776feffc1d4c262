"""Weave and DTNN on dense per-molecule blocks.

Counterparts of ``deepchem_tpu/models/weave_models.py``'s ``_WeaveModule``,
``WeaveModel``, ``_DTNNModule`` and ``DTNNModel``.  A Weave batch is
atoms ``[B, A, F]``, pairs ``[B, A, A, P]`` and their masks, ``B`` the
model's batch size and ``A`` the batch's largest molecule rounded up to
``atom_quantum``; a DTNN batch is Coulomb matrices ``[B, A, A]``.  Both
run on cuBLAS products and elementwise torch ops: neither reaches a
kernel of the port's, as neither reaches a Pallas kernel in the JAX
package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from deepchem_tpu_torch.data import NumpyDataset, pad_batch
from deepchem_tpu_torch.metrics import to_one_hot
from deepchem_tpu_torch.models.graph_layers import (DTNNEmbedding, DTNNStep,
                                                    WeaveGather, WeaveLayer,
                                                    dense)
from deepchem_tpu_torch.models.losses import L2Loss, SoftmaxCrossEntropy
from deepchem_tpu_torch.models.optimizers import Optimizer
from deepchem_tpu_torch.models.torch_model import TorchModel


def _round_up(x: int, q: int) -> int:
    return max(q, ((x + q - 1) // q) * q)


def _nested_scopes(prefix: str, attr: str, layer: nn.Module) -> dict:
    """flax scopes of a sub-layer: ``prefix`` is ``attr``, and each scope
    path ``prefix/<its scope>`` the attribute the layer names for it."""
    return {prefix: attr, **{f'{prefix}/{k}': v
                             for k, v in layer.flax_scopes.items()}}


class _WeaveModule(nn.Module):
    """``n_weave`` :class:`WeaveLayer` (the last updates no pairs),
    ``tanh(Dense(n_graph_feat))`` over the atoms, :class:`WeaveGather`
    and the task head: class probabilities and logits ``[B, n_tasks,
    n_classes]``, or values ``[B, n_tasks]``."""

    def __init__(self, n_tasks: int, n_classes: int, n_weave: int,
                 n_hidden: int, n_graph_feat: int, mode: str,
                 n_atom_feat: int = 75, n_pair_feat: int = 14,
                 gaussian_expand: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_tasks, self.n_classes, self.mode = n_tasks, n_classes, mode
        self.node_features, self.pair_features = n_atom_feat, n_pair_feat
        layers, a, p = [], n_atom_feat, n_pair_feat
        for i in range(n_weave):
            layers.append(WeaveLayer(a, p, n_hidden, n_hidden, n_hidden,
                                     update_pair=i < n_weave - 1,
                                     generator=generator))
            a = p = n_hidden
        self.layers = nn.ModuleList(layers)
        self.dense = dense(a, n_graph_feat, generator)
        self.gather = WeaveGather(n_graph_feat, gaussian_expand, generator)
        n_out = n_tasks * n_classes if mode == 'classification' else n_tasks
        self.head = dense(n_graph_feat, n_out, generator)
        self.flax_scopes = {
            'Dense_0': 'dense', 'Dense_1': 'head',
            **_nested_scopes('WeaveGather_0', 'gather', self.gather),
            **{k: v for i, layer in enumerate(layers) for k, v in
               _nested_scopes(f'WeaveLayer_{i}', f'layers.{i}',
                              layer).items()}}

    def forward(self, atoms, pairs, atom_mask, pair_mask):
        a, p = atoms, pairs
        for layer in self.layers:
            a, p = layer(a, p, pair_mask)
        a = torch.tanh(self.dense(a))
        out = self.head(self.gather(a, atom_mask))
        if self.mode == 'classification':
            logits = out.reshape(-1, self.n_tasks, self.n_classes)
            return torch.softmax(logits, dim=-1), logits
        return out


class WeaveModel(TorchModel):
    """Weave network (Kearnes et al. 2016), fed by :class:`WeaveFeaturizer`
    (75 atom and 14 pair features): ``n_weave`` atom and pair co-updates of
    width ``n_hidden`` on the dense pair grid, a Gaussian-histogram readout
    of ``n_graph_feat`` and the task head.

    A batch always has ``batch_size`` molecule slots (a short one's labels
    padded, its ghosts weighted 0) and ``A`` atom slots, the batch's
    largest molecule rounded up to ``atom_quantum``; batches of different
    ``A`` cannot be stacked, so ``fit_on_device`` raises on a set whose
    batches differ in ``A``, as the JAX package's does (``fit`` and
    ``predict`` take them one by one).  The module is built at
    construction from a ``torch.Generator`` seeded with ``seed``; load
    flax parameters with :func:`params_from_flax`.  A classifier trains
    on softmax cross entropy, a regressor on squared error, with
    :class:`Adam` at ``learning_rate`` unless ``optimizer`` is given.
    ``fully_connected_layer_sizes`` is accepted for DeepChem's signature
    and not used, as in the JAX package."""

    atom_quantum = 16

    def __init__(self, n_tasks: int, n_atom_feat: int = 75,
                 n_pair_feat: int = 14, n_hidden: int = 50,
                 n_graph_feat: int = 128, n_weave: int = 2,
                 fully_connected_layer_sizes: Sequence[int] = (2000, 100),
                 mode: str = 'classification', n_classes: int = 2,
                 batch_size: int = 100, gaussian_expand: bool = True,
                 learning_rate: float = 0.001,
                 optimizer: Optional[Optimizer] = None,
                 model_dir: Optional[str] = None, log_frequency: int = 100,
                 device=None, seed: int = 0):
        self.n_tasks = n_tasks
        self.mode = mode
        self.n_classes = n_classes
        self.n_pair_feat = n_pair_feat

        def module(generator):
            return _WeaveModule(n_tasks, n_classes, n_weave, n_hidden,
                                n_graph_feat, mode, n_atom_feat, n_pair_feat,
                                gaussian_expand, generator)
        if mode == 'classification':
            loss, output_types = SoftmaxCrossEntropy(), ['prediction', 'loss']
        else:
            loss, output_types = L2Loss(), ['prediction']
        super().__init__(module, loss, output_types=output_types,
                         batch_size=batch_size, model_dir=model_dir,
                         learning_rate=learning_rate, optimizer=optimizer,
                         log_frequency=log_frequency, device=device,
                         seed=seed)

    def build(self, sample_inputs: Sequence[torch.Tensor]) -> None:
        """Checks the batch's atom and pair feature widths against the
        module's."""
        got = (sample_inputs[0].shape[-1], sample_inputs[1].shape[-1])
        want = (self.module.node_features, self.module.pair_features)
        if got != want:
            raise ValueError(f'batch has {got[0]} atom and {got[1]} pair '
                             f'features; the model was built for '
                             f'{want[0]} and {want[1]}')
        super().build(sample_inputs)

    def _weave_inputs(self, X_b) -> List[np.ndarray]:
        graphs = list(X_b)
        B = self.batch_size
        A = _round_up(max(g.num_nodes for g in graphs), self.atom_quantum)
        F = graphs[0].num_node_features
        P = self.n_pair_feat
        atoms = np.zeros((B, A, F), dtype=np.float32)
        pairs = np.zeros((B, A, A, P), dtype=np.float32)
        amask = np.zeros((B, A), dtype=np.float32)
        pmask = np.zeros((B, A, A), dtype=np.float32)
        for i, g in enumerate(graphs):
            n = g.num_nodes
            atoms[i, :n] = g.node_features
            pairs[i, :n, :n] = g.pair_features.reshape(n, n, P)
            amask[i, :n] = 1.0
            pmask[i, :n, :n] = 1.0
        return [atoms, pairs, amask, pmask]

    def compute_features_on_batch(self, X_b) -> List[np.ndarray]:
        """``[atoms [B, A, F], pairs [B, A, A, P], atom_mask [B, A],
        pair_mask [B, A, A]]`` of a batch of Weave graphs, padded as the
        model's batches are (the pair mask covers the diagonal)."""
        return self._weave_inputs(X_b)

    def default_generator(self, dataset: NumpyDataset, epochs: int = 1,
                          mode: str = 'fit', deterministic: bool = True,
                          pad_batches: bool = True):
        """Padded Weave batches; in ``mode='fit'`` a classifier's labels
        become one-hot ``[B, n_tasks, n_classes]``."""
        for _ in range(epochs):
            for (X_b, y_b, w_b, _) in dataset.iterbatches(
                    batch_size=self.batch_size,
                    deterministic=deterministic, pad_batches=False):
                if len(X_b) < self.batch_size:
                    _, y_b, w_b, _ = pad_batch(self.batch_size,
                                               np.zeros(len(X_b)), y_b, w_b,
                                               None)
                if self.mode == 'classification' and y_b is not None \
                        and mode == 'fit':
                    y_b = np.stack([to_one_hot(y_b[:, t], self.n_classes)
                                    for t in range(self.n_tasks)], axis=1)
                yield (self._weave_inputs(X_b), [y_b], [w_b])

    def get_num_tasks(self) -> int:
        return self.n_tasks

    def get_task_type(self) -> str:
        return self.mode


def _linspace_f32(start: float, stop: float, num: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)``'s formula in float32 IEEE
    arithmetic: ``start (1 - s) + stop s`` for ``s = i / (num - 1)``, the
    last point ``stop``.  (XLA's compiled code may fuse it and differ by
    an ulp.)"""
    f = np.float32
    div = num - 1
    step = np.arange(div, dtype=f) / f(div)
    out = f(start) * (f(1) - step) + f(stop) * step
    return torch.from_numpy(np.append(out, f(stop)).astype(f))


class _DTNNModule(nn.Module):
    """DTNN on Coulomb matrices ``[B, A, A]``: the atomic numbers ``z =
    max(2 C_ii, 1e-12)^(1/2.4)`` (an atom where ``round(z)`` is not 0) and
    distances ``d_ij = z_i z_j / max(C_ij, 1e-9)`` recovered on the
    device, ``d`` expanded over ``n_distance`` Gaussians from
    ``distance_min`` to ``distance_max`` (width their spacing, off the
    diagonal and between atoms only), the embedding of ``round(z)``,
    ``n_steps`` :class:`DTNNStep`, ``tanh(Dense(n_hidden))`` (tanh again
    with ``output_activation``) and a per-atom head summed over the
    atoms: ``[B, n_tasks]``."""

    def __init__(self, n_tasks: int, n_embedding: int, n_hidden: int,
                 n_steps: int, n_distance: int, distance_min: float,
                 distance_max: float, output_activation: bool,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_distance = n_distance
        self.distance_min, self.distance_max = distance_min, distance_max
        self.output_activation = output_activation
        self.embedding = DTNNEmbedding(n_embedding, generator=generator)
        self.steps = nn.ModuleList(DTNNStep(n_embedding, n_distance,
                                            generator)
                                   for _ in range(n_steps))
        self.hidden = dense(n_embedding, n_hidden, generator)
        self.out = dense(n_hidden, n_tasks, generator)
        self.register_buffer('centers', _linspace_f32(
            distance_min, distance_max, n_distance), persistent=False)
        self.flax_scopes = {'DTNNEmbedding_0': 'embedding',
                            'Dense_0': 'hidden', 'Dense_1': 'out',
                            **{k: v for i, step in enumerate(self.steps)
                               for k, v in _nested_scopes(
                                   f'DTNNStep_{i}', f'steps.{i}',
                                   step).items()}}
        self.flax_leaves = DTNNEmbedding.flax_leaves

    def forward(self, coulomb: torch.Tensor) -> torch.Tensor:
        diag = torch.diagonal(coulomb, dim1=1, dim2=2)
        z = torch.pow(torch.clamp_min(2.0 * diag, 1e-12), 1.0 / 2.4)
        zi = torch.round(z).long()           # half to even, as jnp.round
        mask = (zi > 0).to(coulomb.dtype)
        zz = z[:, :, None] * z[:, None, :]
        d = zz / torch.clamp_min(coulomb, 1e-9)
        eye = torch.eye(coulomb.shape[1], dtype=coulomb.dtype,
                        device=coulomb.device)
        pair_valid = mask[:, :, None] * mask[:, None, :] * (1.0 - eye)
        width = (self.distance_max - self.distance_min) / self.n_distance
        dist_feat = torch.exp(
            -0.5 * torch.square((d[..., None] - self.centers) / width))
        dist_feat = dist_feat * pair_valid[..., None]
        emb = self.embedding(torch.clamp(zi, 0, 82)) * mask[..., None]
        for step in self.steps:
            emb = step(emb, dist_feat, mask) * mask[..., None]
        h = torch.tanh(self.hidden(emb))
        if self.output_activation:
            h = torch.tanh(h)
        return torch.sum(self.out(h) * mask[..., None], dim=1)


class DTNNModel(TorchModel):
    """Deep Tensor Neural Network (Schütt et al. 2017) for quantum
    properties, fed by :class:`CoulombMatrix`: see :class:`_DTNNModule`.
    The module is built at construction from a ``torch.Generator`` seeded
    with ``seed``; load flax parameters with :func:`params_from_flax`.  It
    trains on squared error with :class:`Adam` at ``learning_rate`` unless
    ``optimizer`` is given."""

    def __init__(self, n_tasks: int, n_embedding: int = 30,
                 n_hidden: int = 100, n_steps: int = 2,
                 n_distance: int = 100, distance_min: float = -1.0,
                 distance_max: float = 18.0,
                 output_activation: bool = True, mode: str = 'regression',
                 batch_size: int = 100, learning_rate: float = 0.001,
                 optimizer: Optional[Optimizer] = None,
                 model_dir: Optional[str] = None, log_frequency: int = 100,
                 device=None, seed: int = 0):
        self.n_tasks = n_tasks
        self.mode = mode

        def module(generator):
            return _DTNNModule(n_tasks, n_embedding, n_hidden, n_steps,
                               n_distance, distance_min, distance_max,
                               output_activation, generator)
        super().__init__(module, L2Loss(), output_types=['prediction'],
                         batch_size=batch_size, model_dir=model_dir,
                         learning_rate=learning_rate, optimizer=optimizer,
                         log_frequency=log_frequency, device=device,
                         seed=seed)

    def compute_features_on_batch(self, X_b):
        """``(atomic numbers [B, A] int32, distances [B, A, A] float32,
        atom mask [B, A] float32)`` recovered from a batch of Coulomb
        matrices on the host, in float64, as the module recovers them on
        the device; distances 0 on the diagonal and off the atoms."""
        coulomb = np.asarray(X_b, dtype=np.float64)
        diag = np.diagonal(coulomb, axis1=1, axis2=2)
        z = np.power(np.maximum(2.0 * diag, 1e-12), 1.0 / 2.4)
        zi = np.round(z).astype(np.int32)
        mask = (zi > 0).astype(np.float32)
        d = z[:, :, None] * z[:, None, :] / np.maximum(coulomb, 1e-9)
        np.einsum('bii->bi', d)[:] = 0.0
        pair_valid = (mask[:, :, None] * mask[:, None, :]
                      * (1.0 - np.eye(coulomb.shape[1])[None]))
        return zi, (d * pair_valid).astype(np.float32), mask

    def get_num_tasks(self) -> int:
        return self.n_tasks

    def get_task_type(self) -> str:
        return self.mode
