"""Fully connected multitask networks on fingerprints: the ``tf``,
``tf_robust`` and ``tf_regression`` baselines.

Counterparts of ``deepchem_tpu/models/fcnet.py``'s ``_activation``,
``_MLPTrunk``, ``MultitaskClassifier``, ``MultitaskRegressor``,
``MultitaskFitTransformRegressor``, ``_weight_decay_regularizer``,
``RobustMultitaskClassifier`` and ``RobustMultitaskRegressor``.  Every
product is an ``nn.Linear`` on cuBLAS: the JAX package runs these models
through ``nn.Dense`` and no kernel of its own.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepchem_tpu_torch.metrics import to_one_hot
from deepchem_tpu_torch.models.graph_layers import dense
from deepchem_tpu_torch.models.graph_models import (_SeededDropout,
                                                    _uncertainty_loss)
from deepchem_tpu_torch.models.losses import L2Loss, SoftmaxCrossEntropy
from deepchem_tpu_torch.models.torch_model import TorchModel

_ACTIVATIONS = {
    'relu': F.relu, 'tanh': torch.tanh, 'sigmoid': torch.sigmoid,
    'gelu': lambda x: F.gelu(x, approximate='tanh'), 'elu': F.elu,
    'selu': F.selu, 'leaky_relu': lambda x: F.leaky_relu(x, 0.01),
    'linear': lambda x: x}


def _activation(name) -> Callable:
    """A callable as it is, else the activation of that name (flax's
    ``gelu`` is the tanh approximation, its ``leaky_relu`` slope 0.01)."""
    if callable(name):
        return name
    return _ACTIVATIONS[str(name).lower()]


def _per_layer(value, n: int) -> List:
    if isinstance(value, (list, tuple)):
        if len(value) != n:
            raise ValueError(f'{value} does not give one value per layer '
                             f'of {n}')
        return list(value)
    return [value] * n


def truncated_dense(in_features: int, out_features: int, stddev: float,
                    bias: float = 0.0,
                    generator: Optional[torch.Generator] = None) -> nn.Linear:
    """``nn.Linear`` initialised as flax's ``Dense`` with
    ``truncated_normal(stddev)`` kernels (a normal of standard deviation
    ``stddev`` cut at two of them) and a constant bias."""
    layer = nn.Linear(in_features, out_features)
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, std=stddev, a=-2 * stddev,
                              b=2 * stddev, generator=generator)
        layer.bias.fill_(bias)
    return layer


def _no_kfac(use_kfac: bool) -> None:
    if use_kfac:
        raise NotImplementedError(
            'use_kfac=True needs the KFAC optimizer and its KFACDense '
            'curvature probes (deepchem_tpu/models/kfac.py), which are not '
            'ported')


class _MLPTrunk(_SeededDropout):
    """Dense layers, each with its activation and dropout; with
    ``residual``, pre-activation residual blocks (``y = dense(act(x)) +
    x`` where consecutive widths match, the last activation after the
    loop)."""

    def __init__(self, in_features: int, layer_sizes: Sequence[int],
                 dropouts: Sequence[float], activation_fns: Sequence,
                 weight_init_stddevs: Sequence[float],
                 bias_init_consts: Sequence[float], residual: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dropout_seed: int = 0):
        super().__init__()
        widths = [in_features] + list(layer_sizes)
        self.layers = nn.ModuleList(
            truncated_dense(a, b, s, c, generator) for a, b, s, c in zip(
                widths[:-1], widths[1:], weight_init_stddevs,
                bias_init_consts))
        self.dropouts = list(dropouts)
        self.activations = [_activation(a) for a in activation_fns]
        self.residual = residual
        self.dropout, self.dropout_seed = 0.0, dropout_seed

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.residual:
            for layer, act, rate in zip(self.layers, self.activations,
                                        self.dropouts):
                x = self._dropout(act(layer(x)), rate)
            return x
        act = None
        for layer, next_act, rate in zip(self.layers, self.activations,
                                         self.dropouts):
            y = self._dropout(layer(x if act is None else act(x)), rate)
            x = x + y if x.shape[-1] == y.shape[-1] else y
            act = next_act
        return x if act is None else act(x)


class _MultitaskModule(nn.Module):
    """The trunk and the output head: class probabilities and logits
    ``[B, n_tasks, n_classes]`` for a classifier (``n_classes`` given),
    else values ``[B, n_tasks]``, with ``uncertainty`` also the variance
    (``uncertainty_head``'s exp) and the log variance."""

    def __init__(self, n_features: int, n_tasks: int,
                 n_classes: Optional[int], layer_sizes: Sequence[int],
                 dropouts, activation_fns, weight_init_stddevs,
                 bias_init_consts, uncertainty: bool = False,
                 residual: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dropout_seed: int = 0):
        super().__init__()
        n = len(layer_sizes)
        self.n_tasks, self.n_classes = n_tasks, n_classes
        self.trunk = _MLPTrunk(
            n_features, layer_sizes, _per_layer(dropouts, n),
            _per_layer(activation_fns, n), _per_layer(weight_init_stddevs, n),
            _per_layer(bias_init_consts, n), residual, generator,
            dropout_seed)
        width = layer_sizes[-1] if n else n_features
        self.output_head = dense(width, n_tasks * (n_classes or 1),
                                 generator)
        self.uncertainty_head = dense(width, n_tasks, generator) \
            if uncertainty else None
        # flax scope (or scope path) -> attribute (models/convert.py)
        self.flax_scopes = {'_MLPTrunk_0': 'trunk',
                            **{f'_MLPTrunk_0/Dense_{i}': f'layers.{i}'
                               for i in range(n)}}

    def forward(self, x: torch.Tensor):
        x = self.trunk(x)
        y = self.output_head(x)
        if self.n_classes:
            logits = y.reshape(-1, self.n_tasks, self.n_classes)
            return torch.softmax(logits, dim=-1), logits
        if self.uncertainty_head is not None:
            log_var = self.uncertainty_head(x)
            return y, torch.exp(log_var), y, log_var
        return y


def _weight_decay_regularizer(penalty: float, penalty_type: str
                              ) -> Callable[[nn.Module], torch.Tensor]:
    """``penalty * Σ|w|`` (l1) or ``penalty * Σ w²`` (l2) over the trunk's
    weights, biases and heads left out, as a ``regularization_loss`` of
    the module."""
    if penalty_type not in ('l1', 'l2'):
        raise ValueError(f'unsupported weight_decay_penalty_type '
                         f"{penalty_type!r}; expected 'l1' or 'l2'")

    def reg(module: nn.Module) -> torch.Tensor:
        ws = [layer.weight for layer in module.trunk.layers]
        return penalty * sum(w.abs().sum() if penalty_type == 'l1'
                             else w.square().sum() for w in ws)
    return reg


class _FingerprintModel(TorchModel):
    """A fingerprint model: the module is built at construction from a
    ``torch.Generator`` seeded with ``seed`` (which also seeds dropout);
    load trained flax parameters with :func:`params_from_flax`.
    :class:`Adam` at ``learning_rate`` unless ``optimizer`` is given;
    ``weight_decay_penalty`` (where a model takes it) becomes the
    ``regularization_loss``."""

    def get_num_tasks(self) -> int:
        return self.n_tasks


class _OneHotLabels:
    """``default_generator`` of a classifier: in ``mode='fit'`` the labels
    become one-hot ``[B, n_tasks, n_classes]``."""

    def default_generator(self, dataset, epochs: int = 1, mode: str = 'fit',
                          deterministic: bool = True,
                          pad_batches: bool = True):
        for _ in range(epochs):
            for (X_b, y_b, w_b, _) in dataset.iterbatches(
                    batch_size=self.batch_size, deterministic=deterministic,
                    pad_batches=pad_batches):
                if y_b is not None and mode == 'fit':
                    y_b = np.stack([to_one_hot(y_b[:, t], self.n_classes)
                                    for t in range(self.n_tasks)], axis=1)
                yield ([X_b], [y_b], [w_b])

    def get_task_type(self) -> str:
        return 'classification'


_COMMON = dict(batch_size=100, learning_rate=0.001, optimizer=None,
               model_dir=None, log_frequency=100, device=None, seed=0)


def _common(kwargs) -> dict:
    """The engine's arguments, with their defaults, out of ``kwargs``."""
    out = {k: kwargs.pop(k, v) for k, v in _COMMON.items()}
    if kwargs:
        raise TypeError(f'unexpected arguments {sorted(kwargs)}')
    return out


class MultitaskClassifier(_OneHotLabels, _FingerprintModel):
    """A fully connected classifier over fingerprints, DeepChem's ``tf``
    baseline: ``layer_sizes`` dense layers (weights a normal of
    ``weight_init_stddevs`` cut at two deviations, biases
    ``bias_init_consts``), each with its activation and dropout, then one
    softmax head of ``n_tasks * n_classes``; softmax cross entropy on the
    logits, with ``weight_decay_penalty`` on the trunk's weights.
    ``use_kfac`` raises: KFAC is not ported.  Engine arguments:
    ``batch_size`` (100), ``learning_rate``, ``optimizer``, ``model_dir``,
    ``log_frequency``, ``device``, ``seed`` (see :class:`TorchModel`)."""

    def __init__(self, n_tasks: int, n_features: int,
                 layer_sizes: Sequence[int] = (1000,),
                 weight_init_stddevs: Union[float, Sequence[float]] = 0.02,
                 bias_init_consts: Union[float, Sequence[float]] = 1.0,
                 weight_decay_penalty: float = 0.0,
                 weight_decay_penalty_type: str = 'l2',
                 dropouts: Union[float, Sequence[float]] = 0.5,
                 activation_fns: Union[Any, Sequence] = 'relu',
                 n_classes: int = 2, use_kfac: bool = False,
                 residual: bool = False, **kwargs):
        _no_kfac(use_kfac)
        self.n_tasks, self.n_features = n_tasks, n_features
        self.n_classes = n_classes
        common = _common(kwargs)
        seed = common['seed']

        def module(generator):
            return _MultitaskModule(
                n_features, n_tasks, n_classes, tuple(layer_sizes), dropouts,
                activation_fns, weight_init_stddevs, bias_init_consts,
                residual=residual, generator=generator, dropout_seed=seed)
        reg = _weight_decay_regularizer(
            weight_decay_penalty, weight_decay_penalty_type) \
            if weight_decay_penalty != 0.0 else None
        super().__init__(module, SoftmaxCrossEntropy(),
                         ['prediction', 'loss'], regularization_loss=reg,
                         **common)
        self._head_scopes = ('output_head',)


class MultitaskRegressor(_FingerprintModel):
    """A fully connected regressor over fingerprints, DeepChem's
    ``tf_regression``: the trunk of :class:`MultitaskClassifier` and an
    ``n_tasks`` head on squared error; with ``uncertainty`` (which needs
    dropout on some layer) also a log-variance head, trained on the
    Gaussian likelihood and read by ``predict_uncertainty``."""

    def __init__(self, n_tasks: int, n_features: int,
                 layer_sizes: Sequence[int] = (1000,),
                 weight_init_stddevs: Union[float, Sequence[float]] = 0.02,
                 bias_init_consts: Union[float, Sequence[float]] = 1.0,
                 weight_decay_penalty: float = 0.0,
                 weight_decay_penalty_type: str = 'l2',
                 dropouts: Union[float, Sequence[float]] = 0.5,
                 activation_fns: Union[Any, Sequence] = 'relu',
                 uncertainty: bool = False, use_kfac: bool = False,
                 residual: bool = False, **kwargs):
        _no_kfac(use_kfac)
        self.n_tasks, self.n_features = n_tasks, n_features
        self.uncertainty = uncertainty
        if uncertainty and all(d == 0.0 for d in
                               _per_layer(dropouts, len(layer_sizes))):
            raise ValueError('uncertainty requires dropout on some layer')
        common = _common(kwargs)
        seed = common['seed']

        def module(generator):
            return _MultitaskModule(
                n_features, n_tasks, None, tuple(layer_sizes), dropouts,
                activation_fns, weight_init_stddevs, bias_init_consts,
                uncertainty=uncertainty, residual=residual,
                generator=generator, dropout_seed=seed)
        if uncertainty:
            loss = _uncertainty_loss
            output_types = ['prediction', 'variance', 'loss', 'loss']
        else:
            loss, output_types = L2Loss(), ['prediction']
        reg = _weight_decay_regularizer(
            weight_decay_penalty, weight_decay_penalty_type) \
            if weight_decay_penalty != 0.0 else None
        super().__init__(module, loss, output_types,
                         regularization_loss=reg, **common)
        self._head_scopes = ('output_head', 'uncertainty_head')

    def get_task_type(self) -> str:
        return 'regression'


class MultitaskFitTransformRegressor(MultitaskRegressor):
    """:class:`MultitaskRegressor` whose batches go through
    ``fit_transformers`` (each one's ``transform_array`` of X) before the
    module; ``n_features`` may be a shape, flattened, and becomes the
    width of the transformed features."""

    def __init__(self, n_tasks: int, n_features,
                 fit_transformers: Sequence = (), **kwargs):
        self.fit_transformers = list(fit_transformers)
        if isinstance(n_features, (list, tuple)):
            n_features = int(np.prod(n_features))
        if self.fit_transformers:
            probe = np.zeros((2, n_features))
            for t in self.fit_transformers:
                probe, _, _, _ = t.transform_array(probe, None, None, None)
            n_features = probe.shape[1]
        super().__init__(n_tasks, n_features, **kwargs)

    def default_generator(self, dataset, epochs: int = 1, mode: str = 'fit',
                          deterministic: bool = True,
                          pad_batches: bool = True):
        for _ in range(epochs):
            for (X_b, y_b, w_b, _) in dataset.iterbatches(
                    batch_size=self.batch_size, deterministic=deterministic,
                    pad_batches=pad_batches):
                X_t = np.asarray(X_b, dtype=float)
                if X_t.ndim > 2:
                    X_t = X_t.reshape(len(X_t), -1)
                for t in self.fit_transformers:
                    X_t, _, _, _ = t.transform_array(X_t, None, None, None)
                yield ([X_t], [y_b], [w_b])


class _RobustMultitaskModule(_SeededDropout):
    """A shared trunk and, per task, a bypass trunk of the raw input; each
    task's head reads ``[shared ; bypass]``.  Trunk weights a normal of
    0.02 cut at two deviations, biases 0; dropout after each ReLU."""

    def __init__(self, n_features: int, n_tasks: int,
                 n_outputs_per_task: int, layer_sizes: Sequence[int],
                 bypass_layer_sizes: Sequence[int], dropouts, bypass_dropouts,
                 classification: bool,
                 generator: Optional[torch.Generator] = None,
                 dropout_seed: int = 0):
        super().__init__()
        self.classification = classification
        self.dropouts = _per_layer(dropouts, len(layer_sizes))
        self.bypass_dropouts = _per_layer(bypass_dropouts,
                                          len(bypass_layer_sizes))
        self.dropout, self.dropout_seed = 0.0, dropout_seed
        widths = [n_features] + list(layer_sizes)
        bypass = [n_features] + list(bypass_layer_sizes)
        self.shared = nn.ModuleList(
            truncated_dense(a, b, 0.02, generator=generator)
            for a, b in zip(widths[:-1], widths[1:]))
        self.bypass = nn.ModuleList()
        self.heads = nn.ModuleList()
        # flax numbers its Dense scopes in creation order: the shared
        # layers, then per task its bypass layers and its head
        scopes = {f'Dense_{i}': f'shared.{i}' for i in range(len(self.shared))}
        k = len(self.shared)
        for t in range(n_tasks):
            self.bypass.append(nn.ModuleList(
                truncated_dense(a, b, 0.02, generator=generator)
                for a, b in zip(bypass[:-1], bypass[1:])))
            self.heads.append(dense(widths[-1] + bypass[-1],
                                    n_outputs_per_task, generator))
            for j in range(len(bypass) - 1):
                scopes[f'Dense_{k}'] = f'bypass.{t}.{j}'
                k += 1
            scopes[f'Dense_{k}'] = f'heads.{t}'
            k += 1
        self.flax_scopes = scopes

    def forward(self, x: torch.Tensor):
        shared = x
        for layer, rate in zip(self.shared, self.dropouts):
            shared = self._dropout(F.relu(layer(shared)), rate)
        outs = []
        for bypass_layers, head in zip(self.bypass, self.heads):
            b = x
            for layer, rate in zip(bypass_layers, self.bypass_dropouts):
                b = self._dropout(F.relu(layer(b)), rate)
            outs.append(head(torch.cat([shared, b], dim=1)))
        out = torch.stack(outs, dim=1)          # [B, n_tasks, n_out]
        if self.classification:
            return torch.softmax(out, dim=-1), out
        return out[:, :, 0]


class RobustMultitaskClassifier(_OneHotLabels, _FingerprintModel):
    """DeepChem's ``tf_robust`` baseline: a shared trunk of
    ``layer_sizes`` and a bypass trunk of ``bypass_layer_sizes`` per task,
    softmax cross entropy on the logits ``[B, n_tasks, n_classes]``."""

    def __init__(self, n_tasks: int, n_features: int,
                 layer_sizes: Sequence[int] = (500,),
                 bypass_layer_sizes: Sequence[int] = (100,),
                 dropouts: Union[float, Sequence[float]] = 0.5,
                 bypass_dropouts: Union[float, Sequence[float]] = 0.5,
                 n_classes: int = 2, **kwargs):
        self.n_tasks, self.n_features = n_tasks, n_features
        self.n_classes = n_classes
        common = _common(kwargs)
        seed = common['seed']

        def module(generator):
            return _RobustMultitaskModule(
                n_features, n_tasks, n_classes, tuple(layer_sizes),
                tuple(bypass_layer_sizes), dropouts, bypass_dropouts, True,
                generator, seed)
        super().__init__(module, SoftmaxCrossEntropy(),
                         ['prediction', 'loss'], **common)


class RobustMultitaskRegressor(_FingerprintModel):
    """The regression form of :class:`RobustMultitaskClassifier`: one value
    a task, squared error."""

    def __init__(self, n_tasks: int, n_features: int,
                 layer_sizes: Sequence[int] = (500,),
                 bypass_layer_sizes: Sequence[int] = (100,),
                 dropouts: Union[float, Sequence[float]] = 0.5,
                 bypass_dropouts: Union[float, Sequence[float]] = 0.5,
                 **kwargs):
        self.n_tasks, self.n_features = n_tasks, n_features
        common = _common(kwargs)
        seed = common['seed']

        def module(generator):
            return _RobustMultitaskModule(
                n_features, n_tasks, 1, tuple(layer_sizes),
                tuple(bypass_layer_sizes), dropouts, bypass_dropouts, False,
                generator, seed)
        super().__init__(module, L2Loss(), ['prediction'], **common)

    def get_task_type(self) -> str:
        return 'regression'
