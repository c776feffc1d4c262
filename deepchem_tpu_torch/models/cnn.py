"""A 1-, 2- or 3-D convolutional network (DeepChem's ``CNN``).

Counterpart of ``deepchem_tpu/models/cnn.py``: SAME convolutions with
ReLU (with ``residual``, the input added where the widths match), dropout
after each, a max or mean over the spatial axes, a Dense with ReLU and
the task head; with ``uncertainty`` also a log variance head.  As in the
JAX package, every convolution pads SAME whatever ``padding`` says.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from deepchem_tpu_torch.models.conv_layers import (Conv, TaskHead, TaskModel,
                                                   channels_first)
from deepchem_tpu_torch.models.graph_layers import dense
from deepchem_tpu_torch.models.graph_models import (_HostSeededDropout,
                                                    _uncertainty_loss)


class _CNNModule(_HostSeededDropout):

    def __init__(self, n_tasks: int, n_classes: int, dims: int,
                 in_channels: int, layer_filters: Sequence[int],
                 kernel_size: int, dense_layer_size: int, dropout: float,
                 mode: str, residual: bool, pool_type: str,
                 uncertainty: bool,
                 generator: Optional[torch.Generator] = None,
                 dropout_seed: int = 0):
        super().__init__()
        self.dims, self.residual, self.pool_type = dims, residual, pool_type
        self.uncertainty = uncertainty
        self.dropout, self.dropout_seed = dropout, dropout_seed
        widths = [in_channels] + list(layer_filters)
        self.convs = nn.ModuleList(
            Conv(widths[i], f, (kernel_size,) * dims, generator=generator)
            for i, f in enumerate(layer_filters))
        self.dense = dense(widths[-1], dense_layer_size, generator)
        self.head = TaskHead(dense_layer_size, n_tasks, n_classes, mode,
                             generator)
        n = len(layer_filters)
        self.flax_scopes = {**{f'Conv_{i}': f'convs.{i}' for i in range(n)},
                            'Dense_0': 'dense', 'Dense_1': 'head.out'}
        if uncertainty:
            self.log_var = dense(dense_layer_size, n_tasks, generator)
            self.flax_scopes['Dense_2'] = 'log_var'

    def forward(self, x: torch.Tensor):
        x = x.to(self.dense.weight.dtype)
        if x.ndim == self.dims + 1:                 # no channel axis
            x = x[..., None]
        x = channels_first(x)
        for conv in self.convs:
            y = F.relu(conv(x))
            if self.residual and y.shape[1] == x.shape[1]:
                y = y + x
            x = self._dropout(y)
        axes = tuple(range(2, 2 + self.dims))
        # amax shares a tie's gradient out evenly, as jnp.max does
        x = x.mean(dim=axes) if self.pool_type == 'average' \
            else x.amax(dim=axes)
        x = F.relu(self.dense(x))
        out = self.head(x)
        if not self.uncertainty:
            return out
        log_var = self.log_var(x)
        return out, torch.exp(log_var), out, log_var


class CNN(TaskModel):
    """N-dimensional CNN on ``[B, *spatial, C]`` (or ``[B, *spatial]``,
    one channel) inputs of ``n_features`` channels.  Dropout
    (``dropouts``, the first where a list is given) draws its masks on the
    host from a generator seeded with ``seed``.  With ``uncertainty``
    (regression, dropout on) the outputs are the values, their variance
    and log variance, and the loss the Gaussian negative log likelihood.
    The module is built at construction from a ``torch.Generator`` seeded
    with ``seed``; load flax parameters with :func:`params_from_flax`."""

    def __init__(self, n_tasks: int, n_features: int, dims: int,
                 layer_filters: Sequence[int] = (100,),
                 kernel_size: int = 5, weight_init_stddevs=0.02,
                 dense_layer_size: int = 1000, dropouts=0.5,
                 mode: str = 'classification', n_classes: int = 2,
                 uncertainty: bool = False, residual: bool = False,
                 padding: str = 'valid', pool_type: str = 'max',
                 batch_size: int = 100, seed: int = 0, **kwargs):
        if dims not in (1, 2, 3):
            raise ValueError('dims must be 1, 2, or 3')
        self.n_features = n_features
        if isinstance(dropouts, (list, tuple)):
            dropouts = dropouts[0]
        if uncertainty:
            if mode != 'regression':
                raise ValueError('uncertainty requires regression')
            if dropouts == 0:
                raise ValueError('uncertainty requires dropout')
            kwargs.update(loss=_uncertainty_loss, output_types=[
                'prediction', 'variance', 'loss', 'loss'])

        def module(generator):
            return _CNNModule(n_tasks, n_classes, dims, n_features,
                              tuple(layer_filters), kernel_size,
                              dense_layer_size, dropouts, mode, residual,
                              pool_type, uncertainty, generator, seed)
        super().__init__(module, n_tasks, mode, n_classes,
                         batch_size=batch_size, seed=seed, **kwargs)


CNNModel = CNN
