"""flax's ``nn.Conv``, ``nn.ConvTranspose``, ``max_pool`` and
``avg_pool`` over channels-first tensors (NCL, NCHW, NCDHW), as the
sequence and image models use them, on cuDNN.

Where torch's defaults differ from flax's, these layers take flax's:

- ``padding='SAME'`` is XLA's: ``ceil(n / s)`` outputs, the pad total
  ``max((ceil(n / s) - 1) s + k - n, 0)`` split ``total // 2`` before and
  the rest after, so a stride-2 convolution over an even size pads one
  more after than before (torch refuses ``'same'`` at a stride above 1);
- ``nn.ConvTranspose`` (``transpose_kernel=False``) correlates the
  stride-dilated input with its kernel unflipped, which is torch's
  ``conv_transpose`` with the kernel flipped in every spatial axis;
- ``avg_pool(..., padding='SAME')`` pads with zeros and divides by the
  whole window (``count_include_pad``).

Each layer keeps the flax kernel layout's conversion
(:meth:`Conv.flax_tensor`), which ``models/convert.py`` calls for the
tensors it owns.  Also here: flax's ``nn.Embed`` draw, and the task head
and engine class the sequence and image models share.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepchem_tpu_torch.metrics import to_one_hot
from deepchem_tpu_torch.models.graph_layers import dense, lecun_normal_
from deepchem_tpu_torch.models.losses import L2Loss, SoftmaxCrossEntropy
from deepchem_tpu_torch.models.torch_model import TorchModel

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}
_MAX = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _tuple(v: Union[int, Sequence[int]], n: int) -> Tuple[int, ...]:
    return tuple(v) if isinstance(v, (tuple, list)) else (int(v),) * n


def same_pads(sizes: Sequence[int], kernel: Sequence[int],
              strides: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """XLA's SAME padding, ``(before, after)`` for each spatial axis."""
    pads = []
    for n, k, s in zip(sizes, kernel, strides):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def _pad(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    """``x`` padded by ``pads`` (before, after) on its trailing axes."""
    flat = [p for before_after in reversed(pads) for p in before_after]
    return F.pad(x, flat, value=value) if any(flat) else x


def _padded(x: torch.Tensor, kernel, strides, padding: str,
            value: float = 0.0):
    """``x`` padded as ``padding`` asks and the pad to give the op itself:
    a symmetric SAME pad goes to the op, an asymmetric one is applied
    here."""
    if padding == 'VALID':
        return x, 0
    if padding != 'SAME':
        raise ValueError(f'padding {padding!r}: SAME or VALID')
    pads = same_pads(x.shape[2:], kernel, strides)
    if all(a == b for a, b in pads) and value == 0.0:
        return x, tuple(a for a, _ in pads)
    return _pad(x, pads, value), 0


class Conv(nn.Module):
    """flax ``nn.Conv(features, kernel_size, strides, padding)`` on
    ``[B, C, *spatial]``: weight ``[out, in, *k]`` (the flax kernel ``[*k,
    in, out]`` moved), bias ``[out]``; kernel drawn as flax's
    ``lecun_normal`` (fan-in ``in * prod(k)``), bias zero."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Union[int, Sequence[int]],
                 strides: Union[int, Sequence[int]] = 1,
                 padding: str = 'SAME', dims: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = dims or (len(kernel_size) if isinstance(
            kernel_size, (tuple, list)) else 1)
        self.kernel_size = _tuple(kernel_size, dims)
        self.strides = _tuple(strides, dims)
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(
            (features, in_features) + self.kernel_size))
        lecun_normal_(self.weight, generator,
                      fan_in=math.prod(self.weight.shape[1:]))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, pad = _padded(x, self.kernel_size, self.strides, self.padding)
        return _CONV[len(self.kernel_size)](x, self.weight, self.bias,
                                            self.strides, pad)

    @staticmethod
    def flax_tensor(leaf: str, value) -> torch.Tensor:
        """The port's tensor of a flax leaf: a kernel ``[*k, in, out]``
        becomes ``[out, in, *k]``."""
        a = np.asarray(value, dtype=np.float32)
        if leaf == 'weight':
            d = a.ndim - 2
            a = a.transpose((d + 1, d) + tuple(range(d)))
        return torch.from_numpy(np.array(a))


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose(features, kernel_size, strides,
    padding='SAME')`` (kernel not transposed) on ``[B, C, *spatial]``:
    weight ``[in, out, *k]``, the flax kernel ``[*k, in, out]`` moved and
    flipped in every spatial axis, so torch's ``conv_transpose`` computes
    flax's product."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int], strides: Sequence[int],
                 padding: str = 'SAME',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = len(kernel_size)
        self.kernel_size = _tuple(kernel_size, dims)
        self.strides = _tuple(strides, dims)
        if padding not in ('SAME', 'VALID'):
            raise ValueError(f'padding {padding!r}: SAME or VALID')
        self.padding = padding
        w = torch.empty((features, in_features) + self.kernel_size)
        lecun_normal_(w, generator, fan_in=math.prod(w.shape[1:]))
        self.weight = nn.Parameter(w.transpose(0, 1).contiguous())
        self.bias = nn.Parameter(torch.zeros(features))

    def _crops(self) -> Tuple[Tuple[int, int], ...]:
        """For each axis, the rows of torch's unpadded output to drop
        before and after (negative: zero rows to add) to give
        ``lax.conv_transpose``'s output."""
        out = []
        for k, s in zip(self.kernel_size, self.strides):
            if self.padding == 'SAME':
                total = k + s - 2
                before = k - 1 if s > k - 1 else math.ceil(total / 2)
            else:
                total, before = k + s - 2 + max(k - s, 0), k - 1
            out.append((k - 1 - before, k - 1 - (total - before)))
        return tuple(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = _CONV_T[len(self.kernel_size)]
        crops = self._crops()
        if all(a == b >= 0 for a, b in crops):
            return fn(x, self.weight, self.bias, self.strides,
                      tuple(a for a, _ in crops))
        y = fn(x, self.weight, None, self.strides)
        # a negative crop is a pad: F.pad crops on a negative width
        y = _pad(y, tuple((-a, -b) for a, b in crops))
        return y + self.bias.reshape((-1,) + (1,) * len(crops))

    @staticmethod
    def flax_tensor(leaf: str, value) -> torch.Tensor:
        """A kernel ``[*k, in, out]`` becomes ``[in, out, *k]`` flipped in
        every spatial axis."""
        a = np.asarray(value, dtype=np.float32)
        if leaf == 'weight':
            d = a.ndim - 2
            a = np.flip(a, axis=tuple(range(d))).transpose(
                (d, d + 1) + tuple(range(d)))
        return torch.from_numpy(np.array(a))


def max_pool(x: torch.Tensor, window: Sequence[int],
             strides: Optional[Sequence[int]] = None,
             padding: str = 'VALID') -> torch.Tensor:
    """flax ``nn.max_pool`` on ``[B, C, *spatial]`` (SAME pads with
    -inf)."""
    strides = tuple(strides or (1,) * len(window))
    x, pad = _padded(x, window, strides, padding, value=-math.inf)
    return _MAX[len(window)](x, tuple(window), strides, pad)


def avg_pool(x: torch.Tensor, window: Sequence[int],
             strides: Optional[Sequence[int]] = None,
             padding: str = 'VALID') -> torch.Tensor:
    """flax ``nn.avg_pool`` on ``[B, C, *spatial]``: a SAME pad's zeros
    count in the mean (``count_include_pad``, flax's default)."""
    strides = tuple(strides or (1,) * len(window))
    x, pad = _padded(x, window, strides, padding)
    return _AVG[len(window)](x, tuple(window), strides, pad,
                             count_include_pad=True)


def channels_first(x: torch.Tensor) -> torch.Tensor:
    """``[B, *spatial, C]`` (flax's layout) as a contiguous ``[B, C,
    *spatial]``: a moved view keeps the channels-last strides, and on the
    card the ops then take their channels-last kernels, whose pooling
    backward put InceptionV3's step-1 gradients up to 2.8e-3 of max(1,
    |g|) off the CPU's."""
    return x.movedim(-1, 1).contiguous()


def channels_last(x: torch.Tensor) -> torch.Tensor:
    """``[B, C, *spatial]`` as ``[B, *spatial, C]``."""
    return x.movedim(1, -1)



def embedding(num: int, features: int,
              generator: Optional[torch.Generator] = None) -> nn.Embedding:
    """``nn.Embedding`` drawn as flax's ``nn.Embed``: a normal of variance
    ``1 / features`` (``variance_scaling(1, 'fan_in', 'normal',
    out_axis=0)``)."""
    layer = nn.Embedding(num, features)
    with torch.no_grad():
        layer.weight.normal_(0.0, features ** -0.5, generator=generator)
    return layer


class TaskHead(nn.Module):
    """The sequence and image models' output layer: a classifier's class
    probabilities and logits ``[B, n_tasks, n_classes]`` from one Dense of
    ``n_tasks * n_classes``, a regressor's values ``[B, n_tasks]``."""

    def __init__(self, in_features: int, n_tasks: int, n_classes: int,
                 mode: str, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_tasks, self.n_classes, self.mode = n_tasks, n_classes, mode
        self.out = dense(in_features, n_tasks * n_classes
                         if mode == 'classification' else n_tasks, generator)

    def forward(self, x: torch.Tensor):
        y = self.out(x)
        if self.mode != 'classification':
            return y
        logits = y.reshape(-1, self.n_tasks, self.n_classes)
        return torch.softmax(logits, dim=-1), logits


class TaskModel(TorchModel):
    """A :class:`TaskHead` model in the engine: softmax cross entropy over
    the logits and one-hot labels for a classifier, squared error for a
    regressor; ``default_generator`` gives the inputs as ``dtype`` (as
    they are with none) and, when fitting a classifier, the labels one-hot
    ``[B, n_tasks, n_classes]``."""

    input_dtype = None

    def __init__(self, module, n_tasks: int, mode: str, n_classes: int,
                 **kwargs):
        if mode not in ('classification', 'regression'):
            raise ValueError(f'mode {mode!r}: classification or regression')
        self.n_tasks, self.mode, self.n_classes = n_tasks, mode, n_classes
        if mode == 'classification':
            loss, output_types = SoftmaxCrossEntropy(), ['prediction', 'loss']
        else:
            loss, output_types = L2Loss(), ['prediction']
        kwargs.setdefault('output_types', output_types)
        super().__init__(module, kwargs.pop('loss', loss), **kwargs)

    def _inputs(self, X_b, ids_b) -> List:
        X_b = np.asarray(X_b)
        return [X_b if self.input_dtype is None
                else X_b.astype(self.input_dtype)]

    def default_generator(self, dataset, epochs: int = 1, mode: str = 'fit',
                          deterministic: bool = True,
                          pad_batches: bool = True):
        for _ in range(epochs):
            for (X_b, y_b, w_b, ids_b) in dataset.iterbatches(
                    batch_size=self.batch_size, deterministic=deterministic,
                    pad_batches=pad_batches):
                if self.mode == 'classification' and y_b is not None \
                        and mode == 'fit':
                    y_b = np.stack([to_one_hot(y_b[:, t], self.n_classes)
                                    for t in range(self.n_tasks)], axis=1)
                yield (self._inputs(X_b, ids_b), [y_b], [w_b])

    def get_num_tasks(self) -> int:
        return self.n_tasks

    def get_task_type(self) -> str:
        return self.mode
