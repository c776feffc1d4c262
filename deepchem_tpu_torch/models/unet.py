"""UNet and InceptionV3 image models.

Counterparts of ``deepchem_tpu/models/unet.py``.  UNet: double 3x3
convolutions at widths 64 to 512 with 2x2 max pools down, flax's 2x2
stride-2 transposed convolutions up (:class:`ConvTranspose`: the kernel
flipped), skip concatenations, a 1x1 convolution and a sigmoid, trained
on binary cross entropy clipped at 1e-7.  InceptionV3: the stem (flax
pads every convolution SAME, the stride-2 one too) with its 3x3 stride-2
max pools (VALID) and two inception-A blocks, whose pool branch averages
3x3 windows padded SAME with the pad counted; the spatial mean and the
task head.  Images come as ``[B, H, W, C]`` (or ``[B, H, W]``) and are
moved to channels-first once; UNet's answer is moved back, ``[B, H, W,
out_channels]``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepchem_tpu_torch.models.conv_layers import (Conv, ConvTranspose,
                                                   TaskHead, TaskModel,
                                                   avg_pool, channels_first,
                                                   channels_last, max_pool)
from deepchem_tpu_torch.models.losses import BinaryCrossEntropy
from deepchem_tpu_torch.models.torch_model import TorchModel

UNET_WIDTHS = (64, 128, 256, 512)


def _image(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    x = x.to(dtype)
    return channels_first(x[..., None] if x.ndim == 3 else x)


class DoubleConv(nn.Module):
    """Two 3x3 SAME convolutions, each with ReLU."""

    def __init__(self, in_channels: int, channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.convs = nn.ModuleList([
            Conv(in_channels, channels, (3, 3), generator=generator),
            Conv(channels, channels, (3, 3), generator=generator)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.convs[1](F.relu(self.convs[0](x))))


class _UNetModule(nn.Module):

    def __init__(self, in_channels: int = 3, out_channels: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        w = UNET_WIDTHS
        ins = (in_channels,) + w[:-1]
        self.down = nn.ModuleList(DoubleConv(a, b, generator)
                                  for a, b in zip(ins, w))
        self.up = nn.ModuleList(
            ConvTranspose(w[i + 1], w[i], (2, 2), (2, 2),
                          generator=generator) for i in (2, 1, 0))
        self.up_convs = nn.ModuleList(DoubleConv(2 * w[i], w[i], generator)
                                      for i in (2, 1, 0))
        self.out = Conv(w[0], out_channels, (1, 1), generator=generator)
        # flax numbers the double convolutions as built: down 0-3, up 4-6
        self.flax_scopes = {
            **{f'_DoubleConv_{i}': f'down.{i}' for i in range(4)},
            **{f'_DoubleConv_{i + 4}': f'up_convs.{i}' for i in range(3)},
            **{f'_DoubleConv_{i}/Conv_{j}': f'convs.{j}' for i in range(7)
               for j in (0, 1)},
            **{f'ConvTranspose_{i}': f'up.{i}' for i in range(3)},
            'Conv_0': 'out'}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _image(x, self.out.weight.dtype)
        skips = []
        for i, block in enumerate(self.down):
            if i:
                x = max_pool(x, (2, 2), (2, 2))
            x = block(x)
            skips.append(x)
        for up, block, skip in zip(self.up, self.up_convs, skips[-2::-1]):
            x = block(torch.cat([up(x), skip], dim=1))
        return channels_last(torch.sigmoid(self.out(x)))


class UNetModel(TorchModel):
    """Image segmentation UNet: ``[B, H, W, in_channels]`` images (H and W
    multiples of 8) to per-pixel probabilities ``[B, H, W,
    out_channels]``.  The module is built at construction from a
    ``torch.Generator`` seeded with ``seed``; load flax parameters with
    :func:`params_from_flax`."""

    def __init__(self, in_channels: int = 3, out_channels: int = 1,
                 batch_size: int = 8, **kwargs):
        self.n_tasks, self.mode = out_channels, 'segmentation'
        super().__init__(
            lambda g: _UNetModule(in_channels, out_channels, g),
            BinaryCrossEntropy(), output_types=['prediction'],
            batch_size=batch_size, **kwargs)

    def get_num_tasks(self) -> int:
        return self.n_tasks

    def get_task_type(self) -> str:
        return self.mode


class InceptionBlockA(nn.Module):
    """Branches 1x1 64; 1x1 48, 5x5 64; 1x1 64, 3x3 96, 3x3 96; a 3x3
    SAME average pool then 1x1 ``pool_features``; concatenated."""

    def __init__(self, channels: int, pool_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()

        def conv(a, b, k):
            return Conv(a, b, (k, k), generator=generator)
        self.convs = nn.ModuleList([
            conv(channels, 64, 1), conv(channels, 48, 1), conv(48, 64, 5),
            conv(channels, 64, 1), conv(64, 96, 3), conv(96, 96, 3),
            conv(channels, pool_features, 1)])
        self.width = 64 + 64 + 96 + pool_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.convs
        b1 = F.relu(c[0](x))
        b2 = F.relu(c[2](F.relu(c[1](x))))
        b3 = F.relu(c[5](F.relu(c[4](F.relu(c[3](x))))))
        b4 = F.relu(c[6](avg_pool(x, (3, 3), (1, 1), 'SAME')))
        return torch.cat([b1, b2, b3, b4], dim=1)


class _InceptionV3Module(nn.Module):

    def __init__(self, n_tasks: int, n_classes: int, mode: str,
                 in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()

        def conv(a, b, k, s=1):
            return Conv(a, b, (k, k), (s, s), generator=generator)
        self.stem = nn.ModuleList([
            conv(in_channels, 32, 3, 2), conv(32, 32, 3), conv(32, 64, 3),
            conv(64, 80, 1), conv(80, 192, 3)])
        a = InceptionBlockA(192, 32, generator)
        self.blocks = nn.ModuleList([a, InceptionBlockA(a.width, 64,
                                                        generator)])
        self.head = TaskHead(self.blocks[1].width, n_tasks, n_classes, mode,
                             generator)
        self.flax_scopes = {
            **{f'Conv_{i}': f'stem.{i}' for i in range(5)},
            **{f'_InceptionBlockA_{i}': f'blocks.{i}' for i in range(2)},
            **{f'_InceptionBlockA_{i}/Conv_{j}': f'convs.{j}'
               for i in range(2) for j in range(7)},
            'Dense_0': 'head.out'}

    def forward(self, x: torch.Tensor):
        s = self.stem
        x = _image(x, s[0].weight.dtype)
        x = F.relu(s[2](F.relu(s[1](F.relu(s[0](x))))))
        x = max_pool(x, (3, 3), (2, 2))
        x = F.relu(s[4](F.relu(s[3](x))))
        x = max_pool(x, (3, 3), (2, 2))
        for block in self.blocks:
            x = block(x)
        return self.head(x.mean(dim=(2, 3)))


class InceptionV3Model(TaskModel):
    """InceptionV3's stem and inception-A blocks over ``[B, H, W, C]``
    images.  The module is built at construction from a
    ``torch.Generator`` seeded with ``seed``; load flax parameters with
    :func:`params_from_flax`."""

    input_dtype = np.float32

    def __init__(self, n_tasks: int = 1, n_classes: int = 2,
                 mode: str = 'classification', batch_size: int = 16,
                 in_channels: int = 3, **kwargs):
        super().__init__(
            lambda g: _InceptionV3Module(n_tasks, n_classes, mode,
                                         in_channels, g),
            n_tasks, mode, n_classes, batch_size=batch_size, **kwargs)
