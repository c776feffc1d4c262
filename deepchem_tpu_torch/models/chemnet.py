"""ChemNet's models: Smiles2Vec and ChemCeption (Goh et al. 2017).

Counterparts of ``deepchem_tpu/models/chemnet.py``.  Smiles2Vec: a
character embedding (looked up by :func:`gather_table_rows`, whose
gradient is P2 in a fixed order), a 1-D convolution, stacked
bidirectional GRUs (each one ``torch.gru`` call, cuDNN on the card;
:class:`GRU`), the mean over time and the task head.  ChemCeption: a 4x4 stride-2 stem (XLA's SAME
padding, one more row after than before on an even size), three
inception-residual blocks, a 2x2 average pool, three more blocks, the
spatial mean and the task head, over ``SmilesToImage``'s ``[B, H, W, 1]``
images, which the module moves to channels-first once.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepchem_tpu_torch.models.conv_layers import (Conv, TaskHead, TaskModel,
                                                   avg_pool, channels_first,
                                                   embedding)
from deepchem_tpu_torch.models.graph_layers import GRU
from deepchem_tpu_torch.ops.segment import gather_table_rows


class _Smiles2VecModule(nn.Module):

    def __init__(self, n_tasks: int, n_classes: int, vocab_size: int,
                 embedding_dim: int, filters: int, kernel_size: int,
                 strides: int, rnn_sizes: Sequence[int], use_conv: bool,
                 mode: str, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding = embedding(vocab_size, embedding_dim, generator)
        self.conv = Conv(embedding_dim, filters, kernel_size, strides,
                         dims=1, generator=generator) if use_conv else None
        widths = [filters if use_conv else embedding_dim] + [
            2 * s for s in rnn_sizes]
        self.grus = nn.ModuleList(
            GRU(widths[i], s, bidirectional=True, generator=generator)
            for i, s in enumerate(rnn_sizes))
        self.head = TaskHead(widths[-1], n_tasks, n_classes, mode, generator)
        self.flax_scopes = {
            'Embed_0': 'embedding', 'Conv_0': 'conv', 'Dense_0': 'head.out',
            **{f'_BiGRU_{i}': f'grus.{i}' for i in range(len(rnn_sizes))},
            **{f'_BiGRU_{i}/GRUCell_{d}': f'cells.{d}'
               for i in range(len(rnn_sizes)) for d in (0, 1)}}

    def forward(self, tokens: torch.Tensor):
        x = gather_table_rows(self.embedding.weight, tokens.long())
        if self.conv is not None:
            x = F.relu(self.conv(x.transpose(1, 2))).transpose(1, 2)
        for gru in self.grus:
            x = gru(x)
        return self.head(x.mean(dim=1))


class Smiles2Vec(TaskModel):
    """Smiles2Vec on ``SmilesToSeq``'s token sequences (``[B, L]``).  The
    vocabulary has ``len(char_to_idx) + 1`` entries.  The GRUs run over
    every token, pads included, as the JAX package's do (no sequence
    lengths).  The module is built at construction from a
    ``torch.Generator`` seeded with ``seed``; load flax parameters with
    :func:`params_from_flax`."""

    input_dtype = np.int32

    def __init__(self, char_to_idx: Dict[str, int], n_tasks: int = 10,
                 max_seq_len: int = 270, embedding_dim: int = 50,
                 n_classes: int = 2, use_bidir: bool = True,
                 use_conv: bool = True, filters: int = 192,
                 kernel_size: int = 3, strides: int = 1,
                 rnn_sizes: Sequence[int] = (224, 384),
                 mode: str = 'regression', batch_size: int = 100,
                 **kwargs):
        self.char_to_idx = char_to_idx

        def module(generator):
            return _Smiles2VecModule(
                n_tasks, n_classes, len(char_to_idx) + 1, embedding_dim,
                filters, kernel_size, strides, tuple(rnn_sizes), use_conv,
                mode, generator)
        super().__init__(module, n_tasks, mode, n_classes,
                         batch_size=batch_size, **kwargs)


Smiles2VecModel = Smiles2Vec


class InceptionBlock(nn.Module):
    """Three branches (1x1; 1x1, 3x3; 1x1, 3x3, 3x3) of ``filters`` each,
    concatenated, a 1x1 back to the input's channels, added to the input,
    ReLU."""

    def __init__(self, channels: int, filters: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()

        def conv(a, b, k):
            return Conv(a, b, (k, k), generator=generator)
        self.convs = nn.ModuleList([
            conv(channels, filters, 1), conv(channels, filters, 1),
            conv(filters, filters, 3), conv(channels, filters, 1),
            conv(filters, filters, 3), conv(filters, filters, 3),
            conv(3 * filters, channels, 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.convs
        b1 = F.relu(c[0](x))
        b2 = F.relu(c[2](F.relu(c[1](x))))
        b3 = F.relu(c[5](F.relu(c[4](F.relu(c[3](x))))))
        return F.relu(x + c[6](torch.cat([b1, b2, b3], dim=1)))


def inception_scopes(prefix: str, attr: str, n: int) -> Dict[str, str]:
    """flax scopes of ``n`` blocks ``<prefix>_<i>`` with ``Conv_j`` in
    them, kept in the module list ``attr`` (each block's ``convs``)."""
    return {**{f'{prefix}_{i}': f'{attr}.{i}' for i in range(n)},
            **{f'{prefix}_{i}/Conv_{j}': f'convs.{j}' for i in range(n)
               for j in range(7)}}


class _ChemCeptionModule(nn.Module):

    def __init__(self, n_tasks: int, n_classes: int, base_filters: int,
                 mode: str, in_channels: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stem = Conv(in_channels, base_filters, (4, 4), (2, 2),
                         generator=generator)
        self.blocks = nn.ModuleList(
            InceptionBlock(base_filters, base_filters * (1 if i < 3 else 2),
                           generator) for i in range(6))
        self.head = TaskHead(base_filters, n_tasks, n_classes, mode,
                             generator)
        self.flax_scopes = {'Conv_0': 'stem', 'Dense_0': 'head.out',
                            **inception_scopes('_InceptionBlock', 'blocks',
                                               6)}

    def forward(self, img: torch.Tensor):
        x = img.to(self.stem.weight.dtype)
        if x.ndim == 3:
            x = x[..., None]
        x = F.relu(self.stem(channels_first(x)))
        for i, block in enumerate(self.blocks):
            if i == 3:
                x = avg_pool(x, (2, 2), (2, 2))
            x = block(x)
        return self.head(x.mean(dim=(2, 3)))


class ChemCeption(TaskModel):
    """ChemCeption on ``SmilesToImage``'s images (``[B, H, W]`` or ``[B,
    H, W, C]``, C 1 by default).  The module is built at construction from
    a ``torch.Generator`` seeded with ``seed``; load flax parameters with
    :func:`params_from_flax`."""

    input_dtype = np.float32

    def __init__(self, img_spec: str = 'std', img_size: int = 80,
                 base_filters: int = 16, inception_blocks=None,
                 n_tasks: int = 10, n_classes: int = 2,
                 augment: bool = False, mode: str = 'regression',
                 batch_size: int = 100, in_channels: int = 1, **kwargs):

        def module(generator):
            return _ChemCeptionModule(n_tasks, n_classes, base_filters, mode,
                                      in_channels, generator)
        super().__init__(module, n_tasks, mode, n_classes,
                         batch_size=batch_size, **kwargs)


ChemCeptionModel = ChemCeption
