"""OneFormer-style semantic segmentation.

Counterpart of ``deepchem_tpu/models/oneformer.py``: a convolutional
pyramid (strides 4, 8, 16, 32; each stage two 3x3 SAME convolutions, each
followed by a LayerNorm over the channels and GELU), an FPN pixel decoder
to stride 4 (upsampled by nearest neighbour), learnable queries
conditioned on a task embedding, decoder blocks of cross-attention over
the stride-16 tokens, self-attention and an MLP, then class logits, mask
embeddings, per-query masks and the composed semantic map
``log(sum_q p(class k | q) sigmoid(mask_q) + 1e-6)``.  The loss is the
JAX package's: composed per-pixel cross entropy, per-query mask binary
cross entropy and dice under the fixed query-to-class matching of the
semantic task, and the class heads' cross entropy.

flax's defaults, kept here: ``nn.LayerNorm``'s epsilon is 1e-6;
``nn.gelu`` is the tanh approximation; ``MultiHeadDotProductAttention``
has separate query, key, value and output ``DenseGeneral`` layers with
biases and scales the queries by ``1 / sqrt(head_dim)``;
``jax.image.resize(..., 'nearest')`` samples at half-pixel centres, which
is torch's ``'nearest-exact'`` (``'nearest'`` picks other pixels).  The
attention is plain matmuls and a softmax on cuBLAS, as the JAX package
computes it.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepchem_tpu_torch.models.conv_layers import (Conv, channels_first,
                                                   channels_last, embedding)
from deepchem_tpu_torch.models.graph_layers import dense, lecun_normal_
from deepchem_tpu_torch.models.torch_model import TorchModel

TASKS = ('semantic', 'instance', 'panoptic')
LN_EPS = 1e-6                   # flax nn.LayerNorm's default


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate='tanh')


def resize_nearest(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(x, ..., 'nearest')`` of ``[B, C, *spatial]`` to
    ``size``: the input pixel under each output pixel's centre."""
    return F.interpolate(x, size=tuple(size), mode='nearest-exact')


def layer_norm(width: int) -> nn.LayerNorm:
    return nn.LayerNorm(width, eps=LN_EPS)


class DenseGeneral(nn.Linear):
    """An ``nn.Linear`` loaded from a flax ``DenseGeneral``: a kernel
    ``[in, heads, head_dim]`` (or ``[heads, head_dim, out]``) flattened to
    ``[in, out]`` and transposed, the bias flattened."""

    def flax_tensor(self, leaf: str, value) -> torch.Tensor:
        a = np.asarray(value, dtype=np.float32)
        a = a.reshape(self.in_features, self.out_features).T \
            if leaf == 'weight' else a.reshape(-1)
        return torch.from_numpy(np.array(a))


def dense_general(in_features: int, out_features: int,
                  generator: Optional[torch.Generator] = None
                  ) -> DenseGeneral:
    layer = DenseGeneral(in_features, out_features)
    lecun_normal_(layer.weight, generator)
    with torch.no_grad():
        layer.bias.zero_()
    return layer


class MultiHeadDotProductAttention(nn.Module):
    """flax's ``nn.MultiHeadDotProductAttention(num_heads)`` with its
    defaults: ``query``, ``key``, ``value`` and ``out`` projections of the
    query's width, each with a bias, ``softmax(q k^T / sqrt(head_dim))
    v``.  The output projection's flax kernel is ``[heads, head_dim,
    out]``, its fan-in ``heads * head_dim``."""

    def __init__(self, width: int, heads: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.heads = heads
        self.query = dense_general(width, width, generator)
        self.key = dense_general(width, width, generator)
        self.value = dense_general(width, width, generator)
        self.out = dense_general(width, width, generator)

    def forward(self, q: torch.Tensor,
                kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        kv = q if kv is None else kv
        B, Lq, C = q.shape
        H, D = self.heads, C // self.heads

        def split(t):
            return t.reshape(B, -1, H, D).transpose(1, 2)   # [B, H, L, D]
        qh = split(self.query(q)) / math.sqrt(D)
        kh, vh = split(self.key(kv)), split(self.value(kv))
        p = torch.softmax(qh @ kh.transpose(-1, -2), dim=-1)
        return self.out((p @ vh).transpose(1, 2).reshape(B, Lq, C))


class ConvStage(nn.Module):
    """3x3 convolution at ``stride``, LayerNorm, GELU, 3x3 convolution,
    LayerNorm, GELU; ``[B, C, H, W]``."""

    def __init__(self, in_channels: int, channels: int, stride: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.convs = nn.ModuleList([
            Conv(in_channels, channels, (3, 3), (stride, stride),
                 generator=generator),
            Conv(channels, channels, (3, 3), generator=generator)])
        self.norms = nn.ModuleList([layer_norm(channels),
                                    layer_norm(channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, norm in zip(self.convs, self.norms):
            x = channels_first(gelu(norm(channels_last(conv(x)))))
        return x


class DecoderBlock(nn.Module):
    """Cross-attention of the normalised queries over the pixel tokens,
    self-attention, an MLP of 4 widths; each a residual."""

    def __init__(self, hidden: int, heads: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cross = MultiHeadDotProductAttention(hidden, heads, generator)
        self.self_attn = MultiHeadDotProductAttention(hidden, heads,
                                                      generator)
        self.norms = nn.ModuleList(layer_norm(hidden) for _ in range(3))
        self.mlp_in = dense(hidden, 4 * hidden, generator)
        self.mlp_out = dense(4 * hidden, hidden, generator)

    def forward(self, q: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        q = q + self.cross(self.norms[0](q), tokens)
        q = q + self.self_attn(self.norms[1](q))
        return q + self.mlp_out(gelu(self.mlp_in(self.norms[2](q))))


def token_grid(image_size: Sequence[int]) -> Tuple[int, int]:
    """The stride-16 map's height and width for an image (SAME strides 4,
    2, 2)."""
    h, w = image_size
    for s in (4, 2, 2):
        h, w = -(-h // s), -(-w // s)
    return h, w


class _OneFormerModule(nn.Module):

    def __init__(self, num_labels: int, image_size: Sequence[int],
                 num_queries: int = 32, hidden: int = 128, heads: int = 8,
                 dec_layers: int = 4, task_id: int = 0,
                 in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden, self.task_id = hidden, task_id
        self.image_size = tuple(image_size)
        self.stem = ConvStage(in_channels, hidden // 4, 4, generator)
        self.stage2 = ConvStage(hidden // 4, hidden // 2, 2, generator)
        self.stage3 = ConvStage(hidden // 2, hidden, 2, generator)
        self.stage4 = ConvStage(hidden, hidden, 2, generator)
        self.lat1 = Conv(hidden // 4, hidden, (1, 1), generator=generator)
        self.lat2 = Conv(hidden // 2, hidden, (1, 1), generator=generator)
        self.lat3 = Conv(hidden, hidden, (1, 1), generator=generator)
        self.lat4 = Conv(hidden, hidden, (1, 1), generator=generator)
        self.pixel_out = Conv(hidden, hidden, (3, 3), generator=generator)
        gh, gw = token_grid(image_size)
        self.pix_pos = nn.Parameter(
            torch.randn(1, gh * gw, hidden, generator=generator) * 0.02)
        self.queries = nn.Parameter(
            torch.randn(1, num_queries, hidden, generator=generator) * 0.02)
        self.task_embed = embedding(len(TASKS), hidden, generator)
        self.dec = nn.ModuleList(DecoderBlock(hidden, heads, generator)
                                 for _ in range(dec_layers))
        self.dec_ln = layer_norm(hidden)
        self.class_head = dense(hidden, num_labels + 1, generator)
        self.mask_head = dense(hidden, hidden, generator)
        self.mask_ln = layer_norm(hidden)
        self.pixel_ln = layer_norm(hidden)
        stage = {'Conv_0': 'convs.0', 'Conv_1': 'convs.1',
                 'LayerNorm_0': 'norms.0', 'LayerNorm_1': 'norms.1'}
        block = {'self': 'self_attn', 'Dense_0': 'mlp_in',
                 'Dense_1': 'mlp_out', 'LayerNorm_0': 'norms.0',
                 'LayerNorm_1': 'norms.1', 'LayerNorm_2': 'norms.2'}
        self.flax_scopes = {
            **{f'{s}/{k}': v for s in ('stem', 'stage2', 'stage3', 'stage4')
               for k, v in stage.items()},
            **{f'dec_{i}': f'dec.{i}' for i in range(dec_layers)},
            **{f'dec_{i}/{k}': v for i in range(dec_layers)
               for k, v in block.items()}}
        self.flax_leaves = {'scale': 'weight', 'pix_pos': 'pix_pos',
                            'queries': 'queries'}

    def forward(self, x: torch.Tensor):
        x = x.to(self.queries.dtype) / 255.0
        x = channels_first(x[..., None] if x.ndim == 3 else x)
        if tuple(x.shape[2:]) != self.image_size:
            raise ValueError(f'images of {tuple(x.shape[2:])}: this model '
                             f'was built for {self.image_size}')
        B = x.shape[0]
        c1 = self.stem(x)
        c2 = self.stage2(c1)
        c3 = self.stage3(c2)
        c4 = self.stage4(c3)
        p4 = self.lat4(c4)
        p3 = self.lat3(c3) + resize_nearest(p4, c3.shape[2:])
        p2 = self.lat2(c2) + resize_nearest(p3, c2.shape[2:])
        p1 = self.lat1(c1) + resize_nearest(p2, c1.shape[2:])
        pixel = channels_last(self.pixel_out(p1))          # [B, h, w, C]
        toks = channels_last(c3).reshape(B, -1, self.hidden) + self.pix_pos
        task = self.task_embed.weight[self.task_id]
        q = self.queries.expand(B, -1, -1) + task
        for block in self.dec:
            q = block(q, toks)
        q = self.dec_ln(q)
        class_logits = self.class_head(q)
        mask_embed = self.mask_ln(self.mask_head(q))
        masks = torch.einsum('bqc,bhwc->bqhw', mask_embed,
                             self.pixel_ln(pixel)) / math.sqrt(self.hidden)
        cls_prob = torch.softmax(class_logits, dim=-1)[..., :-1]
        sem = torch.einsum('bqk,bqhw->bhwk', cls_prob, torch.sigmoid(masks))
        return torch.log(sem + 1e-6), masks, class_logits


def _sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``: ``-labels log_sigmoid(x) -
    (1 - labels) log_sigmoid(-x)``."""
    return -labels * F.logsigmoid(logits) \
        - (1 - labels) * F.logsigmoid(-logits)


def oneformer_loss(outputs, labels, weights, num_labels: int
                   ) -> torch.Tensor:
    """The JAX package's OneFormer loss on ``(sem_logits [B, h, w, K],
    masks [B, Q, h, w], class_logits [B, Q, K + 1])`` and label maps ``[B,
    H, W]`` brought to ``h x w`` by nearest neighbour: the composed map's
    per-pixel cross entropy, query k's mask against class k's by binary
    cross entropy and dice, and query k's class logits against k."""
    sem_logits, masks, class_logits = outputs
    K = num_labels
    h, w = sem_logits.shape[1:3]
    y = resize_nearest(labels[0].float()[:, None], (h, w))[:, 0].long()
    logp = torch.log_softmax(sem_logits, dim=-1)
    nll = -logp.gather(-1, y[..., None])[..., 0]
    onehot = F.one_hot(y, K).float()                       # [B, h, w, K]
    mK = masks[:, :K].permute(0, 2, 3, 1)
    bce = _sigmoid_bce(mK, onehot)
    pm = torch.sigmoid(mK)
    inter = (pm * onehot).sum(dim=(1, 2))
    denom = (pm + onehot).sum(dim=(1, 2))
    dice = (2.0 * inter + 1.0) / (denom + 1.0)
    cls_logp = torch.log_softmax(class_logits[:, :K], dim=-1)
    cls_nll = -torch.diagonal(cls_logp, dim1=1, dim2=2)      # [B, K]
    return nll.mean() + bce.mean() + (1.0 - dice).mean() + cls_nll.mean()


class OneFormer(TorchModel):
    """Semantic segmentation with the JAX package's surface: ``fit`` on
    ``(image [H, W, 3] in 0-255, label map [H, W])`` pairs, ``predict``
    the full-resolution label maps ``[N, H, W]``.  Only the semantic task
    runs (instance and panoptic raise, as in the JAX package and
    DeepChem).  The module's positional table has one row per stride-16
    token, so the model is built for one ``image_size`` (H, W); ADE20K's
    crop, 512, by default.  The module is built at construction from a
    ``torch.Generator`` seeded with ``seed``; load flax parameters with
    :func:`params_from_flax`."""

    def __init__(self, segmentation_task: str = 'semantic',
                 model_path: Optional[str] = None,
                 id2label: Optional[Dict[int, str]] = None,
                 num_queries: int = 32, hidden: int = 128,
                 dec_layers: int = 4, batch_size: int = 2,
                 image_size: Sequence[int] = (512, 512), **kwargs):
        if segmentation_task not in TASKS:
            raise ValueError(f'unknown task {segmentation_task!r}')
        if segmentation_task != 'semantic':
            raise ValueError(f'{segmentation_task} segmentation is not '
                             'supported yet (semantic only)')
        self.segmentation_task = segmentation_task
        self.task = 'universal_segmentation'
        self.id2label = id2label or {0: 'unlabelled', 1: 'labelled'}
        self.label2id = {v: k for k, v in self.id2label.items()}
        self.num_labels = len(self.id2label)
        task_id = TASKS.index(segmentation_task)
        num_queries = max(num_queries, self.num_labels)
        K = self.num_labels
        super().__init__(
            lambda g: _OneFormerModule(K, image_size, num_queries, hidden,
                                       dec_layers=dec_layers,
                                       task_id=task_id, generator=g),
            lambda o, y, w: oneformer_loss(o, y, w, K),
            output_types=['prediction', 'embedding', 'embedding'],
            batch_size=batch_size, **kwargs)

    def predict(self, dataset, transformers=(), output_types=None):
        """Full-resolution label maps ``[N, H, W]``: the composed map
        upsampled by nearest neighbour, argmax over the labels."""
        sem = super().predict(dataset, transformers, output_types)
        H, W = dataset.X.shape[1:3]
        up = resize_nearest(torch.from_numpy(np.ascontiguousarray(
            sem)).permute(0, 3, 1, 2), (H, W))
        return up.argmax(dim=1).numpy()

    def get_num_tasks(self) -> int:
        return self.num_labels

    def get_task_type(self) -> str:
        return self.task
