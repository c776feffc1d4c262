"""Generic attention layers and GROVER's scope readout.

Counterparts of ``deepchem_tpu/models/attention_layers.py``'s
``ScaledDotProductAttention``, ``SelfAttention`` and ``GroverReadout``:
public building blocks for models that compose them; GROVER itself reads
out with masks (``models/grover.py``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn


class ScaledDotProductAttention(nn.Module):
    """``softmax(Q K^T / sqrt(d)) V``; ``forward(query, key, value[, mask])``
    returns the output and the attention probabilities.  Where ``mask``
    is 0 the score is -1e9.  With ``dropout_rate`` in training the
    probabilities are dropped (masks from ``generator``)."""

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor, mask: Optional[torch.Tensor] = None,
                dropout_rate: float = 0.0,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        d_k = query.shape[-1]
        scores = torch.matmul(query, key.transpose(-2, -1)) / torch.sqrt(
            torch.tensor(float(d_k), dtype=query.dtype))
        if mask is not None:
            scores = torch.where(mask == 0, scores.new_tensor(-1e9), scores)
        p_attn = torch.softmax(scores, dim=-1)
        if dropout_rate > 0.0 and self.training:
            keep = torch.empty_like(p_attn).bernoulli_(1 - dropout_rate,
                                                       generator=generator)
            p_attn = p_attn * keep / (1 - dropout_rate)
        return torch.matmul(p_attn, value), p_attn


class SelfAttention(nn.Module):
    """``a = softmax(w2 tanh(w1 X^T))``, ``y = a X``: returns the embedding
    ``[out_features, in_features]`` and the attention ``[out_features,
    n]``.  ``w1`` ``[hidden_size, in_features]`` and ``w2``
    ``[out_features, hidden_size]`` are initialised as flax's
    ``xavier_normal``."""

    def __init__(self, in_features: int, out_features: int,
                 hidden_size: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w1 = nn.Parameter(torch.empty(hidden_size, in_features))
        self.w2 = nn.Parameter(torch.empty(out_features, hidden_size))
        for w in (self.w1, self.w2):
            # flax's xavier_normal: a truncated normal of variance
            # 2 / (fan_in + fan_out), its axes -2 (in) and -1 (out)
            std = math.sqrt(2.0 / sum(w.shape)) / .87962566103423978
            with torch.no_grad():
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
        self.flax_leaves = {'w1': 'w1', 'w2': 'w2'}

    def forward(self, X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.matmul(self.w2, torch.tanh(torch.matmul(self.w1, X.T)))
        attn = torch.softmax(x, dim=-1)
        return torch.matmul(attn, X), attn


class GroverReadout(nn.Module):
    """One row per ``(start, size)`` entry of ``scope`` over the rows of
    ``graph_embeddings``: their mean (``rtype='mean'``, ``in_features``
    wide) or their :class:`SelfAttention` embedding flattened
    (``'self_attention'``, ``attn_out_size * in_features`` wide); the zero
    vector for an empty entry."""

    def __init__(self, rtype: str = 'mean', in_features: int = 128,
                 attn_hidden_size: int = 32, attn_out_size: int = 32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if rtype not in ('mean', 'self_attention'):
            raise ValueError(f'unknown readout type {rtype!r}')
        self.rtype, self.in_features = rtype, in_features
        self.attn_out_size = attn_out_size
        self.attn = SelfAttention(in_features, attn_out_size,
                                  attn_hidden_size, generator) \
            if rtype == 'self_attention' else None
        self.flax_scopes = {'SelfAttention_0': 'attn'}
        self.flax_leaves = {'w1': 'w1', 'w2': 'w2'}

    def forward(self, graph_embeddings: torch.Tensor,
                scope: List) -> torch.Tensor:
        width = self.in_features if self.rtype == 'mean' \
            else self.attn_out_size * self.in_features
        rows = []
        for start, size in scope:
            start, size = int(start), int(size)
            if size == 0:
                rows.append(graph_embeddings.new_zeros(width))
                continue
            block = graph_embeddings[start:start + size]
            if self.attn is not None:
                rows.append(self.attn(block)[0].reshape(-1))
            else:
                rows.append(block.sum(dim=0) / size)
        return torch.stack(rows, dim=0)
