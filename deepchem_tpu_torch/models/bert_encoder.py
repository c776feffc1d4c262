"""Native RoBERTa-class masked-LM encoder.

Counterpart of ``deepchem_tpu/models/bert_encoder.py``:
``flash_or_xla_attention``, ``_EncoderLayer``, ``BertEncoderMLM`` and
``mlm_loss``.  Post-LN RoBERTa layers with tanh-approximated gelu (flax's
``nn.gelu``), LayerNorms of epsilon 1e-6 computed in float32, learned
positions with RoBERTa's offset of 2, and an MLM head tied to the token
embedding.  ``dtype`` is the computation type: with ``torch.bfloat16``
the dense layers, the attention and the activations run in bfloat16 over
float32 parameters, as flax's ``dtype`` does.

Attention takes the einsum route by default (two ``torch.matmul`` and a
float32 softmax), as the JAX package does; ``use_flash=True`` routes it
through :func:`~deepchem_tpu_torch.ops.flash_attention` (P4), whose
kernels run on the card.  The layers look ``flash_or_xla_attention`` up
in this module when they run.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepchem_tpu_torch.models.graph_models import dense
from deepchem_tpu_torch.models.torch_model import resolve_device
from deepchem_tpu_torch.ops.flash_attention import flash_attention

LN_EPS = 1e-6                 # flax nn.LayerNorm's default


def flash_or_xla_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, mask: Optional[torch.Tensor],
                           use_flash: Optional[bool] = None
                           ) -> torch.Tensor:
    """``[B, S, H, D]`` q, k, v -> ``[B, S, H, D]``; ``mask`` ``[B, S]``
    (1 = keep) or None.

    The default (``use_flash`` None or False) is the einsum route: scores
    in the inputs' type scaled by ``1/sqrt(D)``, the mask's bias ``(1 -
    mask) * -1e9`` added in the scores' type, a float32 softmax, and the
    probabilities in ``v``'s type times ``v``.  ``use_flash=True`` runs
    :func:`flash_attention` on the ``[B, H, S, D]`` transposes and, as in
    the JAX package, ignores ``mask``.
    """
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    if use_flash:
        out = flash_attention(q.transpose(1, 2).contiguous(),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(), scale)
        return out.transpose(1, 2)
    scores = torch.matmul(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1)) \
        * scale
    if mask is not None:
        bias = (1.0 - mask[:, None, None, :].float()) * -1e9
        scores = scores + bias.to(scores.dtype)
    probs = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    return torch.matmul(probs, v.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)


def _linear(layer: nn.Linear, x: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: input, weight and bias in ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype,
                ln_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """flax ``LayerNorm(dtype=ln_dtype)`` on ``x`` cast to ``ln_dtype``,
    the result cast back to ``dtype``: flax takes the statistics and the
    normalisation in float32 whatever ``ln_dtype`` is, and rounds the
    result to ``ln_dtype``."""
    return F.layer_norm(x.to(ln_dtype).float(), ln.normalized_shape,
                        ln.weight, ln.bias, ln.eps).to(ln_dtype).to(dtype)


def _dropout(x: torch.Tensor, rate: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """Zero each entry with probability ``rate`` and scale the rest by
    ``1 / (1 - rate)``, as flax's ``nn.Dropout``; no-op without a
    generator (eval mode or rate 0)."""
    if generator is None:
        return x
    keep = torch.empty_like(x).bernoulli_(1 - rate, generator=generator)
    return x * keep / (1 - rate)


class _EncoderLayer(nn.Module):
    """Self-attention and MLP blocks, each followed by a residual add and
    a LayerNorm (post-LN)."""

    def __init__(self, hidden: int, heads: int, intermediate: int,
                 dropout: float, dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None,
                 ln_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.dropout, self.dtype = heads, dropout, dtype
        self.ln_dtype = ln_dtype
        self.qkv = dense(hidden, 3 * hidden, generator)
        self.out = dense(hidden, hidden, generator)
        self.ln_att = nn.LayerNorm(hidden, eps=LN_EPS)
        self.mlp_in = dense(hidden, intermediate, generator)
        self.mlp_out = dense(intermediate, hidden, generator)
        self.ln_mlp = nn.LayerNorm(hidden, eps=LN_EPS)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        """``dropout_seed`` (training only) seeds this call's dropout
        masks, so a recomputation under ``remat`` draws the same ones."""
        B, S, hidden = x.shape
        H, dt = self.heads, self.dtype
        gen = None
        if dropout_seed is not None:
            gen = torch.Generator(x.device).manual_seed(dropout_seed)
        q, k, v = _linear(self.qkv, x, dt).reshape(
            B, S, 3 * H, hidden // H).split(H, dim=2)
        att = flash_or_xla_attention(q, k, v, mask)
        att = _linear(self.out, att.reshape(B, S, hidden), dt)
        att = _dropout(att, self.dropout, gen)
        x = _layer_norm(self.ln_att, x + att, dt, self.ln_dtype)
        h = F.gelu(_linear(self.mlp_in, x, dt), approximate='tanh')
        h = _dropout(_linear(self.mlp_out, h, dt), self.dropout, gen)
        return _layer_norm(self.ln_mlp, x + h, dt, self.ln_dtype)


class BertEncoderMLM(nn.Module):
    """RoBERTa-architecture masked-LM model; ``module(input_ids,
    attention_mask=None)`` returns float32 vocabulary logits ``[B, S,
    V]``.

    Parameters are drawn from a ``torch.Generator`` seeded with ``seed``
    (Dense layers as flax's ``lecun_normal``, embeddings normal with
    variance ``1/hidden``); load trained flax parameters with
    :func:`~deepchem_tpu_torch.models.convert.encoder_params_from_flax`.
    The module lives on ``device``, by default the current CUDA device
    (raises when there is none; pass ``device='cpu'`` for the CPU).
    ``S`` may be at most ``max_positions - 2``.

    In ``train()`` mode with ``dropout > 0`` each layer drops after its
    attention projection and its MLP; the masks come from generators
    seeded from a sequence started at ``seed``, not from the global RNG.
    ``remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``) instead of keeping its activations.
    ``ln_dtype`` is the type the layers' LayerNorms take their input in
    and round their output to (their statistics stay float32, as flax's);
    the embedding's and the head's LayerNorms stay float32.
    """

    def __init__(self, vocab_size: int, hidden: int = 768, layers: int = 12,
                 heads: int = 12, intermediate: int = 3072,
                 max_positions: int = 130, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 device=None, seed: int = 0,
                 ln_dtype: torch.dtype = torch.float32):
        super().__init__()
        if hidden % heads:
            raise ValueError(f'hidden {hidden} is not a multiple of heads '
                             f'{heads}')
        self.vocab_size, self.hidden = vocab_size, hidden
        self.max_positions, self.dropout = max_positions, dropout
        self.dtype, self.remat = dtype, remat
        gen = torch.Generator().manual_seed(seed)
        self._dropout_seeds = torch.Generator().manual_seed(seed)
        self.tok_emb = nn.Embedding(vocab_size, hidden)
        self.pos_emb = nn.Embedding(max_positions, hidden)
        with torch.no_grad():
            for emb in (self.tok_emb, self.pos_emb):
                emb.weight.normal_(0.0, hidden ** -0.5, generator=gen)
        self.ln_emb = nn.LayerNorm(hidden, eps=LN_EPS)
        self.layers = nn.ModuleList(
            _EncoderLayer(hidden, heads, intermediate, dropout, dtype, gen,
                          ln_dtype) for _ in range(layers))
        self.head_dense = dense(hidden, hidden, gen)
        self.head_ln = nn.LayerNorm(hidden, eps=LN_EPS)
        self.head_bias = nn.Parameter(torch.zeros(vocab_size))
        self.to(resolve_device(device))

    def _layer_seed(self) -> Optional[int]:
        if not self.training or self.dropout == 0:
            return None
        return int(torch.randint(2**62, (), generator=self._dropout_seeds))

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """``input_ids`` ``[B, S]`` integer; ``attention_mask`` ``[B, S]``
        (1 = keep) or None (attend everywhere)."""
        B, S = input_ids.shape
        if S > self.max_positions - 2:
            raise ValueError(f'sequence length {S} > max_positions - 2 = '
                             f'{self.max_positions - 2}')
        dt = self.dtype
        emb = self.tok_emb.weight.to(dt)
        pos = torch.arange(S, device=input_ids.device) + 2  # RoBERTa offset
        x = F.embedding(input_ids, emb) \
            + F.embedding(pos, self.pos_emb.weight.to(dt))[None]
        x = _layer_norm(self.ln_emb, x, dt)
        for layer in self.layers:
            seed = self._layer_seed()
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, attention_mask, seed,
                               use_reentrant=False)
            else:
                x = layer(x, attention_mask, seed)
        # MLM head: dense, gelu, LayerNorm, the tied vocabulary projection
        h = F.gelu(_linear(self.head_dense, x, dt), approximate='tanh')
        h = _layer_norm(self.head_ln, h, dt)
        return F.linear(h, emb).float() + self.head_bias


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor,
             label_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross entropy of ``logits`` ``[..., V]`` at integer ``labels``
    ``[...]``, in float32: the mean over every position, or over the
    positions where ``label_mask`` is non-zero (weighted by it)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels[..., None].long())[..., 0]
    if label_mask is None:
        return nll.mean()
    w = label_mask.float()
    return (nll * w).sum() / torch.clamp_min(w.sum(), 1.0)
