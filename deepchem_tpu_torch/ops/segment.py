"""Graph segment operations on the padded COO batch layout.

Counterparts of ``deepchem_tpu/ops/segment.py``.  Padding convention:
ghost nodes have mask 0 and belong to ghost graph slot ``num_graphs``;
ghost edges point at the last node.  All reductions stay in bounds and
masks zero what the ghosts contribute.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepchem_tpu_torch.ops.csr_segment import (csr_row_ptr,
                                                csr_segment_softmax)

NEG = -9e15


def _expand_mask(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (ndim - mask.ndim))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids.long(), data)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Numerically stable softmax within segments, for segment ids in any
    order (GAT/AttentiveFP attention)."""
    ids = segment_ids.long()
    if mask is not None:
        m = _expand_mask(mask, logits.ndim)
        logits = torch.where(m > 0, logits, torch.full_like(logits, NEG))
    idx = ids.reshape(ids.shape + (1,) * (logits.ndim - 1)).expand_as(logits)
    seg_max = torch.full((num_segments,) + tuple(logits.shape[1:]),
                         -torch.inf, dtype=logits.dtype,
                         device=logits.device)
    seg_max = seg_max.scatter_reduce(0, idx, logits, 'amax')
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    exp = torch.exp(logits - seg_max[ids])
    if mask is not None:
        exp = exp * m
    denom = segment_sum(exp, ids, num_segments)
    return exp / torch.clamp_min(denom[ids], 1e-16)


def segment_softmax_sorted(logits: torch.Tensor,
                           segment_ids_sorted: torch.Tensor,
                           num_segments: int,
                           mask: Optional[torch.Tensor] = None,
                           row_ptr: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """:func:`segment_softmax` for segment ids in NON-DECREASING order,
    through the CSR kernel (:func:`csr_segment_softmax`).  A caller that
    softmaxes over the same ids more than once passes their ``row_ptr``
    (:func:`csr_row_ptr`) so it is built once.

    Masked logits become ``NEG`` before the softmax and the result is
    multiplied by the mask after it, so a fully masked segment gives 0.
    Callers guarantee sortedness (the graph models sort edges by
    destination when they pack a batch); results are garbage otherwise.
    """
    squeeze = logits.ndim == 1
    x = logits[:, None] if squeeze else logits
    m = None
    if mask is not None:
        m = _expand_mask(mask, x.ndim)
        x = torch.where(m > 0, x, torch.full_like(x, NEG))
    if row_ptr is None:
        row_ptr = csr_row_ptr(segment_ids_sorted, num_segments)
    y = csr_segment_softmax(x.contiguous(), row_ptr)
    if m is not None:
        y = y * m
    return y[:, 0] if squeeze else y


def graph_pool(node_feats: torch.Tensor, graph_index: torch.Tensor,
               num_graphs: int,
               node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-graph sum readout over nodes.  ``num_graphs`` EXCLUDES the ghost
    slot; the result has ``num_graphs`` rows.  The JAX package's 'mean'
    and 'max' modes come with the first ported model that pools so."""
    feats = node_feats
    if node_mask is not None:
        feats = feats * node_mask[:, None]
    return segment_sum(feats, graph_index, num_graphs + 1)[:num_graphs]
