"""Flash attention (P4): the Hopper kernels and their plain versions.

Counterpart of the stock Pallas TPU flash attention that
``deepchem_tpu/models/bert_encoder.py``'s ``flash_or_xla_attention``
calls with ``use_flash=True``
(``jax.experimental.pallas.ops.tpu.flash_attention.flash_attention``):
its forward and its two backward kernels, dK/dV and dQ.  The layout is
the stock one, ``[B, H, S, D]``.  Attention is non-causal, with no bias
and no segment ids: no caller in the repository passes them, so these
functions do not take them.

The kernels are ``csrc/flash_attention.cu``.  On CPU tensors each wrapper
computes its function with plain torch ops; on CUDA tensors it launches
its kernel or raises, and counts the launch: the forward in
``flash_attention.launches``, the backward kernels in
``flash_attention_bwd_dkv.launches`` and ``flash_attention_bwd_dq.launches``.
The kernels take float32 or bfloat16 with ``D`` of 32 or 64, and any
``S``: the stock kernel's need for ``S`` to be a multiple of 128 is a TPU
block limit, not carried.  The float32 kernels, forward and backward,
multiply on the tensor cores in three tf32 passes, which keep float32's
digits; torch's TF32 flags do not reach them.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from deepchem_tpu_torch.kernels import build

HEAD_DIMS = (32, 64)          # the D the kernels take


# ---------------------------------------------------------- plain versions

def _scores(q: torch.Tensor, k: torch.Tensor,
            sm_scale: float) -> torch.Tensor:
    """``q kᵀ · sm_scale`` in float32, ``[B, H, S, S]``."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              sm_scale: float) -> torch.Tensor:
    """Plain version of the forward: scores and softmax in float32, the
    probabilities cast to ``v``'s type, ``p·v`` accumulated in float32 and
    returned in ``q``'s type."""
    p = torch.softmax(_scores(q, k, sm_scale), dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def _forward_reference(q, k, v, sm_scale):
    """:func:`flash_attention_reference` with the per-row statistics the
    backward needs: the max ``m`` and the sum ``l`` of ``exp(s - m)``,
    float32 ``[B, H, S]``."""
    s = _scores(q, k, sm_scale)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    l = e.sum(dim=-1)
    p = (e / l[..., None]).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype), m, l


def _probs_and_ds(q, k, v, do, m, l, di, sm_scale):
    """The backward's ``p = exp(s - m) / l`` and ``ds = (do vᵀ - di) · p ·
    sm_scale``, float32, as the stock backward kernels compute them."""
    p = torch.exp(_scores(q, k, sm_scale) - m[..., None]) \
        * (1.0 / l)[..., None]
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, (dp - di[..., None]) * p * sm_scale


def flash_attention_bwd_dkv_reference(q, k, v, do, m, l, di, sm_scale
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dK/dV kernel: ``dV = pᵀ do`` and ``dK = dsᵀ
    q``, with ``p`` and ``ds`` cast to the input type before each
    product, as in the stock kernel."""
    p, ds = _probs_and_ds(q, k, v, do, m, l, di, sm_scale)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.to(do.dtype).float().transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_reference(q, k, v, do, m, l, di, sm_scale
                                     ) -> torch.Tensor:
    """Plain version of the dQ kernel: ``dQ = ds k``, with ``ds`` cast to
    the input type before the product, as in the stock kernel."""
    _, ds = _probs_and_ds(q, k, v, do, m, l, di, sm_scale)
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)


# ------------------------------------------------------------ the kernels

def _check(what: str, data: Tuple[torch.Tensor, ...],
           stats: Tuple[torch.Tensor, ...] = ()) -> None:
    """What the kernels take: ``[B, H, S, D]`` data all of one shape and
    one type (float32 or bfloat16) with ``D`` in :data:`HEAD_DIMS`, float32
    ``[B, H, S]`` statistics, all contiguous, 16-byte aligned, on one CUDA
    device, with sizes that fit int32."""
    dev = data[0].device
    tensors = data + stats
    if dev.type != 'cuda' or any(t.device != dev for t in tensors):
        raise ValueError(f'{what}: every tensor must lie on one CUDA '
                         f'device, got {[str(t.device) for t in tensors]}')
    if data[0].dtype not in (torch.float32, torch.bfloat16) \
            or any(t.dtype != data[0].dtype for t in data) \
            or any(t.dtype != torch.float32 for t in stats):
        raise TypeError(f'{what}: need q, k, v (and do) all float32 or all '
                        f'bfloat16, and float32 statistics; got '
                        f'{[t.dtype for t in tensors]}')
    shape = data[0].shape
    if len(shape) != 4 or any(t.shape != shape for t in data) \
            or any(t.shape != shape[:3] for t in stats):
        raise ValueError(f'{what}: need q, k, v (and do) of one shape [B, '
                         f'H, S, D] and statistics [B, H, S]; got '
                         f'{[tuple(t.shape) for t in tensors]}')
    if shape[3] not in HEAD_DIMS:
        raise ValueError(f'{what}: the kernels take D in {HEAD_DIMS}, got '
                         f'{shape[3]}')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f'{what}: every tensor must be contiguous')
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f'{what}: every tensor must be 16-byte aligned')
    if data[0].numel() >= 2**31:
        raise ValueError(f'{what}: sizes must fit in int32')


def _launch(name: str, ptrs, like: torch.Tensor, sm_scale: float) -> None:
    """Launch the C entry ``name`` of ``csrc/flash_attention.cu``: data
    and statistics pointers, then (bh, seq, d, bf16) and the scale."""
    B, H, S, D = like.shape
    build.launch('flash_attention', name, ptrs,
                 (B * H, S, D, int(like.dtype == torch.bfloat16)),
                 (float(sm_scale),))


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == 'cpu' for t in tensors)


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, sm_scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The forward kernel (P4-fwd): ``(o, m, l)`` with ``o`` ``[B, H, S,
    D]`` in ``q``'s type and the per-row max ``m`` and sum ``l`` float32
    ``[B, H, S]``.  No gradient; :func:`flash_attention` is the
    differentiable entry."""
    if _on_cpu(q, k, v):
        return _forward_reference(q, k, v, sm_scale)
    _check('flash_attention', (q, k, v))
    o = torch.empty_like(q)
    m = q.new_empty(q.shape[:3], dtype=torch.float32)
    l = torch.empty_like(m)
    if q.numel():
        _launch('flash_attention_fwd', (q, k, v, o, m, l), q, sm_scale)
        flash_attention.launches += 1
    return o, m, l


def flash_attention_bwd_dkv(q, k, v, do, m, l, di, sm_scale
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel (P4-dkv): ``(dk, dv)`` from the forward's inputs,
    its statistics ``m`` and ``l``, the output gradient ``do`` and ``di =
    sum(o · do, -1)`` (float32).  CPU tensors take
    :func:`flash_attention_bwd_dkv_reference`; launches are counted in
    ``flash_attention_bwd_dkv.launches``."""
    if _on_cpu(q, k, v, do, m, l, di):
        return flash_attention_bwd_dkv_reference(q, k, v, do, m, l, di,
                                                 sm_scale)
    _check('flash_attention_bwd_dkv', (q, k, v, do), (m, l, di))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel():
        _launch('flash_attention_dkv', (q, k, v, do, m, l, di, dk, dv), q,
                sm_scale)
        flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, m, l, di, sm_scale) -> torch.Tensor:
    """The dQ kernel (P4-dq), from the same inputs as
    :func:`flash_attention_bwd_dkv`.  CPU tensors take
    :func:`flash_attention_bwd_dq_reference`; launches are counted in
    ``flash_attention_bwd_dq.launches``."""
    if _on_cpu(q, k, v, do, m, l, di):
        return flash_attention_bwd_dq_reference(q, k, v, do, m, l, di,
                                                sm_scale)
    _check('flash_attention_bwd_dq', (q, k, v, do), (m, l, di))
    dq = torch.empty_like(q)
    if q.numel():
        _launch('flash_attention_dq', (q, k, v, do, m, l, di, dq), q,
                sm_scale)
        flash_attention_bwd_dq.launches += 1
    return dq


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        o, m, l = flash_attention_forward(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        do = do.contiguous()
        di = (o.float() * do.float()).sum(dim=-1)     # as the stock VJP
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, m, l, di,
                                         ctx.sm_scale)
        dq = flash_attention_bwd_dq(q, k, v, do, m, l, di, ctx.sm_scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float) -> torch.Tensor:
    """``softmax(q kᵀ · sm_scale) v`` for ``[B, H, S, D]`` ``q``, ``k``,
    ``v``, without an ``S x S`` array on the card; returns ``[B, H, S, D]``
    in ``q``'s type, differentiable in ``q``, ``k`` and ``v``.

    CPU tensors take the plain versions (forward and backward); CUDA
    tensors launch the forward kernel (counted in
    ``flash_attention.launches``), and the backward launches the dK/dV and
    dQ kernels, with ``di = sum(o · do, -1)`` in float32 between them as
    in the stock VJP.
    """
    return _FlashAttention.apply(q, k, v, sm_scale)


flash_attention.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dq.launches = 0
