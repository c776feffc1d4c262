"""Segment softmax over CSR edge ranges: the Hopper kernel and its plain
version.

Counterpart of ``deepchem_tpu/ops/pallas_segment.py``'s
``csr_segment_softmax`` (P1).  Edges are sorted by destination and
``row_ptr`` (``[N+1]`` int32, ``row_ptr[N] == E``) delimits each node's
range.  The kernel is ``csrc/csr_segment_softmax.cu``; on a CPU tensor the
wrapper computes the same function with plain torch ops, on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from deepchem_tpu_torch.kernels import build


def edges_to_csr(edge_dst: np.ndarray, num_nodes: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: sort edge ids by destination; return ``(perm, row_ptr)``.

    ``perm`` reorders edge-parallel arrays into CSR order; ``row_ptr`` has
    ``num_nodes + 1`` entries.
    """
    edge_dst = np.asarray(edge_dst)
    perm = np.argsort(edge_dst, kind='stable').astype(np.int32)
    counts = np.bincount(edge_dst, minlength=num_nodes)
    row_ptr = np.zeros(num_nodes + 1, dtype=np.int32)
    np.cumsum(counts[:num_nodes], out=row_ptr[1:])
    return perm, row_ptr


def csr_row_ptr(segment_ids_sorted: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``row_ptr`` ``[num_segments + 1]`` int32 of non-decreasing segment
    ids: segment ``i`` owns edges ``row_ptr[i]:row_ptr[i+1]``."""
    bounds = torch.arange(num_segments + 1, dtype=segment_ids_sorted.dtype,
                          device=segment_ids_sorted.device)
    return torch.searchsorted(segment_ids_sorted.contiguous(),
                              bounds).to(torch.int32)


def csr_segment_softmax_reference(logits: torch.Tensor,
                                  row_ptr: torch.Tensor) -> torch.Tensor:
    """Plain torch version: per-segment max, shifted exp, segment sum.  A
    max of -inf (no finite logit) becomes 0 and the sum is clamped to at
    least 1e-16, as in the kernel."""
    E, H = logits.shape
    N = row_ptr.shape[0] - 1
    seg = torch.searchsorted(row_ptr[1:].long(),
                             torch.arange(E, device=logits.device),
                             right=True)             # segment of each edge
    idx = seg[:, None].expand(E, H)
    seg_max = torch.full((N, H), -torch.inf, dtype=logits.dtype,
                         device=logits.device)
    seg_max = seg_max.scatter_reduce(0, idx, logits, 'amax')
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    ex = torch.exp(logits - seg_max[seg])
    denom = torch.zeros_like(seg_max).index_add_(0, seg, ex)
    return ex / torch.clamp_min(denom[seg], 1e-16)


def _check(logits: torch.Tensor, row_ptr: torch.Tensor) -> None:
    if logits.device.type != 'cuda' or row_ptr.device != logits.device:
        raise ValueError(f'logits and row_ptr must lie on one CUDA device, '
                         f'got {logits.device} and {row_ptr.device}')
    if logits.dtype != torch.float32 or row_ptr.dtype != torch.int32:
        raise TypeError(f'need float32 logits and int32 row_ptr, got '
                        f'{logits.dtype} and {row_ptr.dtype}')
    if logits.ndim != 2 or row_ptr.ndim != 1 or row_ptr.shape[0] < 1:
        raise ValueError(f'need logits [E, H] and row_ptr [N+1], got '
                         f'{tuple(logits.shape)} and '
                         f'{tuple(row_ptr.shape)}')
    if not (logits.is_contiguous() and row_ptr.is_contiguous()):
        raise ValueError('logits and row_ptr must be contiguous')
    if max(logits.shape[0] * logits.shape[1], row_ptr.shape[0]) >= 2**31:
        raise ValueError('sizes must fit in int32')


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load('csr_segment_softmax').csr_segment_softmax_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def csr_segment_softmax(logits: torch.Tensor,
                        row_ptr: torch.Tensor) -> torch.Tensor:
    """Per-segment softmax of CSR-sorted ``logits`` ``[E, H]`` float32
    over ``row_ptr`` ``[N+1]`` int32 with ``row_ptr[N] == E``.  Returns
    ``[E, H]`` weights that sum to 1 within each non-empty segment.

    CPU tensors take :func:`csr_segment_softmax_reference`; CUDA tensors
    launch the kernel, which is counted in ``csr_segment_softmax.launches``.
    """
    if logits.device.type == 'cpu' and row_ptr.device.type == 'cpu':
        return csr_segment_softmax_reference(logits, row_ptr)
    _check(logits, row_ptr)
    out = torch.empty_like(logits)
    E, H = logits.shape
    N = row_ptr.shape[0] - 1
    if E * H == 0:
        return out
    if N == 0:
        raise ValueError('row_ptr has no segment for the edges')
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(logits.data_ptr(), row_ptr.data_ptr(),
                       out.data_ptr(), N, E, H, stream)
    if err != 0:
        raise RuntimeError(f'csr_segment_softmax launch failed: '
                           f'cudaError {err}')
    csr_segment_softmax.launches += 1
    return out


csr_segment_softmax.launches = 0
