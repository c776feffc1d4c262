"""The port's CSR segment softmax (P1) against the JAX package's.

On the CPU the port's wrapper takes its plain torch version; it is held
against the JAX Pallas kernel in interpret mode and the JAX oracle, on the
cases of tests/test_csr_softmax.py plus a fully masked segment.  Tolerance
atol 1e-6: the same f32 inputs, summed in another order.  At +inf and NaN
logits, where every output is 0 or NaN, forward and gradient are held bit
for bit.  The CUDA kernel
itself is compared with the plain version in tests/test_torch_cuda.py.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepchem_tpu.ops import segment_softmax as jax_segment_softmax
from deepchem_tpu.ops.pallas_segment import (
    csr_segment_softmax as jax_csr_segment_softmax,
    csr_segment_softmax_reference as jax_csr_reference,
    edges_to_csr as jax_edges_to_csr)
from deepchem_tpu_torch.ops import (NEG, csr_row_ptr, csr_segment_softmax,
                                    csr_segment_softmax_reference,
                                    edges_to_csr, segment_softmax,
                                    segment_softmax_sorted)

torch.set_num_threads(1)
ATOL = 1e-6


def _csr_case(N=64, E=300, H=4, seed=0):
    rng = np.random.RandomState(seed)
    dst = rng.randint(0, N, E)
    perm, row_ptr = edges_to_csr(dst, N)
    logits = rng.randn(E, H).astype(np.float32)[perm]
    return logits, row_ptr


def _port(logits, row_ptr):
    return csr_segment_softmax(torch.from_numpy(logits),
                               torch.from_numpy(row_ptr)).numpy()


def _jax_kernel(logits, row_ptr):
    """The JAX kernel in interpret mode; its grid needs the node count
    padded to a multiple of 8 with empty tail segments."""
    N = len(row_ptr) - 1
    n_pad = -(-N // 8) * 8
    rp = np.concatenate([row_ptr, np.full(n_pad - N, row_ptr[-1],
                                          np.int32)])
    return np.asarray(jax_csr_segment_softmax(
        jnp.asarray(logits), jnp.asarray(rp), n_pad, True))


@pytest.mark.parametrize('N,E,H,seed', [(64, 300, 4, 0), (64, 300, 1, 3),
                                        (13, 50, 3, 4), (40, 7, 2, 5)])
def test_random_csr_matches_jax(N, E, H, seed):
    logits, rp = _csr_case(N, E, H, seed)
    y = _port(logits, rp)
    np.testing.assert_allclose(y, _jax_kernel(logits, rp), atol=ATOL)
    np.testing.assert_allclose(
        y, np.asarray(jax_csr_reference(jnp.asarray(logits),
                                        jnp.asarray(rp), N)), atol=ATOL)
    for i in range(N):
        if rp[i + 1] > rp[i]:
            np.testing.assert_allclose(y[rp[i]:rp[i + 1]].sum(0), 1.0,
                                       atol=1e-5)


def test_edges_to_csr_matches_jax():
    dst = np.random.RandomState(6).randint(0, 30, 200)
    for a, b in zip(edges_to_csr(dst, 30), jax_edges_to_csr(dst, 30)):
        np.testing.assert_array_equal(a, b)


def test_single_and_empty_segments():
    N = 64
    dst = np.concatenate([np.zeros(5, np.int64), np.full(3, 17),
                          np.full(1, 40)])
    perm, rp = edges_to_csr(dst, N)
    logits = np.random.RandomState(1).randn(9, 4).astype(np.float32)[perm]
    y = _port(logits, rp)
    np.testing.assert_allclose(y, _jax_kernel(logits, rp), atol=ATOL)
    np.testing.assert_allclose(y[:5].sum(0), 1.0, atol=1e-5)
    np.testing.assert_allclose(y[5:8].sum(0), 1.0, atol=1e-5)
    np.testing.assert_array_equal(y[8], np.ones(4, np.float32))


def test_row_ptr_tail_of_empty_segments():
    """Segments past the last destination are empty: row_ptr has a tail
    equal to E, as segment_softmax_sorted builds it."""
    rng = np.random.RandomState(4)
    N, E = 13, 50
    dst = np.sort(rng.randint(0, 9, E)).astype(np.int32)
    logits = rng.randn(E, 3).astype(np.float32)
    rp = np.searchsorted(dst, np.arange(N + 1), side='left').astype(
        np.int32)
    assert rp[-1] == E and rp[-2] == E
    y = _port(logits, rp)
    np.testing.assert_allclose(y, _jax_kernel(logits, rp),
                               atol=ATOL)
    y_ref = jax_segment_softmax(jnp.asarray(logits), jnp.asarray(dst), N)
    np.testing.assert_allclose(y, np.asarray(y_ref), atol=ATOL)


def test_all_neg_segment_gives_uniform_weights():
    """A segment whose logits are all NEG (the ghost node's) yields 1/count
    before the mask, as on the TPU; -inf logits yield zeros."""
    rp = np.array([0, 3, 5, 9], np.int32)
    logits = np.random.RandomState(2).randn(9, 2).astype(np.float32)
    logits[3:5] = NEG
    logits[5:9, 1] = -np.inf
    y = _port(logits, rp)
    np.testing.assert_allclose(y, _jax_kernel(logits, rp), atol=ATOL)
    np.testing.assert_allclose(y[3:5], 0.5, atol=ATOL)
    np.testing.assert_array_equal(y[5:9, 1], 0.0)


@pytest.mark.parametrize('shape', [(160,), (160, 6)])
def test_sorted_wrapper_with_mask_matches_jax(shape):
    """segment_softmax_sorted (1-D logits squeezed, and 2-D) with an edge
    mask equals the JAX oracle segment_softmax."""
    rng = np.random.RandomState(2)
    N, E = 40, shape[0]
    dst = np.sort(rng.randint(0, N, E)).astype(np.int32)
    mask = (rng.rand(E) > 0.2).astype(np.float32)
    mask[dst == dst[0]] = 0.0          # one segment fully masked
    logits = rng.randn(*shape).astype(np.float32)
    y = segment_softmax_sorted(torch.from_numpy(logits),
                               torch.from_numpy(dst), N,
                               mask=torch.from_numpy(mask)).numpy()
    y_ref = np.asarray(jax_segment_softmax(
        jnp.asarray(logits), jnp.asarray(dst), N, mask=jnp.asarray(mask)))
    assert y.shape == shape
    np.testing.assert_allclose(y, y_ref, atol=ATOL)
    np.testing.assert_array_equal(y[dst == dst[0]], 0.0)
    y_any = segment_softmax(torch.from_numpy(logits), torch.from_numpy(dst),
                            N, mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(y_any, y_ref, atol=ATOL)


def test_row_ptr_built_once_gives_the_same_softmax():
    """A caller that passes csr_row_ptr's row_ptr (the PAGTN module builds
    it once for all its layers) gets what segment_softmax_sorted builds
    itself, and that row_ptr equals the host-side edges_to_csr one."""
    rng = np.random.RandomState(5)
    N, E = 40, 160
    dst = np.sort(rng.randint(0, N, E)).astype(np.int32)
    mask = torch.from_numpy((rng.rand(E) > 0.2).astype(np.float32))
    logits = torch.from_numpy(rng.randn(E, 3).astype(np.float32))
    rp = csr_row_ptr(torch.from_numpy(dst), N)
    np.testing.assert_array_equal(rp.numpy(), edges_to_csr(dst, N)[1])
    a = segment_softmax_sorted(logits, torch.from_numpy(dst), N, mask=mask)
    b = segment_softmax_sorted(logits, torch.from_numpy(dst), N, mask=mask,
                               row_ptr=rp)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


# kSplitEdges in csrc/csr_segment_softmax.cu: the kernel splits a longer
# segment across its block of 8 warps
SPLIT_EDGES = 128
_SHORT = list(np.random.RandomState(9).randint(0, 34, 200))
# name: (segment lengths, H, edit of the longest segment's logits)
LONG_CASES = {
    'ghost_1536_H1': (_SHORT + [1536], 1, None),
    'ghost_1536_H4': (_SHORT[:40] + [1536] + _SHORT[40:80], 4, None),
    'segment_5000_H1': ([3, 5000, 0, 7], 1, None),
    'split_edges_pm1_H1': ([SPLIT_EDGES - 1, SPLIT_EDGES, SPLIT_EDGES + 1,
                            2, 0], 1, None),
    'split_edges_pm1_H4': ([SPLIT_EDGES + 1, 5, SPLIT_EDGES,
                            SPLIT_EDGES - 1], 4, None),
    'all_neg_1500_H1': ([5, 1500, 9], 1, 'neg'),
    'head_neg_inf_1500_H4': ([11, 1500, 0], 4, 'inf'),
}


@pytest.mark.parametrize('name', sorted(LONG_CASES))
def test_long_segments_match_jax(name):
    """Segments the kernel splits across its block (and ones at the split
    length), through the port's plain version, against the JAX kernel in
    interpret mode and its oracle: a ghost-like segment of 1536 edges
    among short ones, 5000 edges, the split length +-1, H 1 and 4, an
    all-NEG segment (1/count) and one whose last head is all -inf (0)."""
    lengths, H, edit = LONG_CASES[name]
    rp = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    logits = np.random.RandomState(len(lengths) + H).randn(
        int(rp[-1]), H).astype(np.float32) * 5
    longest = int(np.argmax(lengths))
    part = slice(rp[longest], rp[longest + 1])
    if edit == 'neg':
        logits[part] = NEG
    elif edit == 'inf':
        logits[part, -1] = -np.inf
    y = _port(logits, rp)
    np.testing.assert_allclose(y, _jax_kernel(logits, rp), atol=ATOL)
    np.testing.assert_allclose(
        y, np.asarray(jax_csr_reference(jnp.asarray(logits), jnp.asarray(rp),
                                        len(lengths))), atol=ATOL)
    if edit == 'neg':
        np.testing.assert_allclose(y[part], 1 / lengths[longest], atol=ATOL)
    elif edit == 'inf':
        np.testing.assert_array_equal(y[part, -1], 0.0)
        np.testing.assert_allclose(y[part, :-1].sum(0), 1.0, atol=1e-5)
    else:
        np.testing.assert_allclose(y[part].sum(0), 1.0, atol=1e-5)


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    logits, rp = _csr_case(seed=8)
    before = csr_segment_softmax.launches
    a = _port(logits, rp)
    b = csr_segment_softmax_reference(torch.from_numpy(logits),
                                      torch.from_numpy(rp)).numpy()
    np.testing.assert_array_equal(a, b)
    assert csr_segment_softmax.launches == before


sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import SOFTMAX_NON_FINITE  # noqa: E402


def _same_bits(a, b):
    """NaN where NaN; elsewhere equal values with equal sign bits."""
    nan = np.isnan(a)
    np.testing.assert_array_equal(nan, np.isnan(b))
    np.testing.assert_array_equal(a[~nan].view(np.int32),
                                  b[~nan].view(np.int32))


@pytest.mark.parametrize('H', [1, 3])
@pytest.mark.parametrize('length', [3, 77, 300])
@pytest.mark.parametrize('case', sorted(SOFTMAX_NON_FINITE))
def test_non_finite_logits_match_jax_bit_for_bit(case, length, H):
    """The port's P1 and its gradient equal the JAX kernel's (interpret
    mode, its custom VJP) bit for bit, NaN where NaN, with chip_smoke's
    non-finite patterns (their first ``length`` values) at random places
    in every head of a segment of finite logits, at each length the CUDA
    kernel treats apart (<= 32 edges, 33-128, > 128 split across a
    block), beside an all -inf segment (0), a finite logit among -inf ones
    (1), an empty segment and one of NaN and -inf."""
    rng = np.random.RandomState(length + H)
    lengths = [length, 5, 4, 0, 2]
    rp = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    logits = (rng.randn(int(rp[-1]), H) * 5).astype(np.float32)
    pattern = SOFTMAX_NON_FINITE[case][:length]
    for h in range(H):
        logits[rng.choice(length, len(pattern), replace=False), h] = pattern
    logits[rp[1]:] = -np.inf
    logits[rp[2] + 1] = 2.5
    logits[rp[4]] = np.nan
    w = rng.randn(*logits.shape).astype(np.float32)
    N = len(lengths)
    n_pad = -(-N // 8) * 8
    rp_pad = jnp.asarray(np.concatenate(
        [rp, np.full(n_pad - N, rp[-1], np.int32)]))
    ref = np.asarray(jax_csr_segment_softmax(jnp.asarray(logits), rp_pad,
                                             n_pad, True))
    ref_grad = np.asarray(jax.grad(lambda x: jnp.sum(
        jax_csr_segment_softmax(x, rp_pad, n_pad, True) * w))(
            jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_()
    y = csr_segment_softmax(x, torch.from_numpy(rp))
    (y * torch.from_numpy(w)).sum().backward()
    assert np.isnan(ref[:length]).any()
    _same_bits(y.detach().numpy(), ref)
    _same_bits(x.grad.numpy(), ref_grad)
