"""The port's CSR segment sums (P3, P2) and the P1 softmax's backward
against the JAX package, on the CPU.

On the CPU each wrapper takes its plain torch version.  P3 and P2 are held
against the JAX Pallas kernels in interpret mode and the JAX oracle
``csr_neighbor_sum_reference``, on the cases of tests/test_pallas_ops.py
(random graph, empty segments), atol 1e-5 as there: f32 sums in another
order.  The JAX grid needs node counts that are multiples of 8, so those
cases use 32, 64 and 16 nodes.  P1's gradient is held against ``jax.grad``
through the JAX custom VJP in interpret mode, atol 1e-6: the same formula
on the same f32 inputs.  The CUDA kernels themselves are compared with
these plain versions in tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepchem_tpu.ops.pallas_segment import (
    csr_neighbor_sum_reference as jax_neighbor_sum_reference,
    csr_segment_softmax as jax_csr_segment_softmax,
    csr_segment_sum as jax_csr_segment_sum,
    fused_gather_segment_sum as jax_fused_gather_segment_sum)
from deepchem_tpu_torch.ops import (csr_neighbor_sum_reference,
                                    csr_segment_softmax,
                                    csr_segment_softmax_reference,
                                    csr_segment_sum,
                                    csr_segment_sum_reference, edges_to_csr,
                                    fused_gather_segment_sum, segment_sum)

torch.set_num_threads(1)
ATOL = 1e-5
GRAD_ATOL = 1e-6


def _random_graph(n_nodes=32, n_edges=96, f=16, seed=0):
    rng = np.random.RandomState(seed)
    h = rng.rand(n_nodes, f).astype(np.float32)
    src = rng.randint(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.randint(0, n_nodes, n_edges).astype(np.int32)
    return h, src, dst


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize('n_nodes,n_edges,f,seed', [(32, 96, 16, 0),
                                                    (64, 200, 32, 1),
                                                    (32, 96, 3, 2)])
def test_csr_segment_sum_matches_jax(n_nodes, n_edges, f, seed):
    h, src, dst = _random_graph(n_nodes, n_edges, f, seed)
    perm, row_ptr = edges_to_csr(dst, n_nodes)
    msgs = h[src][perm]
    out = csr_segment_sum(*_t(msgs, row_ptr)).numpy()
    ref = jax_csr_segment_sum(jnp.asarray(msgs), jnp.asarray(row_ptr),
                              n_nodes, block_nodes=8, interpret=True)
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)
    oracle = jax_neighbor_sum_reference(jnp.asarray(h),
                                        jnp.asarray(src[perm]),
                                        jnp.asarray(row_ptr), n_nodes)
    np.testing.assert_allclose(out, np.asarray(oracle), atol=ATOL)


@pytest.mark.parametrize('n_nodes,n_edges,f,seed', [(64, 200, 32, 1),
                                                    (32, 96, 16, 2),
                                                    (32, 96, 5, 3)])
def test_fused_gather_segment_sum_matches_jax(n_nodes, n_edges, f, seed):
    h, src, dst = _random_graph(n_nodes, n_edges, f, seed)
    perm, row_ptr = edges_to_csr(dst, n_nodes)
    out = fused_gather_segment_sum(*_t(h, src[perm], row_ptr)).numpy()
    ref = jax_fused_gather_segment_sum(
        jnp.asarray(h), jnp.asarray(src[perm]), jnp.asarray(row_ptr),
        n_nodes, block_nodes=8, interpret=True)
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)
    oracle = jax_neighbor_sum_reference(jnp.asarray(h),
                                        jnp.asarray(src[perm]),
                                        jnp.asarray(row_ptr), n_nodes)
    np.testing.assert_allclose(out, np.asarray(oracle), atol=ATOL)
    np.testing.assert_array_equal(
        out, csr_neighbor_sum_reference(*_t(h, src[perm], row_ptr)).numpy())


# kSplitEdges in csrc/csr_segment_sum.cu and csrc/fused_gather_segment_sum.cu
# (P3 and P2): on the card a longer segment is split across the kernel's
# block of 8 warps
SPLIT_EDGES = 128


@pytest.mark.parametrize('long_len,f', [(SPLIT_EDGES - 1, 32),
                                        (SPLIT_EDGES, 32),
                                        (SPLIT_EDGES + 1, 32),
                                        (2 * SPLIT_EDGES + 5, 1),
                                        (1536, 32)])
def test_csr_segment_sum_long_segments_match_jax(long_len, f):
    """Segments around the kernel's split threshold, and a ghost-like
    segment of 1.5k edges (PAGTN's padding points every padded edge at the
    last node): the plain version against the JAX Pallas kernel in
    interpret mode.  Two long segments share the last block of 8 nodes,
    beside short and empty ones."""
    rng = np.random.RandomState(long_len + f)
    lengths = list(rng.randint(0, 6, 13)) + [long_len, 0, long_len + 3]
    row_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    msgs = rng.randn(int(row_ptr[-1]), f).astype(np.float32)
    out = csr_segment_sum(*_t(msgs, row_ptr)).numpy()
    ref = jax_csr_segment_sum(jnp.asarray(msgs), jnp.asarray(row_ptr),
                              len(lengths), block_nodes=8, interpret=True)
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)
    np.testing.assert_array_equal(out[14], 0.0)


@pytest.mark.parametrize('long_len,f,ghost', [
    (SPLIT_EDGES - 1, 32, False), (SPLIT_EDGES, 32, False),
    (SPLIT_EDGES + 1, 32, False), (SPLIT_EDGES + 1, 1, False),
    (SPLIT_EDGES + 1, 75, False), (SPLIT_EDGES - 1, 300, False),
    (1536, 1, True), (1536, 32, True), (1536, 75, True)])
def test_fused_gather_segment_sum_long_segments_match_jax(long_len, f,
                                                          ghost):
    """P2's plain version against the JAX Pallas kernel in interpret mode:
    segments around the kernel's split threshold, two long ones sharing
    the last block of 8 nodes beside short and empty ones; or a ghost-like
    last segment of 1536 edges all from the last node, as the COO layout
    points every ghost edge (ops/coo.py)."""
    rng = np.random.RandomState(long_len + f)
    n_nodes = 16
    lengths = list(rng.randint(0, 6, 15)) + [long_len] if ghost else \
        list(rng.randint(0, 6, 13)) + [long_len, 0, long_len + 3]
    row_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    h = rng.randn(n_nodes, f).astype(np.float32)
    src = rng.randint(0, n_nodes - 1, int(row_ptr[-1])).astype(np.int32)
    if ghost:
        src[row_ptr[-2]:] = n_nodes - 1
    out = fused_gather_segment_sum(*_t(h, src, row_ptr)).numpy()
    ref = jax_fused_gather_segment_sum(
        jnp.asarray(h), jnp.asarray(src), jnp.asarray(row_ptr), n_nodes,
        block_nodes=8, interpret=True)
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)
    if not ghost:
        np.testing.assert_array_equal(out[14], 0.0)


def test_empty_segments():
    """Nodes with no incoming edges give zeros (tests/test_pallas_ops.py
    test_empty_segments), in both sums."""
    h = np.ones((16, 8), dtype=np.float32)
    dst = np.array([3, 3, 7], dtype=np.int32)
    src = np.array([0, 1, 2], dtype=np.int32)
    perm, row_ptr = edges_to_csr(dst, 16)
    out = fused_gather_segment_sum(*_t(h, src[perm], row_ptr)).numpy()
    ref = np.asarray(jax_fused_gather_segment_sum(
        jnp.asarray(h), jnp.asarray(src[perm]), jnp.asarray(row_ptr), 16,
        block_nodes=8, interpret=True))
    np.testing.assert_allclose(out, ref, atol=ATOL)
    assert np.allclose(out[3], 2.0) and np.allclose(out[7], 1.0)
    assert np.allclose(out[0], 0.0) and np.allclose(out[15], 0.0)
    sums = csr_segment_sum(*_t(h[src[perm]], row_ptr)).numpy()
    np.testing.assert_array_equal(sums, out)


def test_edges_past_the_last_segment_are_ignored():
    """row_ptr[N] < E: the tail edges belong to no segment."""
    msgs = np.arange(20, dtype=np.float32).reshape(10, 2)
    row_ptr = np.array([0, 2, 2, 6], np.int32)
    out = csr_segment_sum(*_t(msgs, row_ptr)).numpy()
    np.testing.assert_array_equal(
        out, [msgs[0:2].sum(0), [0, 0], msgs[2:6].sum(0)])


def test_segment_sum_backward_matches_autograd_through_segment_sum():
    """P3's backward, the gather dy[seg], against autograd through the
    scatter segment_sum; edges past row_ptr[N] get 0."""
    rng = np.random.RandomState(4)
    N, E, Fm = 12, 50, 6
    dst = np.sort(rng.randint(0, N, E)).astype(np.int32)
    _, row_ptr = edges_to_csr(dst, N)
    row_ptr[-1] = E - 3                     # three tail edges in no segment
    msgs, dy = _t(rng.randn(E, Fm).astype(np.float32),
                  rng.randn(N, Fm).astype(np.float32))
    a = msgs.clone().requires_grad_()
    (csr_segment_sum(a, torch.from_numpy(row_ptr)) * dy).sum().backward()
    b = msgs.clone().requires_grad_()
    seg = torch.from_numpy(dst).long()
    (segment_sum(b[:E - 3], seg[:E - 3], N) * dy).sum().backward()
    np.testing.assert_array_equal(a.grad.numpy(), b.grad.numpy())
    assert np.all(a.grad.numpy()[E - 3:] == 0)


def _softmax_case(N=64, E=300, H=4, seed=3):
    rng = np.random.RandomState(seed)
    perm, row_ptr = edges_to_csr(rng.randint(0, N, E), N)
    return rng.randn(E, H).astype(np.float32)[perm], row_ptr


@pytest.mark.parametrize('N,E,H,seed', [(64, 300, 4, 3), (64, 300, 1, 5),
                                        (16, 40, 2, 6)])
def test_softmax_grad_matches_jax_custom_vjp(N, E, H, seed):
    """Mirrors tests/test_csr_softmax.py test_kernel_custom_vjp_matches_
    oracle: the gradient of sum(softmax * w)."""
    logits, row_ptr = _softmax_case(N, E, H, seed)
    w = np.random.RandomState(7).randn(E, H).astype(np.float32)
    g_ref = jax.grad(lambda l: jnp.sum(jax_csr_segment_softmax(
        l, jnp.asarray(row_ptr), N, True) * w))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    (csr_segment_softmax(x, torch.from_numpy(row_ptr))
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_ref),
                               atol=GRAD_ATOL)


def test_softmax_grad_on_masked_and_single_segments():
    """All-NEG, -inf, one-edge and empty segments: the Function's gradient
    equals autograd through the plain version."""
    row_ptr = np.array([0, 3, 5, 5, 6, 10], np.int32)
    rng = np.random.RandomState(2)
    logits = rng.randn(10, 2).astype(np.float32) * 30
    logits[3:5] = -9e15
    logits[6:10, 1] = -np.inf
    w = torch.from_numpy(rng.randn(10, 2).astype(np.float32))
    grads = []
    for fn in (csr_segment_softmax, csr_segment_softmax_reference):
        x = torch.from_numpy(logits).requires_grad_()
        (fn(x, torch.from_numpy(row_ptr)) * w).sum().backward()
        grads.append(x.grad.numpy())
    assert np.all(np.isfinite(grads[0]))
    np.testing.assert_allclose(grads[0], grads[1], atol=GRAD_ATOL)
    np.testing.assert_array_equal(grads[0][5], 0.0)      # one-edge segment


def test_softmax_output_carries_a_gradient():
    logits, row_ptr = _softmax_case()
    x = torch.from_numpy(logits)
    y = csr_segment_softmax(x.requires_grad_(), torch.from_numpy(row_ptr))
    assert y.grad_fn is not None and y.requires_grad
    with torch.no_grad():
        assert csr_segment_softmax(x, torch.from_numpy(row_ptr)).grad_fn \
            is None


def test_softmax_backward_runs_the_segment_sum_wrapper(monkeypatch):
    """On the card the backward's segment sum is the P3 kernel: the
    backward reaches it through csr_segment_sum."""
    from deepchem_tpu_torch.ops import csr_segment
    calls = []

    def spy(msgs, row_ptr):
        calls.append(tuple(msgs.shape))
        return csr_segment_sum(msgs, row_ptr)
    monkeypatch.setattr(csr_segment, 'csr_segment_sum', spy)
    logits, row_ptr = _softmax_case(H=1)
    x = torch.from_numpy(logits).requires_grad_()
    csr_segment_softmax(x, torch.from_numpy(row_ptr)).sum().backward()
    assert calls == [(300, 1)]


def test_plain_versions_launch_nothing_and_p2_is_forward_only():
    h, src, dst = _random_graph(seed=5)
    perm, row_ptr = edges_to_csr(dst, 32)
    before = (csr_segment_sum.launches, fused_gather_segment_sum.launches)
    a = csr_segment_sum(*_t(h[src][perm], row_ptr))
    np.testing.assert_array_equal(
        a.numpy(), csr_segment_sum_reference(*_t(h[src][perm],
                                                 row_ptr)).numpy())
    fused_gather_segment_sum(*_t(h, src[perm], row_ptr))
    assert (csr_segment_sum.launches,
            fused_gather_segment_sum.launches) == before
    with pytest.raises(RuntimeError, match='no backward'):
        fused_gather_segment_sum(torch.from_numpy(h).requires_grad_(),
                                 *_t(src[perm], row_ptr))
