"""The port's COO message passing (P2 on the GCN, GNNModular, InfoGraph
and PNA paths, K3 over edge destinations) and P2 in bfloat16, against the
JAX package's, on the CPU.

Same inputs, made with numpy from a seed or written inline, go through
the JAX function and the port's; on the CPU each kernel wrapper runs its
plain torch version.  Tolerances: the packed batch and its CSR arrays are
equal (no arithmetic); ``gather_neighbors_sum`` and the edge-destination
``segment_sum`` and ``segment_max_sumgrad``, forward and gradient, within
1e-6 and, at ghost rows, non-finite rows and signed zeros, bit for bit
(NaN where NaN, signs of zeros equal); P2's bfloat16 plain version bit
for bit the JAX kernel run in interpret mode (NaN where NaN at
non-finite inputs, every other bit equal); ``GCNLayer``'s COO branch
within 1e-5 and its gradients within 1e-5 of max(1, |ref|) (matmuls
summed in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepchem_tpu.feat import \
    MolGraphConvFeaturizer as JaxMolGraphConvFeaturizer
from deepchem_tpu.models import GNNModular as JaxGNNModular
from deepchem_tpu.models import PNAModel as JaxPNAModel
from deepchem_tpu.models.graph_layers import GCNLayer as JaxGCNLayer
from deepchem_tpu.models.jax_model import _flatten_params
from deepchem_tpu.ops import segment as jax_segment
from deepchem_tpu.ops.pallas_segment import \
    fused_gather_segment_sum as jax_fused_gather_segment_sum
from deepchem_tpu_torch import (GNNModular, MolGraphConvFeaturizer,
                                PNAModel)
from deepchem_tpu_torch.models import GCNLayer, params_from_flax
from deepchem_tpu_torch.models.convert import flax_state
from deepchem_tpu_torch.ops import (CooCsr, coo_csr,
                                    csr_neighbor_sum_reference,
                                    dst_segment_max_sumgrad, dst_segment_sum,
                                    edges_to_csr, fused_gather_segment_sum,
                                    gather_neighbors_sum)

torch.set_num_threads(1)

SMILES = ['C/C=C/C', 'C[C@H](N)C(=O)O', '[NH4+]', 'C', '[Na+].[Cl-]', 'CCO',
          'c1ccccc1O', 'CC(=O)Oc1ccccc1C(=O)O', 'FC(F)(F)c1ccc(Cl)cc1Br',
          'N#Cc1ccncc1', 'O=S(=O)(N)c1ccc(N)cc1', 'OP(=O)(O)OP(=O)(O)O']
BASE = dict(batch_size=8)


@pytest.fixture(scope='module')
def graphs():
    return (MolGraphConvFeaturizer().featurize(SMILES),
            JaxMolGraphConvFeaturizer().featurize(SMILES))


@pytest.fixture(scope='module')
def batch(graphs):
    """The port's packed batch of the first 8 molecules, as numpy."""
    return GNNModular(device='cpu', emb_dim=8, **BASE)._graph_inputs(
        graphs[0][:8])


@pytest.mark.parametrize('which', ['gnn_modular', 'pna'])
def test_packed_batch_matches_jax_and_ships_stable_csr(graphs, which):
    """The first six arrays equal the JAX model's (the edges in its order),
    then the CSR's seven: each order a stable argsort of the edge
    arrays."""
    X, X_ref = graphs
    ours, theirs = {
        'gnn_modular': (GNNModular(device='cpu', emb_dim=8, **BASE),
                        JaxGNNModular(emb_dim=8, **BASE)),
        'pna': (PNAModel(device='cpu', hidden_dim=8, **BASE),
                JaxPNAModel(hidden_dim=8, **BASE))}[which]
    a, b = ours._graph_inputs(X[:8]), theirs._graph_inputs(X_ref[:8])
    assert len(a) == 13 and len(b) == 6
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype, i
        np.testing.assert_array_equal(x, y, err_msg=str(i))
    esrc, edst, emask = b[1], b[2], b[5]
    N = len(b[0])
    csr = CooCsr(*a[6:])
    for t in csr:
        assert t.dtype == np.int32
    perm_d = np.argsort(edst, kind='stable')
    perm_s = np.argsort(esrc, kind='stable')
    np.testing.assert_array_equal(csr.perm_dst, perm_d)
    np.testing.assert_array_equal(csr.perm_src, perm_s)
    np.testing.assert_array_equal(csr.src_by_dst, esrc[perm_d])
    np.testing.assert_array_equal(csr.dst_by_src, edst[perm_s])
    np.testing.assert_array_equal(csr.inv_dst[perm_d], np.arange(len(edst)))
    for rp, ends in ((csr.row_ptr_dst, edst), (csr.row_ptr_src, esrc)):
        np.testing.assert_array_equal(
            rp, np.searchsorted(np.sort(ends), np.arange(N + 1)))
    # the layout ops/coo.py relies on: ghost edges last->last, after every
    # real edge, and no real edge touching the last node
    ghost = emask == 0
    assert ghost.sum() > 0 and (esrc[ghost] == N - 1).all() \
        and (edst[ghost] == N - 1).all()
    assert (esrc[~ghost] < N - 1).all() and (edst[~ghost] < N - 1).all()
    assert csr.row_ptr_dst[N - 1] == csr.row_ptr_src[N - 1] == (~ghost).sum()


def _same_bits(a, b):
    """Equal, NaN where NaN, and the same signs of zeros."""
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    np.testing.assert_array_equal(a[ok], b[ok])
    np.testing.assert_array_equal(np.signbit(a[ok]), np.signbit(b[ok]))


def _node_values(rng, N, F, specials):
    """``[N, F]`` normal values; with ``specials``, rows of NaN, +-inf and
    -0 in some real nodes and in the last (ghost) node."""
    x = rng.randn(N, F).astype(np.float32)
    if specials:
        x[1, 0], x[2, 1], x[3, 2] = np.nan, np.inf, -np.inf
        x[4] = -0.0
        x[-1, 0], x[-1, 1], x[-1, 2] = np.nan, np.inf, -1.5
        x[-1, 3:] = -0.0
    return x


@pytest.mark.parametrize('specials', [False, True])
def test_gather_neighbors_sum_matches_jax(batch, specials):
    """Forward and gradient against ``jax_segment.gather_neighbors_sum``
    (``take`` of the sources times the mask, ``segment_sum`` by
    destination): within 1e-6, and bit for bit where the inputs hold NaN,
    infinities and -0 (the ghost node's row too; a ghost edge adds
    ``h[last] * 0``)."""
    nf, esrc, edst, _, _, emask = batch[:6]
    rng = np.random.RandomState(7)
    x = _node_values(rng, len(nf), 6, specials)
    g = _node_values(rng, len(nf), 6, specials)
    args = (jnp.asarray(esrc), jnp.asarray(edst), jnp.asarray(emask))
    ref, vjp = jax.vjp(
        lambda v: jax_segment.gather_neighbors_sum(v, *args), jnp.asarray(x))
    ref_g, = vjp(jnp.asarray(g))
    t = torch.from_numpy(x).requires_grad_()
    out = gather_neighbors_sum(t, *(torch.from_numpy(a) for a in
                                    (esrc, edst, emask)),
                               CooCsr(*(torch.from_numpy(a)
                                        for a in batch[6:])))
    out.backward(torch.from_numpy(g))
    if specials:
        assert np.isnan(np.asarray(ref)[-1]).any() \
            and np.isnan(np.asarray(ref_g)[-1]).any()
        _same_bits(out.detach().numpy(), ref)
        _same_bits(t.grad.numpy(), ref_g)
    else:
        np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-6)
        np.testing.assert_allclose(t.grad.numpy(), ref_g, atol=1e-6)
        # the same arithmetic in the same order: equal
        _same_bits(out.detach().numpy(), ref)


def test_gather_neighbors_sum_checks_the_layout(batch):
    nf, esrc, edst, _, _, emask = (torch.from_numpy(a) for a in batch[:6])
    x = torch.randn(len(nf), 3)
    csr = CooCsr(*(torch.from_numpy(a) for a in batch[6:]))
    bad = emask.clone()
    bad[0] = 0.0                        # a masked edge that is not a ghost
    with pytest.raises(ValueError, match='ghost'):
        gather_neighbors_sum(x, esrc, edst, bad, csr)
    # no mask: every edge counts, the ghost ones into the last node too
    ref = jax_segment.gather_neighbors_sum(
        jnp.asarray(x.numpy()), jnp.asarray(esrc.numpy()),
        jnp.asarray(edst.numpy()))
    np.testing.assert_allclose(
        gather_neighbors_sum(x, esrc, edst, None, csr).numpy(), ref,
        atol=1e-6)


@pytest.mark.parametrize('specials', [False, True])
def test_dst_segment_ops_match_jax(batch, specials):
    """PNA's aggregations over edge destinations: ``segment_sum(msgs *
    emask, edst)`` (P2 over the edges in destination order) and
    ``segment_max_sumgrad(msgs, edst, mask=emask)`` (K3 over the rows in
    destination order), forward and gradient, against the JAX ops."""
    nf, esrc, edst, _, _, emask = batch[:6]
    N, E = len(nf), len(esrc)
    rng = np.random.RandomState(11)
    msgs = _node_values(rng, E, 5, specials)
    if not specials:
        msgs[3] = msgs[4]                       # a tie
    g = rng.randn(N, 5).astype(np.float32)
    csr = CooCsr(*(torch.from_numpy(a) for a in batch[6:]))
    j_dst, j_mask = jnp.asarray(edst), jnp.asarray(emask)
    cases = {
        'sum': (lambda m: jax_segment.segment_sum(m * j_mask[:, None], j_dst,
                                                  N),
                lambda m: dst_segment_sum(
                    m * torch.from_numpy(emask)[:, None],
                    torch.from_numpy(edst), csr)),
        'max': (lambda m: jax_segment.segment_max_sumgrad(m, j_dst, N,
                                                          mask=j_mask),
                lambda m: dst_segment_max_sumgrad(
                    m, torch.from_numpy(emask), csr))}
    for name, (jax_fn, fn) in cases.items():
        ref, vjp = jax.vjp(jax_fn, jnp.asarray(msgs))
        ref_g, = vjp(jnp.asarray(g))
        t = torch.from_numpy(msgs).requires_grad_()
        out = fn(t)
        out.backward(torch.from_numpy(g))
        if specials:
            _same_bits(out.detach().numpy(), ref)
            _same_bits(t.grad.numpy(), ref_g)
        else:
            np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-6,
                                       err_msg=name)
            np.testing.assert_allclose(t.grad.numpy(), ref_g, atol=1e-6,
                                       err_msg=name)


# scripts/bench_pallas_csr.py:76-78 cut to a CPU's size: (nodes, edges,
# features); the JAX kernel needs nodes a multiple of its block of 8
BF16_SHAPES = [(256, 512, 64), (128, 256, 256), (64, 128, 512), (48, 96, 5)]


@pytest.mark.parametrize('n,e,f', BF16_SHAPES)
def test_p2_bf16_plain_version_is_the_jax_kernel_bit_for_bit(n, e, f):
    """P2 in bfloat16: the JAX kernel keeps its sum in bfloat16 and adds a
    segment's edges in CSR order; the plain version (slot by slot, each add
    rounded) gives its bits, on the bench's inputs (uniform in [0, 1)) and
    on signed ones."""
    rng = np.random.RandomState(n + f)
    src = rng.randint(0, n, e).astype(np.int32)
    dst = rng.randint(0, n, e).astype(np.int32)
    perm, row_ptr = edges_to_csr(dst, n)
    for h32 in (rng.rand(n, f), rng.randn(n, f) * 100):
        h = jnp.asarray(h32, jnp.bfloat16)
        ref = jax_fused_gather_segment_sum(h, jnp.asarray(src[perm]),
                                           jnp.asarray(row_ptr), n,
                                           interpret=True)
        th = torch.from_numpy(np.array(h.astype(jnp.float32))).to(
            torch.bfloat16)
        out = fused_gather_segment_sum(th, torch.from_numpy(src[perm]),
                                       torch.from_numpy(row_ptr))
        assert out.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            out.view(torch.int16).numpy(),
            np.asarray(ref).view(np.int16))


def _p2_bf16_jax_and_plain(h32, src, row_ptr):
    """The JAX kernel (interpret mode) and the port's plain version on the
    same bfloat16 inputs, as int16 bit patterns and NaN masks."""
    n = row_ptr.shape[0] - 1
    h = jnp.asarray(h32, jnp.bfloat16)
    ref = np.asarray(jax_fused_gather_segment_sum(
        h, jnp.asarray(src), jnp.asarray(row_ptr), n, interpret=True))
    th = torch.from_numpy(np.array(h.astype(jnp.float32))).to(
        torch.bfloat16)
    out = fused_gather_segment_sum(th, torch.from_numpy(src),
                                   torch.from_numpy(row_ptr))
    assert out.dtype == torch.bfloat16
    return (out.view(torch.int16).numpy(), torch.isnan(out).numpy(),
            ref.view(np.int16), np.isnan(ref.astype(np.float32)))


def test_p2_bf16_plain_version_is_the_jax_kernel_on_a_long_segment():
    """A segment of 300 edges at F 5, longer than the card kernel's split
    threshold (its block sums it by columns): the plain version adds its
    edges in CSR order, each add rounded, and gives the JAX kernel's bits,
    on uniform and on signed inputs.  16 nodes, a multiple of the JAX
    kernel's block of 8."""
    torch.set_num_threads(1)
    rng = np.random.RandomState(300)
    deg = rng.randint(0, 4, 16)
    deg[5] = 300
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    src = rng.randint(0, 16, int(row_ptr[-1])).astype(np.int32)
    for h32 in (rng.rand(16, 5), rng.randn(16, 5) * 100):
        out, _, ref, _ = _p2_bf16_jax_and_plain(h32, src, row_ptr)
        np.testing.assert_array_equal(out, ref)


def test_p2_bf16_plain_version_is_the_jax_kernel_at_non_finite_values():
    """P2 in bfloat16 at ±inf, NaN, bfloat16 subnormals (±1e-40), ±0,
    ±3.3e38 (whose sums overflow to ±inf), 1 and 256 (256 + 1 rounds back
    to 256), in short segments and in one of 200 edges: NaN where the JAX
    kernel has NaN, and every other bit equal (the signs of zeros and of
    infinities among them) wherever no subnormal is summed.  XLA's CPU
    backend flushes subnormal operands to zero; the port keeps them, as
    torch does on the CPU and the card: on the inputs with their
    subnormals flushed to signed zeros, the plain version gives the JAX
    kernel's bits everywhere."""
    torch.set_num_threads(1)
    rng = np.random.RandomState(29)
    deg = rng.randint(0, 4, 24)
    deg[9] = 200
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    src = rng.randint(0, 24, int(row_ptr[-1])).astype(np.int32)
    special = np.array([np.inf, -np.inf, np.nan, 1e-40, -1e-40, 0.0, -0.0,
                        3.3e38, -3.3e38, 1.0, 256.0], np.float32)
    h32 = np.where(rng.rand(24, 8) < 0.25,
                   special[rng.randint(0, len(special), (24, 8))],
                   rng.randn(24, 8).astype(np.float32) * 100)
    h32 = np.asarray(jnp.asarray(h32, jnp.bfloat16).astype(jnp.float32))
    sub = np.isfinite(h32) & (h32 != 0) & (np.abs(h32) < 2.0 ** -126)
    assert sub.any()
    # columns of each segment that sum a subnormal
    seg = np.repeat(np.arange(24), np.diff(row_ptr))
    touched = np.zeros((24, 8), bool)
    np.logical_or.at(touched, seg, sub[src])
    out, out_nan, ref, ref_nan = _p2_bf16_jax_and_plain(h32, src, row_ptr)
    assert ref_nan.any() and np.isinf(np.where(
        ref_nan, 0, ref.view(np.uint16).astype(np.uint32) << 16).view(
        np.float32)).any()
    np.testing.assert_array_equal(out_nan, ref_nan)
    keep = ~out_nan & ~touched
    np.testing.assert_array_equal(out[keep], ref[keep])
    flushed = np.where(sub, np.copysign(0.0, h32), h32)
    out, out_nan, ref, ref_nan = _p2_bf16_jax_and_plain(flushed, src,
                                                        row_ptr)
    np.testing.assert_array_equal(out_nan, ref_nan)
    np.testing.assert_array_equal(out[~out_nan], ref[~ref_nan])


def test_p2_bf16_plain_version_orders_adds_and_keeps_non_finite():
    """Adds in CSR order, each rounded: 256 + 1 + 1 stays 256 in bfloat16
    (8 bits of mantissa) where 1 + 1 + 256 gives 258; NaN and infinities
    propagate; an empty segment gives +0."""
    h = torch.tensor([[256.0, np.nan], [1.0, np.inf], [1.0, -0.0]],
                     dtype=torch.bfloat16)
    rp = torch.tensor([0, 3, 6, 6], dtype=torch.int32)
    src = torch.tensor([0, 1, 2, 1, 2, 0], dtype=torch.int32)
    out = csr_neighbor_sum_reference(h, src, rp).float().numpy()
    assert out[0, 0] == 256.0 and out[1, 0] == 258.0
    assert np.isnan(out[0, 1]) and np.isnan(out[1, 1])
    assert out[2, 0] == 0.0 and not np.signbit(out[2, 0])


@pytest.fixture(scope='module')
def layer_batch(graphs):
    return GNNModular(device='cpu', emb_dim=8, **BASE)._graph_inputs(
        graphs[0][:8])


def _scaled(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        1.0, np.abs(np.asarray(b)).max())


def test_gcn_layer_coo_branch_matches_flax(layer_batch):
    """``GCNLayer`` with no table (the COO branch) from the same flax
    weights: outputs within 1e-5, and the gradients of ``sum(out * w)`` in
    the input and every weight within 1e-5 of max(1, |ref|)."""
    nf, esrc, edst, _, _, emask = layer_batch[:6]
    deg = np.array(jax_segment.node_degrees(
        jnp.asarray(edst), len(nf), jnp.asarray(emask)))
    jax_layer = JaxGCNLayer(12, activation=jax.nn.relu)
    h = np.random.RandomState(3).randn(*nf.shape).astype(np.float32)
    args = (esrc, edst, emask, deg)
    p = jax_layer.init(jax.random.PRNGKey(1), h, *args)
    ref = jax_layer.apply(p, h, *args)
    w = np.random.RandomState(4).randn(*ref.shape).astype(np.float32)
    g_p, g_h = jax.grad(lambda q, v: jnp.sum(jax_layer.apply(q, v, *args)
                                             * w), argnums=(0, 1))(p, h)
    layer = GCNLayer(30, 12)
    params_from_flax(_flatten_params(p), layer)
    x = torch.from_numpy(h).requires_grad_()
    coo = tuple(torch.from_numpy(a) for a in (esrc, edst, emask)) + (
        CooCsr(*(torch.from_numpy(a) for a in layer_batch[6:])),)
    out = layer(x, None, torch.from_numpy(deg), coo)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5)
    assert _scaled(x.grad.numpy(), g_h) <= 1e-5
    want = flax_state(_flatten_params(g_p), layer)
    grads = dict(layer.named_parameters())
    assert set(want) == set(grads)
    for key, g in want.items():
        assert _scaled(grads[key].grad.numpy(), g.numpy()) <= 1e-5, key


def test_coo_csr_of_an_edge_list():
    """Stable orders: the edges of one node keep their list order."""
    src = np.array([2, 0, 2, 1, 0], np.int32)
    dst = np.array([1, 1, 0, 1, 2], np.int32)
    a = CooCsr(*coo_csr(src, dst, 4))
    np.testing.assert_array_equal(a.perm_dst, [2, 0, 1, 3, 4])
    np.testing.assert_array_equal(a.src_by_dst, [2, 2, 0, 1, 0])
    np.testing.assert_array_equal(a.row_ptr_dst, [0, 1, 4, 5, 5])
    np.testing.assert_array_equal(a.dst_by_src, [1, 2, 1, 1, 0])
    np.testing.assert_array_equal(a.row_ptr_src, [0, 2, 3, 5, 5])
    np.testing.assert_array_equal(a.inv_dst, [1, 2, 0, 3, 4])
