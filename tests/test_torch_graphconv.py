"""The port's GraphConv slice against the JAX package's, on the CPU.

Same inputs, made with numpy from a seed, go through the JAX function and
the port's; on the CPU each kernel wrapper (K1 ``nei_sum``, K2
``nei_max_incl_self``, K3 ``graph_max_pool``, P3 ``csr_segment_sum``)
runs its plain torch version.  Tolerances: the featurizer, the neighbour
table, the neighbour max and its winners are equal (no arithmetic, or
comparisons only); op outputs and gradients within 1e-6 (f32 sums in
another order); layers within 1e-5 and the model's logits and gradients
within 1e-5 of max(1, |ref|) (matmuls summed in another order); per-epoch
losses of a short fit within 1e-4 relative (those differences carried
through a few Adam steps); ROC-AUC within 1e-6 and 1e-12 of scikit-learn's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from sklearn.metrics import roc_auc_score as sk_roc_auc_score

from deepchem_tpu.chem import mol_from_smiles as jax_mol_from_smiles
from deepchem_tpu.data import NumpyDataset as JaxNumpyDataset
from deepchem_tpu.feat import ConvMolFeaturizer as JaxConvMolFeaturizer
from deepchem_tpu.metrics import Metric as JaxMetric
from deepchem_tpu.metrics import roc_auc_score as jax_roc_auc_score
from deepchem_tpu.models import GraphConvModel as JaxGraphConvModel
from deepchem_tpu.models.graph_layers import GraphConv as JaxGraphConv
from deepchem_tpu.models.graph_layers import GraphGather as JaxGraphGather
from deepchem_tpu.models.graph_layers import \
    MaskedBatchNorm as JaxMaskedBatchNorm
from deepchem_tpu.models.jax_model import _flatten_params
from deepchem_tpu.ops import graph_pool as jax_graph_pool
from deepchem_tpu.ops import node_degrees as jax_node_degrees
from deepchem_tpu.ops import segment_max as jax_segment_max
from deepchem_tpu.ops import segment_max_sumgrad as jax_segment_max_sumgrad
from deepchem_tpu.ops import segment_mean as jax_segment_mean
from deepchem_tpu.ops import nei_table as jax_nei_table
from deepchem_tpu.ops.pallas_segment import \
    csr_segment_sum as jax_csr_segment_sum
from deepchem_tpu_torch import (ConvMolFeaturizer, GraphConvModel, Metric,
                                NumpyDataset, roc_auc_score)
from deepchem_tpu_torch.chem import mol_from_smiles
from deepchem_tpu_torch.models import (GraphConv, GraphGather,
                                       MaskedBatchNorm, params_from_flax)
from deepchem_tpu_torch.models.convert import _torch_name
from deepchem_tpu_torch.ops import (NEG, build_neighbor_table,
                                    csr_segment_sum, graph_pool,
                                    nei_max_incl_self, nei_sum,
                                    node_degrees, segment_max,
                                    segment_max_sumgrad, segment_mean)
from deepchem_tpu_torch.trans import Transformer

torch.set_num_threads(1)

# aromatic rings, charges, halogens, S and P, bracket hydrogens, a radical,
# stereo centres, an element outside the 44-symbol vocabulary (Ga, Xe)
SMILES = ['CCO', 'c1ccccc1O', 'CC(=O)Oc1ccccc1C(=O)O',
          'CN1C=NC2=C1C(=O)N(C(=O)N2C)C', 'C[N+](C)(C)CC(=O)[O-]',
          'FC(F)(F)c1ccc(Cl)cc1Br', 'N#Cc1ccncc1', 'O=S(=O)(N)c1ccc(N)cc1',
          'CCN(CC)CCOC(=O)c1ccc(N)cc1', 'Clc1ccc2c(c1)C(=NCC(=O)N2)c1ccccc1',
          'CC(C)Cc1ccc(cc1)C(C)C(=O)O', 'OC(=O)CNCP(=O)(O)O',
          'c1ccsc1', 'C[S+](C)[O-]', 'OP(=O)(O)OP(=O)(O)O', '[NH4+]',
          'C[C@H](N)C(=O)O', 'F/C=C/F', 'Ic1ccc[nH]1', '[CH3]',
          'C[Ga](C)C', '[Xe]', 'O=[N+]([O-])c1ccc(cc1)[Se]C']
N_TASKS = 3
SMALL = dict(n_tasks=N_TASKS, batch_size=4, graph_conv_layers=[8, 8],
             dense_layer_size=16, log_frequency=3)
TRAIN = SMILES[:12]


def _graph(rng, n=40, max_deg=10):
    """A random undirected graph with degrees from 0 to ``max_deg``
    (node 0 has exactly ``max_deg`` neighbours, the last nodes none), as
    COO edges in both directions."""
    pairs = {(0, j) for j in range(1, max_deg + 1)}
    while len(pairs) < 3 * n:
        a, b = sorted(rng.randint(0, n - 4, 2))
        if a != b:
            pairs.add((a, b))
    deg = np.zeros(n, int)
    src, dst = [], []
    for a, b in sorted(pairs):
        if deg[a] < max_deg and deg[b] < max_deg or (a == 0 and b <= max_deg):
            src += [a, b]
            dst += [b, a]
            deg[a] += 1
            deg[b] += 1
    return np.array(src), np.array(dst)


def _table(rng, n=40):
    src, dst = _graph(rng, n)
    table, mask = build_neighbor_table(src, dst, n)
    return table, mask, mask.sum(1).astype(np.int8)


def test_build_neighbor_table_matches_jax():
    rng = np.random.RandomState(0)
    src, dst = _graph(rng)
    table, mask = build_neighbor_table(src, dst, 44, 10)
    ref_table, ref_mask = jax_nei_table.build_neighbor_table(src, dst, 44,
                                                             10)
    np.testing.assert_array_equal(table, ref_table)
    np.testing.assert_array_equal(mask, ref_mask)
    assert mask.sum(1).max() == 10 and mask.sum(1).min() == 0


def test_build_neighbor_table_raises_over_capacity():
    src = np.arange(1, 12)
    with pytest.raises(ValueError, match='exceeds'):
        build_neighbor_table(src, np.zeros(11, int), 12, 10)


def test_atoms_match_the_jax_molecule():
    for smi in SMILES:
        ours, ref = mol_from_smiles(smi), jax_mol_from_smiles(smi)
        for a, b in zip(ours.atoms, ref.atoms, strict=True):
            for prop in ('symbol', 'degree', 'hybridization',
                         'num_radical_electrons', 'total_hs',
                         'implicit_valence', 'formal_charge', 'is_aromatic',
                         'chirality'):
                assert getattr(a, prop) == getattr(b, prop), (smi, prop)


@pytest.mark.parametrize('kwargs', [{}, {'master_atom': True},
                                    {'use_chirality': True}])
def test_conv_mol_featurizer_matches_jax(kwargs):
    ours = ConvMolFeaturizer(**kwargs).featurize(SMILES)
    ref = JaxConvMolFeaturizer(**kwargs).featurize(SMILES)
    for smi, a, b in zip(SMILES, ours, ref):
        assert a.node_features.dtype == np.float32
        assert a.node_features.shape[1] == 75 + (
            3 if kwargs.get('use_chirality') else 0)
        np.testing.assert_array_equal(a.node_features, b.node_features,
                                      err_msg=smi)
        np.testing.assert_array_equal(a.edge_index, b.edge_index,
                                      err_msg=smi)
    # bonds in both directions, [a1 -> a2, a2 -> a1] per bond; the master
    # atom (node 3 of ethanol) joined to each atom after them
    ei = ours[0].edge_index
    np.testing.assert_array_equal(ei[:, :4], [[0, 1, 1, 2], [1, 0, 2, 1]])
    if kwargs.get('master_atom'):
        np.testing.assert_array_equal(ei[:, 4:6], [[0, 3], [3, 0]])


def test_nei_sum_matches_jax():
    rng = np.random.RandomState(1)
    table, mask, deg = _table(rng)
    h = rng.randn(len(table), 75).astype(np.float32)
    w = rng.randn(len(table), 75).astype(np.float32)

    def f(x):
        return jnp.sum(jax_nei_table.nei_sum(x, table, mask) * w)
    ref = jax_nei_table.nei_sum(h, table, mask)
    ref_grad = jax.grad(f)(h)
    x = torch.from_numpy(h).requires_grad_()
    out = nei_sum(x, torch.from_numpy(table), torch.from_numpy(deg))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), ref_grad, atol=1e-6)


@pytest.mark.parametrize('case', ['inf_behind_the_pads', 'nan_behind_the_pads',
                                  'inf_in_a_real_neighbour',
                                  'inf_cotangent'])
def test_nei_sum_matches_jax_on_non_finite_rows(case):
    """Pad slots point at row 0, and the JAX op adds their rows times 0: a
    row 0 that is not finite makes every node with a pad slot NaN there,
    forward and backward."""
    rng = np.random.RandomState(6)
    table, mask, deg = _table(rng)
    h = rng.randn(len(table), 4).astype(np.float32)
    w = rng.randn(len(table), 4).astype(np.float32)
    if case == 'inf_behind_the_pads':
        h[0, 0] = np.inf
    elif case == 'nan_behind_the_pads':
        h[0, 1] = np.nan
    elif case == 'inf_in_a_real_neighbour':
        h[table[0, 3], 2] = -np.inf            # node 0 has no pad slot
    else:
        w[0, 0], w[5, 3] = np.inf, np.nan

    def f(x):
        return jnp.sum(jax_nei_table.nei_sum(x, table, mask) * w)
    ref = jax_nei_table.nei_sum(h, table, mask)
    ref_grad = jax.grad(f)(h)
    x = torch.from_numpy(h).requires_grad_()
    out = nei_sum(x, torch.from_numpy(table), torch.from_numpy(deg))
    (out * torch.from_numpy(w)).sum().backward()
    assert not np.isfinite(ref_grad if case == 'inf_cotangent' else ref).all()
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), ref_grad, atol=1e-6)


def test_nei_sum_skips_the_backward_without_an_input_gradient():
    rng = np.random.RandomState(2)
    table, _, deg = _table(rng)
    w = torch.randn(len(table), 4, requires_grad=True)
    h = torch.from_numpy(rng.randn(len(table), 4).astype(np.float32))
    (nei_sum(h, torch.from_numpy(table), torch.from_numpy(deg)) * w) \
        .sum().backward()
    assert h.grad is None and w.grad is not None


@pytest.mark.parametrize('F', [1, 64, 75])
def test_nei_max_matches_jax_with_ties(F):
    """Integer values in 0..2, about half exact zeros as after a ReLU:
    most maxima are ties, which self wins, then the lowest slot."""
    rng = np.random.RandomState(3 + F)
    table, mask, deg = _table(rng)
    h = np.maximum(rng.randint(-2, 3, (len(table), F)), 0).astype(
        np.float32)
    g = rng.randn(len(table), F).astype(np.float32)
    ref, ref_winner = jax_nei_table._nei_max_fwd_impl(
        jnp.asarray(h), jnp.asarray(table), jnp.asarray(mask))
    ref_grad = jax.grad(lambda x: jnp.sum(
        jax_nei_table.nei_max_incl_self(x, table, mask) * g))(h)
    x = torch.from_numpy(h).requires_grad_()
    out, winner = nei_max_incl_self(x, torch.from_numpy(table),
                                    torch.from_numpy(deg),
                                    return_winner=True)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), ref)
    np.testing.assert_array_equal(winner.numpy(), ref_winner)
    assert (winner.numpy() != np.arange(len(table))[:, None]).any()
    np.testing.assert_allclose(x.grad.numpy(), ref_grad, atol=1e-6)


@pytest.mark.parametrize('case', ['neg_inf_nodes', 'below_neg_nodes',
                                  'nan_values', 'at_neg_and_infinities'])
def test_nei_max_matches_jax_below_neg_and_non_finite(case):
    """A pad slot offers NEG with its table entry: a node whose own and
    real neighbours' values are all -inf or below NEG takes NEG from its
    first pad slot, winner the pad entry, whose cotangent then goes to no
    neighbour.  A NaN never takes the max, and a NaN self keeps it."""
    rng = np.random.RandomState(7)
    table, mask, deg = _table(rng)
    n = len(table)
    h = rng.randn(n, 4).astype(np.float32)
    g = rng.randn(n, 4).astype(np.float32)
    if case == 'neg_inf_nodes':
        h[:, 0] = -np.inf
        h[rng.rand(n) < 0.3, 1] = -np.inf
    elif case == 'below_neg_nodes':
        h[:, 0] = -1e16
        h[:, 1] = rng.choice([-1e16, -2e16, -np.inf], n)
    elif case == 'nan_values':
        h[rng.rand(n, 4) < 0.2] = np.nan
    else:
        h[:, :2] = rng.choice([np.float32(NEG), -np.inf, np.inf, -1e16],
                              (n, 2))
    ref, ref_winner = jax_nei_table._nei_max_fwd_impl(
        jnp.asarray(h), jnp.asarray(table), jnp.asarray(mask))
    ref_grad = jax.grad(lambda x: jnp.sum(
        jax_nei_table.nei_max_incl_self(x, table, mask) * g))(h)
    x = torch.from_numpy(h).requires_grad_()
    out, winner = nei_max_incl_self(x, torch.from_numpy(table),
                                    torch.from_numpy(deg),
                                    return_winner=True)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), ref)
    np.testing.assert_array_equal(winner.numpy(), ref_winner)
    np.testing.assert_allclose(x.grad.numpy(), ref_grad, atol=1e-6)
    if case in ('neg_inf_nodes', 'below_neg_nodes'):
        # in feature 0 every node with a pad slot took NEG from it, winner
        # its entry 0, and the full nodes kept their own: no other node
        # won a max, so none takes a cotangent
        pad = deg < table.shape[1]
        w0 = winner.numpy()[:, 0]
        assert (out.detach().numpy()[pad, 0] == np.float32(NEG)).all()
        assert (w0[pad] == 0).all() and (w0[~pad] == np.where(~pad)[0]).all()
        assert not x.grad[~np.isin(np.arange(n), w0), 0].any()


def _pool_batch(rng, F=8):
    """Graph-contiguous rows: 6 real graphs of 0 to 5 rows (graphs 2 and 5
    empty), 2 empty slots before the ghost slot, then 5 ghost rows;
    integer values, so maxima tie."""
    sizes = [3, 5, 0, 1, 4, 0]
    num_graphs = len(sizes) + 2
    gidx = np.concatenate([np.full(s, i) for i, s in enumerate(sizes)]
                          + [np.full(5, num_graphs)]).astype(np.int32)
    n = len(gidx)
    x = rng.randint(-3, 3, (n, F)).astype(np.float32)
    mask = (gidx < num_graphs).astype(np.float32)
    return x, gidx, mask, num_graphs


@pytest.mark.parametrize('mode', ['sum', 'mean', 'max'])
def test_graph_pool_matches_jax(mode):
    rng = np.random.RandomState(4)
    x, gidx, mask, G = _pool_batch(rng)
    g = rng.randn(G, x.shape[1]).astype(np.float32)
    ref = jax_graph_pool(x, gidx, G, mask, mode)
    ref_grad = jax.grad(lambda a: jnp.sum(
        jax_graph_pool(a, gidx, G, mask, mode) * g))(x)
    t = torch.from_numpy(x).requires_grad_()
    out = graph_pool(t, torch.from_numpy(gidx), G, torch.from_numpy(mask),
                     mode)
    (out * torch.from_numpy(g)).sum().backward()
    assert out.shape == (G, x.shape[1])
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), ref_grad, atol=1e-6)


# graphs of _pool_batch: 0 rows 0-2, 1 rows 3-7, 3 row 8, 4 rows 9-12;
# 2, 5, 6 and 7 empty; ghost rows 13-17
POOL_CASES = ['neg_inf_row', 'nan_row', 'masked_nan_row', 'masked_inf_row',
              'pos_inf_max', 'signed_zero_ties', 'all_at_neg',
              'nan_ghost_row', 'inf_and_nan_cotangent']


def _special_pool_batch(case):
    rng = np.random.RandomState(8)
    x, gidx, mask, G = _pool_batch(rng, F=4)
    g = rng.randn(G, x.shape[1]).astype(np.float32)
    if case == 'neg_inf_row':
        x[1, 0] = -np.inf
    elif case == 'nan_row':
        x[4, 1] = np.nan
    elif case == 'masked_nan_row':
        x[4, 1], mask[4] = np.nan, 0.0
    elif case == 'masked_inf_row':
        x[10, 2], mask[10] = np.inf, 0.0
    elif case == 'pos_inf_max':
        x[0, 2], x[10, 3], x[11, 3] = np.inf, np.inf, -np.inf
    elif case == 'signed_zero_ties':
        x[:] = np.where(rng.rand(*x.shape) < 0.5, -0.0, 0.0)
    elif case == 'all_at_neg':
        x[:] = NEG
        x[:, 1] = -1e16
    elif case == 'nan_ghost_row':
        x[15, 0] = np.nan
    else:
        g[0, 0], g[1, 1], g[2, 2], g[4, 3] = np.inf, np.nan, np.inf, -np.inf
    return x, gidx, mask, G, g


@pytest.mark.parametrize('case', POOL_CASES)
def test_graph_pool_max_matches_jax_on_non_finite_values(case):
    """K3's plain version against the JAX op where the max or the sum meets
    NaN, infinities, signed zeros or values at NEG: the sum multiplies by
    the selection, so a non-finite row that is not selected, masked or
    not, makes the output NaN, and a non-finite cotangent the gradient of
    such rows; ghost rows stay out."""
    x, gidx, mask, G, g = _special_pool_batch(case)
    ref = jax_graph_pool(x, gidx, G, mask, 'max')
    ref_grad = jax.grad(lambda a: jnp.sum(
        jax_graph_pool(a, gidx, G, mask, 'max') * g))(x)
    t = torch.from_numpy(x).requires_grad_()
    out = graph_pool(t, torch.from_numpy(gidx), G, torch.from_numpy(mask),
                     'max')
    (out * torch.from_numpy(g)).sum().backward()
    assert not (np.isfinite(ref).all() and np.isfinite(ref_grad).all()) \
        or case in ('signed_zero_ties', 'all_at_neg', 'nan_ghost_row')
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), ref_grad, atol=1e-6)


@pytest.mark.parametrize('case', POOL_CASES)
def test_segment_max_sumgrad_matches_jax_on_non_finite_values(case):
    """The same values through segment_max_sumgrad with unsorted segment
    ids, as its COO callers give them."""
    x, gidx, mask, G, g = _special_pool_batch(case)
    perm = np.random.RandomState(9).permutation(len(x))
    x, ids, mask = x[perm], gidx[perm], mask[perm]
    g = np.concatenate([g, np.zeros_like(g[:1])])   # the ghost segment
    ref = jax_segment_max_sumgrad(x, ids, G + 1, mask)
    ref_grad = jax.grad(lambda a: jnp.sum(
        jax_segment_max_sumgrad(a, ids, G + 1, mask) * g))(x)
    t = torch.from_numpy(x).requires_grad_()
    out = segment_max_sumgrad(t, torch.from_numpy(ids), G + 1,
                              torch.from_numpy(mask))
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), ref_grad, atol=1e-6)


def _same_bits(a, b):
    """NaN where NaN; elsewhere equal values with equal sign bits, so -0.0
    differs from 0.0."""
    a, b = np.asarray(a), np.asarray(b)
    nan = np.isnan(a)
    np.testing.assert_array_equal(nan, np.isnan(b))
    np.testing.assert_array_equal(a[~nan], b[~nan])
    np.testing.assert_array_equal(np.signbit(a[~nan]), np.signbit(b[~nan]))


def _signed_zeros(rng, shape, share=0.6):
    """float32 values of which ``share`` are zeros, half of them -0.0."""
    a = rng.randn(*shape).astype(np.float32)
    zero = rng.rand(*shape) < share
    a[zero] = np.where(rng.rand(int(zero.sum())) < 0.5, -0.0, 0.0)
    return a


@pytest.mark.parametrize('op', ['nei_sum', 'nei_max_incl_self',
                                'graph_pool_max', 'csr_segment_sum'])
def test_plain_versions_give_jax_signs_of_zero(op):
    """Inputs and cotangents holding +0 and -0 through the JAX ops and the
    port's plain versions, forward and gradient: equal values and equal
    sign bits.  The JAX sums start from their first term (nei_sum: a node
    whose every term is -0, as at degree 0 with a negative row 0 behind
    its pads, gives -0) or from +0 (segment sums: P3, the readout's
    numerator), and nei_max's backward adds +0.0 for each term it does
    not take, so it gives -0 only where a node took every term."""
    rng = np.random.RandomState(11)
    table, mask, deg = _table(rng)
    n, F = len(table), 6
    if op in ('nei_sum', 'nei_max_incl_self'):
        h = _signed_zeros(rng, (n, F))
        h[0] = -np.abs(h[0])                      # row 0, behind the pads
        h[:, 0] = -0.0
        w = _signed_zeros(rng, (n, F))
        w[:, 1] = -0.0
        jax_op = getattr(jax_nei_table, op)
        torch_op = nei_sum if op == 'nei_sum' else nei_max_incl_self
        ref = jax_op(h, table, mask)
        ref_grad = jax.grad(lambda a: jnp.sum(jax_op(a, table, mask) * w))(h)
        x = torch.from_numpy(h).requires_grad_()
        out = torch_op(x, torch.from_numpy(table), torch.from_numpy(deg))
    elif op == 'graph_pool_max':
        h, gidx, mask, G = _pool_batch(rng, F)
        h[:] = np.where(rng.rand(*h.shape) < 0.5, -0.0, 0.0)
        h[:, 0] = -0.0
        h[1:4, 1] = -1.0
        w = _signed_zeros(rng, (G, F))
        w[:, 2] = -0.0
        ref = jax_graph_pool(h, gidx, G, mask, 'max')
        ref_grad = jax.grad(lambda a: jnp.sum(
            jax_graph_pool(a, gidx, G, mask, 'max') * w))(h)
        x = torch.from_numpy(h).requires_grad_()
        out = graph_pool(x, torch.from_numpy(gidx), G,
                         torch.from_numpy(mask), 'max')
    else:                                  # P3 has no JAX gradient
        msgs = _signed_zeros(rng, (60, F), share=0.9)
        msgs[:, 0] = -0.0
        rp = np.array([0, 0, 5, 6, 6, 20, 33, 47, 60], np.int32)
        ref = jax_csr_segment_sum(jnp.asarray(msgs), jnp.asarray(rp), 8,
                                  block_nodes=8, interpret=True)
        out = csr_segment_sum(torch.from_numpy(msgs), torch.from_numpy(rp))
        _same_bits(out.numpy(), ref)
        return
    (out * torch.from_numpy(w)).sum().backward()
    assert any(np.signbit(a[a == 0]).any()
               for a in map(np.asarray, (ref, ref_grad)))
    _same_bits(out.detach().numpy(), ref)
    _same_bits(x.grad.numpy(), ref_grad)


@pytest.mark.parametrize('mode', ['sum', 'mean', 'max'])
def test_graph_pool_raises_on_unsorted_graph_index(mode):
    """The readouts run over a row pointer of graph-contiguous rows: on
    the CPU a graph_index that decreases raises instead of giving wrong
    sums."""
    x = torch.ones(4, 2)
    gidx = torch.tensor([0, 1, 0, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match='non-decreasing'):
        graph_pool(x, gidx, 2, None, mode)


def test_segment_ops_match_jax():
    rng = np.random.RandomState(5)
    x = rng.randint(-3, 3, (20, 4)).astype(np.float32)
    ids = rng.randint(0, 7, 20).astype(np.int32)   # unsorted, 7 empty
    mask = (rng.rand(20) > 0.3).astype(np.float32)
    tx, tids, tmask = map(torch.from_numpy, (x, ids, mask))
    np.testing.assert_allclose(segment_max(tx, tids, 8).numpy(),
                               jax_segment_max(x, ids, 8), atol=1e-6)
    np.testing.assert_allclose(segment_mean(tx, tids, 8).numpy(),
                               jax_segment_mean(x, ids, 8), atol=1e-6)
    np.testing.assert_array_equal(node_degrees(tids, 8, tmask).numpy(),
                                  jax_node_degrees(ids, 8, mask))
    g = rng.randn(8, 4).astype(np.float32)
    ref_grad = jax.grad(lambda a: jnp.sum(
        jax_segment_max_sumgrad(a, ids, 8, mask) * g))(x)
    t = tx.clone().requires_grad_()
    out = segment_max_sumgrad(t, tids, 8, tmask)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               jax_segment_max_sumgrad(x, ids, 8, mask),
                               atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), ref_grad, atol=1e-6)


def test_layers_match_jax():
    rng = np.random.RandomState(6)
    table, mask, deg = _table(rng)
    n = len(table)
    h = rng.randn(n, 12).astype(np.float32)
    nmask = (np.arange(n) < n - 4).astype(np.float32)
    tt, tdeg = torch.from_numpy(table), torch.from_numpy(deg)

    bn = JaxMaskedBatchNorm()
    p = bn.init(jax.random.PRNGKey(0), h, nmask)
    p = {'params': {'scale': rng.rand(12).astype(np.float32) + .5,
                    'bias': rng.randn(12).astype(np.float32)}}
    ours = MaskedBatchNorm(12)
    ours.scale.data = torch.from_numpy(p['params']['scale'])
    ours.bias.data = torch.from_numpy(p['params']['bias'])
    for m in (nmask, None):
        np.testing.assert_allclose(
            ours(torch.from_numpy(h),
                 None if m is None else torch.from_numpy(m))
            .detach().numpy(), bn.apply(p, h, m), atol=1e-5)

    conv = JaxGraphConv(6)
    deg32 = deg.astype(np.int32)
    p = conv.init(jax.random.PRNGKey(1), h, None, None, None, deg32, table,
                  mask)
    p = {'params': {**p['params'], 'b': rng.randn(11, 6).astype(
        np.float32)}}
    ours = GraphConv(12, 6)
    for k in ('W_self', 'W_nbr', 'b'):
        getattr(ours, k).data = torch.from_numpy(np.array(p['params'][k]))
    np.testing.assert_allclose(
        ours(torch.from_numpy(h), tt, tdeg).detach().numpy(),
        conv.apply(p, h, None, None, None, deg32, table, mask), atol=1e-5)

    gidx = np.repeat(np.arange(5), [8, 8, 8, 0, 12]).astype(np.int32)
    gidx = np.concatenate([gidx, np.full(n - len(gidx), 5)]).astype(
        np.int32)
    ref = JaxGraphGather().apply({}, h, gidx, nmask, 5)
    np.testing.assert_allclose(
        GraphGather()(torch.from_numpy(h), torch.from_numpy(gidx),
                      torch.from_numpy(nmask), 5).numpy(), ref, atol=1e-5)


def test_graph_conv_weights_start_as_flax_glorot_uniform():
    conv = GraphConv(75, 64, generator=torch.Generator().manual_seed(0))
    limit = np.sqrt(6.0 / (11 * 75 + 11 * 64))
    for w in (conv.W_self, conv.W_nbr):
        assert w.abs().max().item() <= limit
        assert w.abs().max().item() > 0.99 * limit
    assert not conv.b.detach().any()


@pytest.fixture(scope='module')
def data():
    labels = np.random.RandomState(0).randint(0, 2, (len(TRAIN), N_TASKS))
    labels[:2] = [[0, 1, 0], [1, 0, 1]]       # both classes in every task
    weights = np.ones_like(labels, dtype=np.float32)
    weights[1, 2] = 0.0                        # one masked label
    X = ConvMolFeaturizer().featurize(TRAIN)
    X_ref = JaxConvMolFeaturizer().featurize(TRAIN)
    return (NumpyDataset(X, labels.astype(np.float32), weights),
            JaxNumpyDataset(X_ref, labels.astype(np.float32), weights))


def _pair(data, **kwargs):
    """A JAX model and a port model with the same initial parameters."""
    ds, ds_ref = data
    kw = {**SMALL, **kwargs}
    ref = JaxGraphConvModel(data_parallel=False, **kw)
    ref.predict(ds_ref)                               # builds the params
    model = GraphConvModel(device='cpu', **kw)
    params_from_flax(_flatten_params(ref.params), model.module)
    return ref, model


def _scaled(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        1.0, np.abs(np.asarray(b)).max())


@pytest.mark.parametrize('mode', ['classification', 'regression'])
def test_model_outputs_and_gradients_match_flax(data, mode):
    ref, model = _pair(data, mode=mode)
    ds, _ = data
    inputs, labels, weights = next(model.default_generator(ds))
    assert inputs[6].dtype == np.int32 and inputs[7].dtype == np.int8
    if mode == 'regression':
        labels = [np.asarray(ds.y[:4])]
    j_in = [jnp.asarray(a) for a in inputs]
    ref_out = jax.jit(lambda p: ref._forward(p, j_in, training=False,
                                             rng=None))(ref.params)

    def loss_fn(p):
        outputs = ref._forward(p, j_in, training=True,
                               rng=jax.random.PRNGKey(0))
        return ref._compute_loss(outputs, [jnp.asarray(labels[0])],
                                 [jnp.asarray(weights[0])])
    loss_ref, g_ref = jax.jit(jax.value_and_grad(loss_fn))(ref.params)
    t_in, t_lab, t_w = model._prepare_batch((inputs, labels, weights))
    model.module.eval()
    with torch.no_grad():
        out = model.module(*t_in)
    out = out[1] if mode == 'classification' else out
    want = ref_out[1] if mode == 'classification' else ref_out[0]
    assert _scaled(out.numpy(), want) <= 1e-5
    loss = model._train_step(t_in, t_lab, t_w)
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
    grads = dict(model.module.named_parameters())
    flat = _flatten_params(g_ref)
    assert len(flat) == len(grads)
    scopes = model.module.flax_scopes
    for key, g in flat.items():
        g = np.asarray(g)
        ours = grads[_torch_name(key, scopes)].grad.numpy()
        want = g.T if key.endswith('/kernel') else g
        assert _scaled(ours, want) <= 1e-5, key


def test_uncertainty_outputs_match_flax_in_eval(data):
    ref, model = _pair(data, mode='regression', uncertainty=True,
                       dropout=0.2)
    ds, ds_ref = data
    ours = model.predict(ds, output_types=['prediction', 'variance'])
    want = ref.predict(ds_ref, output_types=['prediction', 'variance'])
    assert len(ours) == 2 and ours[0].shape == (len(TRAIN), N_TASKS)
    for a, b in zip(ours, want):
        assert _scaled(a, b) <= 1e-5
    # the Gaussian likelihood loss, through the dropout of training
    assert np.isfinite(model.fit(ds, nb_epoch=1, checkpoint_interval=0))


def test_fit_follows_the_jax_losses_and_evaluate_its_roc_auc(data):
    """From the same weights: evaluate's ROC-AUC against the JAX model's,
    then 2 epochs of fit (3 batches, the last short and padded; one loss
    window an epoch) on both sides."""
    ds, ds_ref = data
    ref, model = _pair(data, learning_rate=0.003)
    score = model.evaluate(ds, [Metric(roc_auc_score, np.mean)])
    ref_score = ref.evaluate(ds_ref, [JaxMetric(jax_roc_auc_score,
                                                np.mean)])
    assert set(score) == {'roc_auc_score'}
    np.testing.assert_allclose(score['roc_auc_score'],
                               ref_score['roc_auc_score'], atol=1e-6)
    ref_losses, losses = [], []
    ref_last = ref.fit(ds_ref, nb_epoch=2, checkpoint_interval=0,
                       all_losses=ref_losses)
    last = model.fit(ds, nb_epoch=2, checkpoint_interval=0,
                     all_losses=losses)
    assert len(losses) == len(ref_losses) == 2
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    np.testing.assert_allclose(last, ref_last, rtol=1e-4)
    assert model.get_global_step() == ref.get_global_step() == 6


def test_fit_on_device_follows_the_jax_losses(data):
    """2 epochs of fit_on_device from the same weights, in the order of
    the seed's permutations; then predict_on_device against predict, on
    the fitted dataset (its resident batches) and on another."""
    ds, ds_ref = data
    ref, model = _pair(data, learning_rate=0.003)
    ref_losses, losses = [], []
    ref_last = ref.fit_on_device(ds_ref, nb_epoch=2, seed=3,
                                 all_losses=ref_losses)
    last = model.fit_on_device(ds, nb_epoch=2, seed=3, all_losses=losses)
    assert len(losses) == len(ref_losses) == 2
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    np.testing.assert_allclose(last, ref_last, rtol=1e-4)
    assert model.get_global_step() == ref.get_global_step() == 6
    np.testing.assert_array_equal(model.predict_on_device(ds),
                                  model.predict(ds))
    other = NumpyDataset(ds.X[3:10], ds.y[3:10], ds.w[3:10])
    np.testing.assert_array_equal(model.predict_on_device(other),
                                  model.predict(other))


def test_evaluate_raises_on_a_label_transformer(data):
    """A transformer of the labels that cannot undo itself raises, as the
    JAX package's base ``Transformer`` does."""
    ds, _ = data
    model = GraphConvModel(device='cpu', **SMALL)

    class Scale(Transformer):
        def __init__(self):
            super().__init__(transform_y=True)
    with pytest.raises(NotImplementedError):
        model.evaluate(ds, [Metric(roc_auc_score)], [Scale()])


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_roc_auc_score_matches_sklearn_with_ties(seed):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 2, 200)
    score = np.round(rng.rand(200), 1)          # 11 distinct values
    w = rng.rand(200)
    assert abs(roc_auc_score(y, score) - sk_roc_auc_score(y, score)) \
        <= 1e-12
    assert abs(roc_auc_score(y, score, sample_weight=w)
               - sk_roc_auc_score(y, score, sample_weight=w)) <= 1e-12
    with pytest.raises(ValueError):
        roc_auc_score(np.ones(5), rng.rand(5))
