"""The port's MPNN slice against the JAX package's, on the CPU.

Same inputs, made with numpy from a seed or written inline, go through
the JAX function and the port's; on the CPU each kernel wrapper (K1 in
``nei_sum_edges`` and ``take_src``'s backward, P1 and P3 in the set2set
readout) runs its plain torch version.  Tolerances: the featurizer's
arrays, the bonds' stereo and the packed batch (edge-id tables and
degrees) are equal (no arithmetic); ``nei_sum_edges`` and ``take_src``
forward and gradient within 1e-6 (f32 sums in another order), and bit for
bit, NaN where NaN and signs of zeros equal, on rows that are not finite
or are signed zeros; the GRU and LSTM cells within 1e-6 and the layers
within 1e-5 (matmuls summed in another order); the model's outputs and
every gradient from the same flax weights within 1e-5 of max(1, |ref|);
per-epoch losses of a 2-epoch fit within 1e-4 relative (those
differences carried through a few Adam steps); the transformer and the
regression metrics within 1e-12 (the same float64 numpy formulas); and
``evaluate`` through the transformer within 1e-6 of the JAX model's.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from deepchem_tpu.chem import mol_from_smiles as jax_mol_from_smiles
from deepchem_tpu.data import NumpyDataset as JaxNumpyDataset
from deepchem_tpu.feat import \
    MolGraphConvFeaturizer as JaxMolGraphConvFeaturizer
from deepchem_tpu.metrics import Metric as JaxMetric
from deepchem_tpu.metrics import score_function as jax_scores
from deepchem_tpu.models import MPNNModel as JaxMPNNModel
from deepchem_tpu.models.graph_layers import \
    EdgeNetworkMPNN as JaxEdgeNetworkMPNN
from deepchem_tpu.models.graph_layers import SetGather as JaxSetGather
from deepchem_tpu.models.jax_model import _flatten_params
from deepchem_tpu.ops import nei_table as jax_nei_table
from deepchem_tpu.trans import \
    NormalizationTransformer as JaxNormalizationTransformer
from deepchem_tpu_torch import (Metric, MolGraphConvFeaturizer, MPNNModel,
                                NormalizationTransformer, NumpyDataset,
                                mae_score, pearson_r2_score, rms_score)
from deepchem_tpu_torch.chem import mol_from_smiles
from deepchem_tpu_torch.models import (EdgeNetworkMPNN, GRUCell, LSTMCell,
                                       SetGather, params_from_flax)
from deepchem_tpu_torch.models.convert import flax_state
from deepchem_tpu_torch.ops import (build_neighbor_table, nei_sum_edges,
                                    take_src)

torch.set_num_threads(1)

# trans and cis double bonds (marks before and after a ring digit too),
# charged atoms, a single atom, aromatic rings, halogens, S and P
SMILES = ['C/C=C/C', 'F/C=C\\F', 'C/C=C\\C(=O)O', 'C/1=C/CCCCCC1',
          'CC/C=C(/C)C1CCCC1', '[NH4+]', 'C[N+](C)(C)CC(=O)[O-]', 'C',
          '[Na+].[Cl-]', 'CCO', 'c1ccccc1O', 'CC(=O)Oc1ccccc1C(=O)O',
          'CN1C=NC2=C1C(=O)N(C(=O)N2C)C', 'FC(F)(F)c1ccc(Cl)cc1Br',
          'N#Cc1ccncc1', 'O=S(=O)(N)c1ccc(N)cc1', 'OP(=O)(O)OP(=O)(O)O',
          'CC(C)Cc1ccc(cc1)C(C)C(=O)O', 'c1ccsc1', 'C[C@H](N)C(=O)O',
          'Clc1ccc2c(c1)C(=NCC(=O)N2)c1ccccc1', 'O=C(O)/C=C/c1ccccc1',
          'CCCCOC(=O)c1ccccc1C(=O)OCCCC', 'Ic1ccc[nH]1', 'CC#N']
N_TASKS = 2
SMALL = dict(n_tasks=N_TASKS, node_dim=16, T=2, M=2, batch_size=10,
             log_frequency=3)


def test_bond_stereo_matches_the_jax_molecule():
    seen = set()
    for smi in SMILES:
        ours, ref = mol_from_smiles(smi), jax_mol_from_smiles(smi)
        for a, b in zip(ours.bonds, ref.bonds, strict=True):
            for prop in ('a1', 'a2', 'order', 'stereo_dir', 'stereo',
                         'stereo_atoms'):
                assert getattr(a, prop) == getattr(b, prop), (smi, prop)
            seen.add(a.stereo)
    assert seen == {'', 'cis', 'trans'}


@pytest.mark.parametrize('kwargs', [{'use_edges': True}, {},
                                    {'use_edges': True, 'use_chirality': True,
                                     'use_partial_charge': True}])
def test_mol_graph_conv_featurizer_matches_jax(kwargs):
    ours = MolGraphConvFeaturizer(**kwargs).featurize(SMILES)
    ref = JaxMolGraphConvFeaturizer(**kwargs).featurize(SMILES)
    for smi, a, b in zip(SMILES, ours, ref, strict=True):
        assert a.node_features.dtype == np.float32
        assert a.node_features.shape[1] == 30 + (
            3 if kwargs.get('use_chirality') else 0)
        np.testing.assert_array_equal(a.node_features, b.node_features,
                                      err_msg=smi)
        np.testing.assert_array_equal(a.edge_index, b.edge_index,
                                      err_msg=smi)
        if kwargs.get('use_edges'):
            assert a.edge_features.shape == (a.num_edges, 11)
            np.testing.assert_array_equal(a.edge_features, b.edge_features,
                                          err_msg=smi)
        else:
            assert a.edge_features is None and b.edge_features is None
    if not kwargs.get('use_edges'):
        return
    # stereo one-hot: none, any, Z, E, cis (columns 6 to 10); trans has
    # no column of its own
    ef = {smi: g.edge_features for smi, g in zip(SMILES, ours)}
    assert ef['C'].shape == (0, 11)
    assert ef['F/C=C\\F'][2, 10] == 1.0 and ef['C/C=C/C'][2, 6:].sum() == 0
    assert ef['C/C=C/C'][0, 7] == 1.0          # a marked single bond: any


@pytest.fixture(scope='module')
def graphs():
    return (MolGraphConvFeaturizer(use_edges=True).featurize(SMILES),
            JaxMolGraphConvFeaturizer(use_edges=True).featurize(SMILES))


def test_packed_batch_and_edge_tables_match_jax(graphs):
    X, X_ref = graphs
    ours = MPNNModel(device='cpu', **SMALL)._graph_inputs(X[:10])
    ref = JaxMPNNModel(data_parallel=False, **SMALL)._graph_inputs(X_ref[:10])
    assert len(ours) == len(ref) == 11
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert a.dtype == b.dtype, i
        np.testing.assert_array_equal(a, b, err_msg=str(i))
    _, esrc, edst, _, _, emask, e_table, e_deg, o_table, o_deg, _ = ours
    assert e_table.dtype == o_table.dtype == np.int32
    assert e_deg.dtype == o_deg.dtype == np.int8
    # each real edge stands once in its destination's incoming row and
    # once in its source's outgoing row; pad edges point at the ghost node
    real = np.flatnonzero(emask > 0)
    for table, deg, end in ((e_table, e_deg, edst), (o_table, o_deg, esrc)):
        slots = np.arange(table.shape[1])[None, :] < deg[:, None]
        rows = np.repeat(np.arange(len(table)), deg)
        np.testing.assert_array_equal(np.sort(table[slots]), real)
        np.testing.assert_array_equal(end[table[slots]], rows)
    assert (esrc[emask == 0] == len(e_table) - 1).all()


def _edge_graph(rng, n=30, e_real=70, e_cap=96):
    """Directed edges between the first n - 1 nodes (each node at most 10
    in and 10 out), then pad edges at the ghost node n - 1; the edge-id
    tables of both ends."""
    src = np.full(e_cap, n - 1)
    dst = np.full(e_cap, n - 1)
    k = 0
    while k < e_real:
        a, b = rng.randint(0, n - 1, 2)
        if a != b and (src[:k] == a).sum() < 10 and (dst[:k] == b).sum() < 10:
            src[k], dst[k] = a, b
            k += 1
    emask = (np.arange(e_cap) < e_real).astype(np.float32)
    ids = np.arange(e_real)
    e_table, e_m = build_neighbor_table(ids, dst[:e_real], n)
    o_table, o_m = build_neighbor_table(ids, src[:e_real], n)
    return (src.astype(np.int32), dst.astype(np.int32), emask,
            e_table, e_m, o_table, o_m)


def _same_bits(a, b):
    """NaN where NaN; elsewhere equal values with equal sign bits."""
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


def _edge_ops(case):
    """``nei_sum_edges`` and ``take_src`` through JAX and the port on one
    random graph: the outputs and the inputs' gradients, JAX's first."""
    rng = np.random.RandomState(5)
    src, dst, emask, e_table, e_m, o_table, o_m = _edge_graph(rng)
    n, E, F = len(e_table), len(src), 6
    h = rng.randn(E, F).astype(np.float32)          # edge rows
    c = rng.randn(n, F).astype(np.float32)          # node rows
    w_n = rng.randn(n, F).astype(np.float32)
    w_e = rng.randn(E, F).astype(np.float32)
    if case == 'non_finite':
        h[0, :3] = (np.inf, -np.inf, np.nan)        # edge 0: behind the pads
        h[e_table[3, 1], 3] = np.inf                # a real incoming edge
        w_e[0, 0], w_e[5, 1] = np.inf, np.nan       # take_src's cotangent
        w_n[2, 2] = -np.inf                         # nei_sum_edges'
    elif case == 'signed_zeros':
        h, c = _signed_zeros(rng, (E, F)), _signed_zeros(rng, (n, F))
        h[0] = -np.abs(h[0])
        h[:, 0] = -0.0
        w_n, w_e = _signed_zeros(rng, (n, F)), _signed_zeros(rng, (E, F))
        w_e[:, 1] = -0.0

    def jax_sum(x):
        return jax_nei_table.nei_sum_edges(x, e_table, e_m, dst, emask)

    def jax_take(x):
        return jax_nei_table.take_src(x, src, o_table, o_m)
    ref = (jax_sum(h), jax.grad(lambda x: jnp.sum(jax_sum(x) * w_n))(h),
           jax_take(c), jax.grad(lambda x: jnp.sum(jax_take(x) * w_e))(c))
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in dict(
        src=src, dst=dst, emask=emask, e_table=e_table, o_table=o_table,
        e_deg=e_m.sum(1).astype(np.int8),
        o_deg=o_m.sum(1).astype(np.int8)).items()}
    x = torch.from_numpy(h).requires_grad_()
    out = nei_sum_edges(x, t['e_table'], t['e_deg'], t['dst'], t['emask'])
    (out * torch.from_numpy(w_n)).sum().backward()
    y = torch.from_numpy(c).requires_grad_()
    taken = take_src(y, t['src'], t['o_table'], t['o_deg'])
    (taken * torch.from_numpy(w_e)).sum().backward()
    ours = (out.detach(), x.grad, taken.detach(), y.grad)
    return [np.asarray(r) for r in ref], [o.numpy() for o in ours]


def test_edge_ops_match_jax():
    ref, ours = _edge_ops('finite')
    assert ours[0].shape == (30, 6) and ours[3].shape == (30, 6)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, atol=1e-6)


@pytest.mark.parametrize('case', ['non_finite', 'signed_zeros'])
def test_edge_ops_give_jax_bits(case):
    """A non-finite edge row behind the pads makes every node with a pad
    slot NaN there, as the JAX sum's mask does; infinite cotangents flow
    through both backwards; sums of signed zeros keep JAX's signs."""
    ref, ours = _edge_ops(case)
    if case == 'non_finite':
        assert not np.isfinite(ref[0]).all() and not np.isfinite(ref[3]).all()
    else:
        assert any(np.signbit(r[r == 0]).any() for r in ref)
    for a, b in zip(ours, ref):
        _same_bits(a, b)


def test_take_src_skips_the_backward_without_an_input_gradient():
    rng = np.random.RandomState(2)
    src, _, _, _, _, o_table, o_m = _edge_graph(rng)
    w = torch.randn(96, 4, requires_grad=True)
    carry = torch.from_numpy(rng.randn(30, 4).astype(np.float32))
    (take_src(carry, torch.from_numpy(src), torch.from_numpy(o_table),
              torch.from_numpy(o_m.sum(1).astype(np.int8))) * w).sum() \
        .backward()
    assert w.grad is not None


class _FlaxCells(fnn.Module):
    @fnn.compact
    def __call__(self, h, x, c):
        h1, _ = fnn.GRUCell(features=h.shape[-1])(h, x)
        (c1, h2), out = fnn.OptimizedLSTMCell(features=h.shape[-1])((c, h), x)
        return h1, c1, h2, out


class _Cells(torch.nn.Module):
    flax_scopes = {'GRUCell_0': 'gru', 'OptimizedLSTMCell_0': 'lstm'}

    def __init__(self, x_dim, dim):
        super().__init__()
        self.gru = GRUCell(x_dim, dim)
        self.lstm = LSTMCell(x_dim, dim)


def test_gru_and_lstm_cells_match_flax():
    """flax 0.12's parameter tree of the cells, carried into the port's
    cells; one step of each within 1e-6, and the GRU also as torch's
    ``nn.GRUCell`` with ``bias_hh = [0, 0, b_hn]``."""
    rng = np.random.RandomState(3)
    h, x, c = (rng.randn(7, d).astype(np.float32) for d in (8, 5, 8))
    params = _FlaxCells().init(jax.random.PRNGKey(0), h, x, c)
    p = params['params']
    assert {k: sorted(v) for k, v in p['GRUCell_0'].items()} == {
        'ir': ['bias', 'kernel'], 'iz': ['bias', 'kernel'],
        'in': ['bias', 'kernel'], 'hr': ['kernel'], 'hz': ['kernel'],
        'hn': ['bias', 'kernel']}
    assert {k: sorted(v) for k, v in p['OptimizedLSTMCell_0'].items()} == {
        **{g: ['kernel'] for g in ('ii', 'if', 'ig', 'io')},
        **{g: ['bias', 'kernel'] for g in ('hi', 'hf', 'hg', 'ho')}}
    # biases away from their zero init, so that their layout shows
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.1 * jnp.arange(a.size).reshape(a.shape)
        if path[-1].key == 'bias' else a, params)
    ref = _FlaxCells().apply(params, h, x, c)
    cells = _Cells(5, 8)
    params_from_flax(_flatten_params(params), cells)
    th, tx, tc = map(torch.from_numpy, (h, x, c))
    with torch.no_grad():
        h1 = cells.gru(th, tx)
        (c1, h2), out = cells.lstm((tc, th), tx)
        torch_gru = torch.nn.GRUCell(5, 8)
        torch_gru.weight_ih.copy_(cells.gru.weight_ih)
        torch_gru.weight_hh.copy_(cells.gru.weight_hh)
        torch_gru.bias_ih.copy_(cells.gru.bias_ih)
        torch_gru.bias_hh.copy_(torch.cat([torch.zeros(16),
                                           cells.gru.bias_hn]))
        h1_torch = torch_gru(tx, th)
    for a, b in zip((h1, c1, h2, out, h1_torch), ref + (ref[0],)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def _layer_batch(graphs, n=10):
    """The port's packed batch of the first ``n`` molecules."""
    return MPNNModel(device='cpu', **SMALL)._graph_inputs(graphs[0][:n])


def test_edge_network_and_set_gather_match_flax(graphs):
    nf, esrc, edst, gidx, nmask, emask, e_table, e_deg, o_table, o_deg, ef = \
        _layer_batch(graphs)
    e_args = (nf, esrc, edst, ef, emask, e_table, e_deg, o_table, o_deg)
    mp = JaxEdgeNetworkMPNN(16, 2)
    p = mp.init(jax.random.PRNGKey(1), *e_args)
    ref_h = mp.apply(p, *e_args)
    layer = EdgeNetworkMPNN(30, 11, 16, 2)
    params_from_flax(_flatten_params(p), layer)
    t = [torch.from_numpy(a) for a in e_args]
    with torch.no_grad():
        h = layer(t[0], t[1].long(), t[2], *t[3:])
    np.testing.assert_allclose(h.numpy(), ref_h, atol=1e-5)
    sg = JaxSetGather(16, 2)
    q = sg.init(jax.random.PRNGKey(2), ref_h, gidx, nmask, 10)
    ref_g = sg.apply(q, ref_h, gidx, nmask, 10)
    gather = SetGather(16, 2)
    params_from_flax(_flatten_params(q), gather)
    with torch.no_grad():
        g = gather(torch.from_numpy(np.array(ref_h)),
                   torch.from_numpy(gidx), torch.from_numpy(nmask), 10)
    assert g.shape == (10, 32)
    np.testing.assert_allclose(g.numpy(), ref_g, atol=1e-5)


@pytest.fixture(scope='module')
def data(graphs):
    X, X_ref = graphs
    rng = np.random.RandomState(0)
    y = (rng.randn(len(SMILES), N_TASKS) * 3 + 5).astype(np.float32)
    w = np.ones_like(y)
    w[2, 1] = 0.0                                  # one masked label
    return NumpyDataset(X, y, w), JaxNumpyDataset(X_ref, y, w)


def _pair(data, **kwargs):
    """A JAX model and a port model with the same initial parameters."""
    ds, ds_ref = data
    kw = {**SMALL, **kwargs}
    ref = JaxMPNNModel(data_parallel=False, **kw)
    ref.predict(ds_ref)                               # builds the params
    model = MPNNModel(device='cpu', **kw)
    params_from_flax(_flatten_params(ref.params), model.module)
    return ref, model


def _scaled(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        1.0, np.abs(np.asarray(b)).max())


def test_model_outputs_and_gradients_match_flax(data):
    ref, model = _pair(data)
    ds, _ = data
    inputs, labels, weights = next(model.default_generator(ds))
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
    assert out.shape == (10, N_TASKS)
    assert _scaled(out.numpy(), ref_out[0]) <= 1e-5
    loss = model._train_step(t_in, t_lab, t_w)
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
    grads = dict(model.module.named_parameters())
    want = flax_state(_flatten_params(g_ref), model.module)
    assert set(want) == set(grads)
    for name, g in want.items():
        assert _scaled(grads[name].grad.numpy(), g.numpy()) <= 1e-5, name
    # the LSTM's first step starts from h = 0 and leaves h = 0, so at M 2
    # its recurrent weights never meet a non-zero state
    assert [n for n, g in want.items() if not g.abs().max() > 0] == \
        ['set2set.lstm.weight_hh']


def test_fit_follows_the_jax_losses(data):
    """2 epochs of fit from the same weights (3 batches of 10, the last
    short and padded; one loss window an epoch) on both sides."""
    ds, ds_ref = data
    ref, model = _pair(data, learning_rate=0.003)
    ref_losses, losses = [], []
    ref_last = ref.fit(ds_ref, nb_epoch=2, checkpoint_interval=0,
                       all_losses=ref_losses)
    last = model.fit(ds, nb_epoch=2, checkpoint_interval=0,
                     all_losses=losses)
    assert len(losses) == len(ref_losses) == 2
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    np.testing.assert_allclose(last, ref_last, rtol=1e-4)
    assert model.get_global_step() == ref.get_global_step() == 6


def test_normalization_transformer_and_regression_metrics_match_jax(data):
    ds, ds_ref = data
    for kw in ({}, {'move_mean': False}):
        t = NormalizationTransformer(transform_y=True, dataset=ds, **kw)
        t_ref = JaxNormalizationTransformer(transform_y=True,
                                            dataset=ds_ref, **kw)
        np.testing.assert_allclose(t.y_means, t_ref.y_means, atol=1e-12)
        np.testing.assert_allclose(t.y_stds, t_ref.y_stds, atol=1e-12)
        out, out_ref = t.transform(ds), t_ref.transform(ds_ref)
        np.testing.assert_allclose(out.y, out_ref.y, atol=1e-12)
        np.testing.assert_array_equal(out.w, ds.w)
        assert out.X is ds.X
        np.testing.assert_allclose(t.untransform(out.y),
                                   t_ref.untransform(out_ref.y), atol=1e-12)
    np.testing.assert_allclose(t.untransform(out.y), ds.y, rtol=1e-6)
    X_stats = NormalizationTransformer(
        transform_X=True, dataset=NumpyDataset(ds.y * 2, ds.y))
    np.testing.assert_allclose(X_stats.X_means, 2 * t.y_means)
    rng = np.random.RandomState(4)
    y, y_pred, w = rng.randn(50), rng.randn(50), rng.rand(50)
    for ours, theirs in ((pearson_r2_score, jax_scores.pearson_r2_score),
                         (rms_score, jax_scores.rms_score),
                         (mae_score, jax_scores.mae_score)):
        assert abs(ours(y, y_pred) - theirs(y, y_pred)) <= 1e-12
        assert abs(ours(y, y) - theirs(y, y)) <= 1e-12
    assert pearson_r2_score(y, np.ones(50)) == 0.0
    from sklearn.metrics import mean_absolute_error, mean_squared_error
    assert abs(mae_score(y, y_pred, sample_weight=w)
               - mean_absolute_error(y, y_pred, sample_weight=w)) <= 1e-12
    assert abs(rms_score(y, y_pred, sample_weight=w) - np.sqrt(
        mean_squared_error(y, y_pred, sample_weight=w))) <= 1e-12


def test_evaluate_undoes_the_transformer_as_jax(data):
    """From the same weights, on labels normalised by each package's
    transformer: predictions and the three regression scores in the
    labels' own units."""
    ds, ds_ref = data
    ref, model = _pair(data)
    t = NormalizationTransformer(transform_y=True, dataset=ds)
    t_ref = JaxNormalizationTransformer(transform_y=True, dataset=ds_ref)
    ds_t, ds_ref_t = t.transform(ds), t_ref.transform(ds_ref)
    pred = model.predict(ds_t, [t])
    ref_pred = ref.predict(ds_ref_t, [t_ref])
    assert pred.shape == (len(SMILES), N_TASKS)
    assert _scaled(pred, ref_pred) <= 1e-5
    names = ('pearson_r2_score', 'rms_score', 'mae_score')
    scores = model.evaluate(ds_t, [Metric(pearson_r2_score),
                                   Metric(rms_score), Metric(mae_score)],
                            [t])
    ref_scores = ref.evaluate(ds_ref_t, [JaxMetric(getattr(jax_scores, n))
                                         for n in names], [t_ref])
    assert set(scores) == set(names)
    for n in names:
        np.testing.assert_allclose(scores[n], ref_scores[n], atol=1e-6)
    # in the labels' units: the same as scoring the untransformed outputs
    direct = Metric(rms_score).compute_metric(ds.y, pred, ds.w)
    np.testing.assert_allclose(scores['rms_score'], direct, rtol=1e-12)
