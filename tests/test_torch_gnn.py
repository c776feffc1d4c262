"""The port's GCN, GAT and AttentiveFP slice, and K4 (``nei_gather``),
against the JAX package's, on the CPU.

Same inputs, made with numpy from a seed or written inline, go through
the JAX function and the port's; on the CPU each kernel wrapper (K1 in
GCN's ``nei_sum`` and in ``nei_gather``'s backward, K4's forward, P3 in
the readouts) runs its plain torch version.  Tolerances: the reverse-slot
table and the packed batch are equal (no arithmetic); ``nei_gather``
forward and gradient within 1e-6, and bit for bit, NaN where NaN and
signs of zeros equal, on rows that are not finite or are signed zeros and
on pad slots; the layers' outputs within 1e-5 and their gradients within
1e-5 of max(1, |ref|) (matmuls summed in another order); each model's
outputs and every gradient from the same flax weights within
1e-5 of max(1, |ref|); per-epoch losses of a 2-epoch fit within 1e-4
relative (those differences carried through a few Adam steps); and
``evaluate`` within 1e-6 of the JAX model's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepchem_tpu.data import NumpyDataset as JaxNumpyDataset
from deepchem_tpu.feat import \
    MolGraphConvFeaturizer as JaxMolGraphConvFeaturizer
from deepchem_tpu.metrics import Metric as JaxMetric
from deepchem_tpu.metrics import score_function as jax_scores
from deepchem_tpu.models import AttentiveFPModel as JaxAttentiveFPModel
from deepchem_tpu.models import GATModel as JaxGATModel
from deepchem_tpu.models import GCNModel as JaxGCNModel
from deepchem_tpu.models.graph_layers import \
    AttentiveFPLayer as JaxAttentiveFPLayer
from deepchem_tpu.models.graph_layers import GATLayer as JaxGATLayer
from deepchem_tpu.models.graph_layers import GCNLayer as JaxGCNLayer
from deepchem_tpu.models.jax_model import _flatten_params
from deepchem_tpu.ops import nei_table as jax_nei_table
from deepchem_tpu_torch import (AttentiveFPModel, GATModel, GCNModel, Metric,
                                MolGraphConvFeaturizer, NumpyDataset,
                                rms_score)
from deepchem_tpu_torch.models import (AttentiveFPLayer, GATLayer, GCNLayer,
                                       params_from_flax)
from deepchem_tpu_torch.models.convert import flax_state
from deepchem_tpu_torch.ops import (build_neighbor_table, build_rev_slot,
                                    nei_gather)

torch.set_num_threads(1)

# charged atoms, @ and @@, cis/trans marks, single atoms, aromatic rings,
# halogens, S and P
SMILES = ['C/C=C/C', 'F/C=C\\F', 'C[C@H](N)C(=O)O', 'C[C@@H](N)C(=O)O',
          '[NH4+]', 'C[N+](C)(C)CC(=O)[O-]', 'C', '[Na+].[Cl-]', 'CCO',
          'c1ccccc1O', 'CC(=O)Oc1ccccc1C(=O)O', 'FC(F)(F)c1ccc(Cl)cc1Br',
          'N#Cc1ccncc1', 'O=S(=O)(N)c1ccc(N)cc1', 'OP(=O)(O)OP(=O)(O)O',
          'c1ccsc1', 'Clc1ccc2c(c1)C(=NCC(=O)N2)c1ccccc1', 'Ic1ccc[nH]1',
          'CCCCOC(=O)c1ccccc1C(=O)OCCCC', 'CC#N', 'O']
N_TASKS = 2
BASE = dict(n_tasks=N_TASKS, batch_size=10, log_frequency=3)
# each model at a small size: widths 8 to 16, 2 layers, 2 heads
MODELS = {
    'gcn': (GCNModel, JaxGCNModel,
            dict(graph_conv_layers=(16, 12), predictor_hidden_feats=16)),
    'gat': (GATModel, JaxGATModel,
            dict(graph_attention_layers=(8, 6), n_attention_heads=2,
                 predictor_hidden_feats=16)),
    'attentivefp': (AttentiveFPModel, JaxAttentiveFPModel,
                    dict(num_layers=2, graph_feat_size=12)),
}


def _random_graph(rng, n=40):
    """A random undirected graph of ``n`` nodes with degrees 0 to 10: node
    0 has ten neighbours, the last 3 none.  Its table, mask and degrees."""
    deg = np.zeros(n, int)
    src, dst = [], []
    pairs = [(0, j) for j in range(1, 11)] + [
        tuple(sorted(rng.randint(0, n - 3, 2))) for _ in range(3 * n)]
    for a, b in dict.fromkeys(pairs):
        if a != b and deg[a] < 10 and deg[b] < 10:
            src += [a, b]
            dst += [b, a]
            deg[a] += 1
            deg[b] += 1
    table, mask = build_neighbor_table(np.array(src), np.array(dst), n)
    return table, mask, mask.sum(1).astype(np.int8)


def test_build_rev_slot_matches_jax():
    table, mask, deg = _random_graph(np.random.RandomState(0))
    assert deg.max() == 10 and deg.min() == 0
    rs = build_rev_slot(table, mask)
    np.testing.assert_array_equal(rs, jax_nei_table.build_rev_slot(table,
                                                                   mask))
    assert rs.dtype == np.int8 and rs.shape == table.shape
    # a real slot's neighbour names this node in its reverse slot; pads 0
    real = mask > 0
    rows = np.repeat(np.arange(len(table)), deg)
    np.testing.assert_array_equal(table[table[real], rs[real]], rows)
    assert (rs[~real] == 0).all()


@pytest.fixture(scope='module')
def graphs():
    return (MolGraphConvFeaturizer().featurize(SMILES),
            JaxMolGraphConvFeaturizer().featurize(SMILES))


@pytest.mark.parametrize('name', sorted(MODELS))
def test_packed_batch_matches_jax(graphs, name):
    X, X_ref = graphs
    model, ref, kw = MODELS[name]
    ours = model(device='cpu', **BASE, **kw)._graph_inputs(X[:10])
    theirs = ref(data_parallel=False, **BASE, **kw)._graph_inputs(X_ref[:10])
    assert len(ours) == len(theirs) == (8 if name == 'gcn' else 9)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a.dtype == b.dtype, i
        np.testing.assert_array_equal(a, b, err_msg=str(i))
    if name != 'gcn':
        table, deg, rev_slot = ours[6:]
        assert rev_slot.dtype == np.int8
        mask = (np.arange(table.shape[1])[None, :] < deg[:, None])
        np.testing.assert_array_equal(
            rev_slot, build_rev_slot(table, mask.astype(np.float32)))


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


def _gather(case, trailing):
    """``nei_gather`` through JAX and the port on one random graph, ``x``
    ``[N, *trailing]``: the outputs and the gradients of ``sum(out * w)``,
    JAX's first."""
    rng = np.random.RandomState(7)
    table, mask, deg = _random_graph(rng)
    rs = build_rev_slot(table, mask)
    n, k = table.shape
    x = rng.randn(n, *trailing).astype(np.float32)
    w = rng.randn(n, k, *trailing).astype(np.float32)
    flat_x, flat_w = x.reshape(n, -1), w.reshape(n, k, -1)
    if case == 'non_finite':
        flat_x[0, 0] = np.inf                  # row 0: behind every pad slot
        flat_x[0, -1] = np.nan
        flat_x[table[5, 1], -1] = -np.inf      # a real neighbour
        flat_w[0, 0, 0] = np.inf               # the pad slots' cotangent
        flat_w[table[0, 2], rs[0, 2], -1] = np.nan   # a real slot's
    elif case == 'signed_zeros':
        x = _signed_zeros(rng, x.shape)
        x[0] = -np.abs(x[0])
        w = _signed_zeros(rng, w.shape)
        w.reshape(n, k, -1)[0, 0] = -0.0

    def jax_fn(v):
        return jax_nei_table.nei_gather(v, table, rs, mask)
    ref = (jax_fn(x), jax.grad(lambda v: jnp.sum(jax_fn(v) * w))(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = nei_gather(xt, torch.from_numpy(table), torch.from_numpy(rs),
                     torch.from_numpy(deg))
    (out * torch.from_numpy(w)).sum().backward()
    return [np.asarray(r) for r in ref], [out.detach().numpy(),
                                          xt.grad.numpy()]


TRAILING = [(1,), (8,), (2, 4), (5,)]


@pytest.mark.parametrize('trailing', TRAILING)
def test_nei_gather_matches_jax(trailing):
    ref, ours = _gather('finite', trailing)
    assert ours[0].shape == (40, 10) + trailing
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, atol=1e-6)


@pytest.mark.parametrize('trailing', TRAILING)
@pytest.mark.parametrize('case', ['non_finite', 'signed_zeros'])
def test_nei_gather_gives_jax_bits(case, trailing):
    """A non-finite row 0 makes every pad slot NaN there, as the JAX mask
    does, and a non-finite cotangent at the pad slots' row makes every
    node with a pad slot NaN in the gradient; pad slots of finite rows
    give the sign of the row's zero; the gradient's sums of signed zeros
    keep JAX's signs."""
    ref, ours = _gather(case, trailing)
    if case == 'non_finite':
        assert not np.isfinite(ref[0]).all() and not np.isfinite(ref[1]).all()
    else:
        assert any(np.signbit(r[r == 0]).any() for r in ref)
    for a, b in zip(ours, ref):
        _same_bits(a, b)


def test_nei_gather_needs_a_square_table_and_skips_an_unneeded_backward():
    table, mask, deg = (torch.from_numpy(a) for a in _random_graph(
        np.random.RandomState(1)))
    rs = torch.from_numpy(build_rev_slot(table.numpy(), mask.numpy()))
    with pytest.raises(ValueError):
        nei_gather(torch.randn(41, 3), table, rs, deg)
    w = torch.randn(40, 10, 3, requires_grad=True)
    (nei_gather(torch.randn(40, 3), table, rs, deg) * w).sum().backward()
    assert w.grad is not None


def _layer_batch(graphs, name):
    """The port's packed batch of the first 10 molecules."""
    model, _, kw = MODELS[name]
    return model(device='cpu', **BASE, **kw)._graph_inputs(graphs[0][:10])


@pytest.mark.parametrize('name', sorted(MODELS))
def test_layers_match_flax(graphs, name):
    """One layer on the packed batch from the same flax weights: outputs
    within 1e-5, and the gradients of ``sum(out * w)`` in the input and
    every weight within 1e-5 of max(1, |ref|)."""
    batch = _layer_batch(graphs, name)
    nf, esrc, edst, _, _, emask, table, deg = batch[:8]
    rev_slot = batch[8] if name != 'gcn' else None
    mask = (np.arange(10)[None, :] < deg[:, None]).astype(np.float32)
    jax_layer, layer = {
        'gcn': (JaxGCNLayer(12, activation=jax.nn.relu), GCNLayer(30, 12)),
        'gat': (JaxGATLayer(6, n_heads=2), GATLayer(30, 6, n_heads=2)),
        'attentivefp': (JaxAttentiveFPLayer(12), AttentiveFPLayer(30, 12)),
    }[name]
    h = np.random.RandomState(3).randn(*nf.shape).astype(np.float32)
    args = (esrc.astype(np.int32), edst.astype(np.int32), emask,
            deg.astype(np.int32), table, mask, rev_slot)
    p = jax_layer.init(jax.random.PRNGKey(1), h, *args)
    ref = jax_layer.apply(p, h, *args)
    w = np.random.RandomState(4).randn(*ref.shape).astype(np.float32)
    g_p, g_h = jax.grad(lambda q, v: jnp.sum(jax_layer.apply(q, v, *args)
                                             * w), argnums=(0, 1))(p, h)
    params_from_flax(_flatten_params(p), layer)
    x = torch.from_numpy(h).requires_grad_()
    t = [torch.from_numpy(table), torch.from_numpy(deg)]
    if rev_slot is not None:
        t.append(torch.from_numpy(rev_slot))
    out = layer(x, *t)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5)
    assert _scaled(x.grad.numpy(), g_h) <= 1e-5
    want = flax_state(_flatten_params(g_p), layer)
    grads = dict(layer.named_parameters())
    assert set(want) == set(grads)
    for key, g in want.items():
        assert _scaled(grads[key].grad.numpy(), g.numpy()) <= 1e-5, key


@pytest.fixture(scope='module')
def data(graphs):
    X, X_ref = graphs
    rng = np.random.RandomState(0)
    y = (rng.randn(len(SMILES), N_TASKS) * 3 + 5).astype(np.float32)
    w = np.ones_like(y)
    w[2, 1] = 0.0                                  # one masked label
    return NumpyDataset(X, y, w), JaxNumpyDataset(X_ref, y, w)


def _pair(data, name, **kwargs):
    """A JAX model and a port model with the same initial parameters."""
    ds, ds_ref = data
    model, ref_model, kw = MODELS[name]
    kw = {**BASE, **kw, **kwargs}
    ref = ref_model(data_parallel=False, **kw)
    ref.predict(ds_ref)                               # builds the params
    ours = model(device='cpu', **kw)
    params_from_flax(_flatten_params(ref.params), ours.module)
    return ref, ours


def _scaled(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        1.0, np.abs(np.asarray(b)).max())


@pytest.mark.parametrize('mode', ['regression', 'classification'])
@pytest.mark.parametrize('name', sorted(MODELS))
def test_model_outputs_and_gradients_match_flax(data, name, mode):
    ref, model = _pair(data, name, mode=mode)
    ds, _ = data
    if mode == 'classification':
        ds = NumpyDataset(ds.X, (ds.y > 5).astype(np.float32), ds.w)
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
    out = out[0] if mode == 'classification' else out
    assert out.shape == ((10, N_TASKS, 2) if mode == 'classification'
                         else (10, N_TASKS))
    assert _scaled(out.numpy(), ref_out[0]) <= 1e-5
    loss = model._train_step(t_in, t_lab, t_w)
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
    grads = dict(model.module.named_parameters())
    want = flax_state(_flatten_params(g_ref), model.module)
    assert set(want) == set(grads)
    for key, g in want.items():
        assert _scaled(grads[key].grad.numpy(), g.numpy()) <= 1e-5, key
        assert grads[key].grad.abs().max() > 0, key


@pytest.mark.parametrize('name', sorted(MODELS))
def test_fit_follows_the_jax_losses(data, name):
    """2 epochs of fit from the same weights (3 batches of 10, the last
    short and padded; one loss window an epoch) on both sides."""
    ds, ds_ref = data
    ref, model = _pair(data, name, learning_rate=0.003)
    ref_losses, losses = [], []
    ref_last = ref.fit(ds_ref, nb_epoch=2, checkpoint_interval=0,
                       all_losses=ref_losses)
    last = model.fit(ds, nb_epoch=2, checkpoint_interval=0,
                     all_losses=losses)
    assert len(losses) == len(ref_losses) == 2
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    np.testing.assert_allclose(last, ref_last, rtol=1e-4)
    assert model.get_global_step() == ref.get_global_step() == 6


@pytest.mark.parametrize('name', sorted(MODELS))
def test_evaluate_matches_jax(data, name):
    ds, ds_ref = data
    ref, model = _pair(data, name)
    pred, ref_pred = model.predict(ds), ref.predict(ds_ref)
    assert pred.shape == (len(SMILES), N_TASKS)
    assert _scaled(pred, ref_pred) <= 1e-5
    score = model.evaluate(ds, [Metric(rms_score)])['rms_score']
    ref_score = ref.evaluate(ds_ref, [JaxMetric(jax_scores.rms_score)])
    np.testing.assert_allclose(score, ref_score['rms_score'], atol=1e-6)


@pytest.mark.parametrize('name', sorted(MODELS))
def test_models_refuse_another_atom_width(name):
    model, _, kw = MODELS[name]
    m = model(device='cpu', **BASE, **kw)
    X = MolGraphConvFeaturizer(use_chirality=True).featurize(['CCO'])
    with pytest.raises(ValueError, match='32 atom'):
        m.predict_on_batch(X)


@pytest.mark.parametrize('name', sorted(MODELS))
def test_dropout_is_seeded_and_off_outside_training(graphs, name):
    """With dropout the weights are those of the same seed without it,
    predictions equal (dropout is the identity outside ``train()``), and
    two fits from the same seed give the same losses."""
    model, _, kw = MODELS[name]
    X = graphs[0][:10]
    y = np.random.RandomState(5).randn(10, N_TASKS).astype(np.float32)
    plain = model(device='cpu', **BASE, **kw)
    drop = [model(device='cpu', dropout=0.5, **BASE, **kw) for _ in range(2)]
    np.testing.assert_array_equal(plain.predict_on_batch(X),
                                  drop[0].predict_on_batch(X))
    losses = [m.fit(NumpyDataset(X, y), nb_epoch=2, checkpoint_interval=0)
              for m in drop]
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
