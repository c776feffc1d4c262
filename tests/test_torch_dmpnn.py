"""The port's DMPNN slice (Chemprop's directed MPNN with its featurizer)
against the JAX package's, on the CPU.

Same inputs, written inline, go through the JAX function and the port's;
on the CPU each kernel wrapper (K1 in ``nei_sum_edges``, P3 in the sum
readout) runs its plain torch version.  Tolerances: the featurizer's
arrays and the packed batch (the incoming-edge-id table, its degrees and
the edge features) are equal (no arithmetic); the model's outputs and
every gradient from the same flax weights within 1e-5 of max(1, |ref|)
(matmuls summed in another order); per-epoch losses of a 2-epoch fit
within 1e-4 relative (those differences carried through a few Adam
steps); and ``evaluate`` within 1e-6 of the JAX model's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepchem_tpu.data import NumpyDataset as JaxNumpyDataset
from deepchem_tpu.feat import DMPNNFeaturizer as JaxDMPNNFeaturizer
from deepchem_tpu.metrics import Metric as JaxMetric
from deepchem_tpu.metrics import score_function as jax_scores
from deepchem_tpu.models.dmpnn import DMPNNModel as JaxDMPNNModel
from deepchem_tpu.models.jax_model import _flatten_params
from deepchem_tpu_torch import (DMPNNFeaturizer, DMPNNModel, Metric,
                                MolGraphConvFeaturizer, NumpyDataset,
                                rms_score)
from deepchem_tpu_torch.models import params_from_flax
from deepchem_tpu_torch.models.convert import flax_state

torch.set_num_threads(1)

# charged atoms, @ and @@, cis/trans marks, single atoms (no bond),
# aromatic rings, halogens, S, P and an isotope
SMILES = ['C/C=C/C', 'F/C=C\\F', 'C[C@H](N)C(=O)O', 'C[C@@H](N)C(=O)O',
          '[NH4+]', 'C[N+](C)(C)CC(=O)[O-]', 'C', '[Na+].[Cl-]', 'CCO',
          'c1ccccc1O', 'CC(=O)Oc1ccccc1C(=O)O', 'FC(F)(F)c1ccc(Cl)cc1Br',
          'N#Cc1ccncc1', 'O=S(=O)(N)c1ccc(N)cc1', 'OP(=O)(O)OP(=O)(O)O',
          'c1ccsc1', 'Clc1ccc2c(c1)C(=NCC(=O)N2)c1ccccc1', 'Ic1ccc[nH]1',
          'O=C(O)/C=C/c1ccccc1', '[13CH4]', 'O']
N_TASKS = 2
SMALL = dict(n_tasks=N_TASKS, batch_size=10, enc_hidden=16, depth=2,
             ffn_hidden=12, ffn_layers=2, log_frequency=3)


@pytest.fixture(scope='module')
def graphs():
    return (DMPNNFeaturizer().featurize(SMILES),
            JaxDMPNNFeaturizer().featurize(SMILES))


def test_featurizer_matches_jax(graphs):
    ours, ref = graphs
    for smi, a, b in zip(SMILES, ours, ref, strict=True):
        assert a.node_features.dtype == a.edge_features.dtype == np.float32
        assert a.node_features.shape == (b.node_features.shape[0], 133)
        assert a.edge_features.shape == (a.num_edges, 14)
        np.testing.assert_array_equal(a.node_features, b.node_features,
                                      err_msg=smi)
        np.testing.assert_array_equal(a.edge_index, b.edge_index,
                                      err_msg=smi)
        np.testing.assert_array_equal(a.edge_features, b.edge_features,
                                      err_msg=smi)
        # each bond as two adjacent directed edges: e ^ 1 reverses e
        e = np.arange(a.num_edges)
        np.testing.assert_array_equal(a.edge_index[:, e ^ 1],
                                      a.edge_index[::-1])
    by = dict(zip(SMILES, ours))
    assert by['C'].edge_features.shape == (0, 14)
    chirality = by['C[C@H](N)C(=O)O'].node_features[1, 114:119]
    assert chirality.tolist() == [0, 1, 0, 0, 0]
    chirality = by['C[C@@H](N)C(=O)O'].node_features[1, 114:119]
    assert chirality.tolist() == [0, 0, 1, 0, 0]


def test_featurizer_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match='morgan'):
        DMPNNFeaturizer(features_generators=['morgan'])
    with pytest.raises(NotImplementedError):
        DMPNNFeaturizer(is_adding_hs=True)


def test_packed_batch_matches_jax(graphs):
    X, X_ref = graphs
    ours = DMPNNModel(device='cpu', **SMALL)._graph_inputs(X[:10])
    ref = JaxDMPNNModel(data_parallel=False, **SMALL)._graph_inputs(X_ref[:10])
    assert len(ours) == len(ref) == 9
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert a.dtype == b.dtype, i
        np.testing.assert_array_equal(a, b, err_msg=str(i))
    _, esrc, edst, _, _, emask, e_table, e_deg, ef = ours
    assert e_table.dtype == np.int32 and e_deg.dtype == np.int8
    # the packer keeps the featurizer's pairs: e ^ 1 reverses every edge
    assert len(esrc) % 2 == 0
    e = np.arange(len(esrc))
    real = emask > 0
    np.testing.assert_array_equal(esrc[e ^ 1][real], edst[real])
    np.testing.assert_array_equal(ef[e ^ 1], ef)


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
    ref = JaxDMPNNModel(data_parallel=False, **kw)
    ref.predict(ds_ref)                               # builds the params
    model = DMPNNModel(device='cpu', **kw)
    params_from_flax(_flatten_params(ref.params), model.module)
    return ref, model


def _scaled(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        1.0, np.abs(np.asarray(b)).max())


@pytest.mark.parametrize('mode,depth', [('regression', 2), ('regression', 3),
                                        ('classification', 2),
                                        ('regression', 1)])
def test_model_outputs_and_gradients_match_flax(data, mode, depth):
    """At depth 1 no round runs, and W_h has no parameters on either
    side."""
    ref, model = _pair(data, mode=mode, depth=depth)
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
    assert ('W_h.weight' in grads) == (depth > 1)
    for key, g in want.items():
        assert _scaled(grads[key].grad.numpy(), g.numpy()) <= 1e-5, key
        assert grads[key].grad.abs().max() > 0, key


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


def test_evaluate_matches_jax(data):
    ds, ds_ref = data
    ref, model = _pair(data)
    pred, ref_pred = model.predict(ds), ref.predict(ds_ref)
    assert pred.shape == (len(SMILES), N_TASKS)
    assert _scaled(pred, ref_pred) <= 1e-5
    score = model.evaluate(ds, [Metric(rms_score)])['rms_score']
    ref_score = ref.evaluate(ds_ref, [JaxMetric(jax_scores.rms_score)])
    np.testing.assert_allclose(score, ref_score['rms_score'], atol=1e-6)


def test_model_refuses_other_feature_widths():
    model = DMPNNModel(device='cpu', **SMALL)
    X = MolGraphConvFeaturizer(use_edges=True).featurize(['CCO'])
    with pytest.raises(ValueError, match='30 atom and 11 bond'):
        model.predict_on_batch(X)


def test_dropout_is_seeded_and_off_outside_training(graphs):
    """With dropout the weights are those of the same seed without it,
    predictions equal (dropout is the identity outside ``train()``), and
    two fits from the same seed give the same losses."""
    X = graphs[0][:10]
    y = np.random.RandomState(5).randn(10, N_TASKS).astype(np.float32)
    plain = DMPNNModel(device='cpu', **SMALL)
    drop = [DMPNNModel(device='cpu', dropout_p=0.5, **SMALL)
            for _ in range(2)]
    np.testing.assert_array_equal(plain.predict_on_batch(X),
                                  drop[0].predict_on_batch(X))
    losses = [m.fit(NumpyDataset(X, y), nb_epoch=2, checkpoint_interval=0)
              for m in drop]
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
