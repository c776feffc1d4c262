"""The port's COO pretraining models (GNNModular's five tasks, InfoGraph,
InfoGraph*) and PNA against the JAX package's, on the CPU.

Same inputs, made with numpy from a seed or written inline, go through
the JAX model and the port's, from the same flax weights; on the CPU each
kernel wrapper (P2 in the GCN layers' neighbour sums and PNA's edge sums,
K3 in PNA's max and min, P3 in the readouts) runs its plain torch
version.  Tolerances: the packed batches equal (``mask_nodes``' masked
features too); the losses and PNA's extra aggregators within 1e-6 of
max(1, |ref|); each model's outputs and every gradient within 1e-5 of
max(1, |ref|) (matmuls summed in another order); per-epoch losses of a
2-epoch fit within 1e-4 relative (those differences carried through a
few Adam steps); ``evaluate`` within 1e-6 of the JAX model's.
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
from deepchem_tpu.models import GNNModular as JaxGNNModular
from deepchem_tpu.models import InfoGraphModel as JaxInfoGraphModel
from deepchem_tpu.models import InfoGraphStarModel as JaxInfoGraphStarModel
from deepchem_tpu.models import PNAModel as JaxPNAModel
from deepchem_tpu.models import losses as jax_losses
from deepchem_tpu.models import pna as jax_pna
from deepchem_tpu.models.jax_model import _flatten_params
from deepchem_tpu_torch import (GNNModular, InfoGraphModel,
                                InfoGraphStarModel, Metric,
                                MolGraphConvFeaturizer, NumpyDataset,
                                PNAModel, rms_score)
from deepchem_tpu_torch.models import losses, params_from_flax, pna
from deepchem_tpu_torch.models.convert import flax_state
from deepchem_tpu_torch.ops import CooCsr

torch.set_num_threads(1)

SMILES = ['C/C=C/C', 'F/C=C\\F', 'C[C@H](N)C(=O)O', '[NH4+]',
          'C[N+](C)(C)CC(=O)[O-]', 'C', '[Na+].[Cl-]', 'CCO', 'c1ccccc1O',
          'CC(=O)Oc1ccccc1C(=O)O', 'FC(F)(F)c1ccc(Cl)cc1Br', 'N#Cc1ccncc1',
          'O=S(=O)(N)c1ccc(N)cc1', 'OP(=O)(O)OP(=O)(O)O', 'c1ccsc1',
          'Clc1ccc2c(c1)C(=NCC(=O)N2)c1ccccc1', 'Ic1ccc[nH]1', 'CC#N', 'O']
N_TASKS = 2
# each model at a small size: width 16, 2 layers, batches of 8
MODELS = {
    **{f'gnn_{task}': (GNNModular, JaxGNNModular,
                       dict(task=task, emb_dim=16, num_layers=2,
                            n_tasks=N_TASKS))
       for task in ('edge_pred', 'mask_nodes', 'infomax', 'regression',
                    'classification')},
    'infograph': (InfoGraphModel, JaxInfoGraphModel,
                  dict(embedding_dim=16, num_gc_layers=2)),
    'infograph_star': (InfoGraphStarModel, JaxInfoGraphStarModel,
                       dict(embedding_dim=16, num_gc_layers=2,
                            n_tasks=N_TASKS)),
    'pna': (PNAModel, JaxPNAModel,
            dict(n_tasks=N_TASKS, hidden_dim=16, num_layers=2)),
}
BATCH = 8


def _scaled(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        1.0, np.abs(np.asarray(b)).max())


@pytest.fixture(scope='module')
def data():
    X = MolGraphConvFeaturizer().featurize(SMILES)
    X_ref = JaxMolGraphConvFeaturizer().featurize(SMILES)
    rng = np.random.RandomState(0)
    y = (rng.randn(len(SMILES), N_TASKS) * 3 + 5).astype(np.float32)
    w = np.ones_like(y)
    w[2, 1] = 0.0                                  # one masked label
    return NumpyDataset(X, y, w), JaxNumpyDataset(X_ref, y, w)


def _classes(ds, cls):
    return cls(ds.X, (ds.y > 5).astype(np.float32), ds.w)


def _pair(data, name, **kwargs):
    """A JAX model and a port model with the same initial parameters."""
    ds, ds_ref = data
    model, ref_model, kw = MODELS[name]
    kw = {**kw, **kwargs}
    ref = ref_model(batch_size=BATCH, log_frequency=3, **kw)
    ref.build(ref._prepare_batch(next(ref.default_generator(
        ds_ref, mode='predict')))[0])
    ours = model(device='cpu', batch_size=BATCH, log_frequency=3, **kw)
    params_from_flax(_flatten_params(ref.params), ours.module)
    return ref, ours


def _datasets(data, name):
    ds, ds_ref = data
    if name == 'gnn_classification':
        return _classes(ds, NumpyDataset), _classes(ds_ref, JaxNumpyDataset)
    return ds, ds_ref


@pytest.mark.parametrize('name', sorted(MODELS))
def test_model_outputs_and_gradients_match_flax(data, name):
    """Every output (scores, decoded features, embeddings, predictions)
    and the loss within 1e-5 of max(1, |ref|) from the same flax weights,
    and the gradient of every parameter, each non-zero."""
    ref, model = _pair(data, name)
    ds, _ = _datasets(data, name)
    inputs, labels, weights = next(model.default_generator(ds))
    j_in = [jnp.asarray(a) for a in inputs[:6]]
    ref_out = jax.jit(lambda p: ref._forward(p, j_in, training=False,
                                             rng=None))(ref.params)
    j_lab = [jnp.asarray(labels[0])]
    j_w = [jnp.asarray(weights[0])]

    def loss_fn(p):
        return ref._compute_loss(ref._forward(p, j_in, training=True,
                                              rng=jax.random.PRNGKey(0)),
                                 j_lab, j_w)
    loss_ref, g_ref = jax.jit(jax.value_and_grad(loss_fn))(ref.params)
    t_in, t_lab, t_w = model._prepare_batch((inputs, labels, weights))
    model.module.eval()
    with torch.no_grad():
        out = model.module(*t_in)
    out = list(out) if isinstance(out, (list, tuple)) else [out]
    assert len(out) == len(ref_out)
    for i, (a, b) in enumerate(zip(out, ref_out)):
        assert tuple(a.shape) == tuple(b.shape), i
        assert _scaled(a.numpy(), b) <= 1e-5, i
    loss = model._train_step(t_in, t_lab, t_w)
    assert _scaled(loss.item(), float(loss_ref)) <= 1e-5
    grads = dict(model.module.named_parameters())
    want = flax_state(_flatten_params(g_ref), model.module)
    assert set(want) == set(grads)
    for key, g in want.items():
        assert _scaled(grads[key].grad.numpy(), g.numpy()) <= 1e-5, key
        assert grads[key].grad.abs().max() > 0, key


def test_mask_nodes_batches_match_jax(data):
    """``mask_nodes`` zeroes the same 15 % of the nodes as the JAX
    generator, draw for draw, over two epochs of batches."""
    ds, ds_ref = data
    ours = GNNModular(device='cpu', task='mask_nodes', batch_size=BATCH)
    theirs = JaxGNNModular(task='mask_nodes', batch_size=BATCH)
    a = list(ours.default_generator(ds, epochs=2))
    b = list(theirs.default_generator(ds_ref, epochs=2))
    assert len(a) == len(b) == 6
    for (ia, la, wa), (ib, lb, wb) in zip(a, b):
        for x, y in zip(ia[:6] + la + wa, ib + lb + wb):
            np.testing.assert_array_equal(x, y)
    assert (a[0][0][0] != a[0][1][0]).any()      # some nodes were zeroed


@pytest.mark.parametrize('name', sorted(MODELS))
def test_fit_follows_the_jax_losses(data, name):
    """2 epochs of fit from the same weights (3 batches of 8, the last
    short and padded; one loss window an epoch) on both sides."""
    ref, model = _pair(data, name, learning_rate=0.003)
    ds, ds_ref = _datasets(data, name)
    ref_losses, losses_ = [], []
    ref.fit(ds_ref, nb_epoch=2, checkpoint_interval=0, all_losses=ref_losses)
    model.fit(ds, nb_epoch=2, checkpoint_interval=0, all_losses=losses_)
    assert len(losses_) == len(ref_losses) == 2
    np.testing.assert_allclose(losses_, ref_losses, rtol=1e-4)
    assert model.get_global_step() == ref.get_global_step() == 6


def test_pretrain_transfer_and_freeze_match_jax(data, tmp_path):
    """As tests/test_pretrain_models.py: pretrain on ``edge_pred``, save the
    components, build a classifier, load the encoder component into it,
    freeze it and fine-tune; the same on the JAX side from the same
    weights.  The port's encoder stays bit for bit the pretrained one (its
    gradients are zero at every step), the head moves, and the losses and
    parameters follow JAX's.  The JAX side fine-tunes through
    ``fit_generator``: its ``fit`` runs a scan that skips
    ``_transform_gradients``, so there the frozen encoder trains."""
    ds, ds_ref = data
    ref_pre, pre = _pair(data, 'gnn_edge_pred',
                         learning_rate=0.003)
    ref_pre.fit(ds_ref, nb_epoch=2, checkpoint_interval=0)
    pre.fit(ds, nb_epoch=2, checkpoint_interval=0)
    ref_pre.save_components(str(tmp_path / 'jax'))
    pre.save_components(str(tmp_path / 'torch'))
    ref_ft, ft = _pair(data, 'gnn_classification', learning_rate=0.01)
    before = {k: v.clone() for k, v in ft.module.state_dict().items()}
    ref_ft.load_components(str(tmp_path / 'jax'), components=['encoder'])
    ft.load_components(str(tmp_path / 'torch'), components=['encoder'])
    saved = pre.module.state_dict()
    for k, v in ft.module.state_dict().items():
        if k.startswith('encoder_'):
            torch.testing.assert_close(v, saved[k], rtol=0, atol=0)
        else:
            torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    ref_ft.freeze_components(['encoder'])
    ft.freeze_components(['encoder'])
    encoder = {k: v.clone() for k, v in ft.module.state_dict().items()
               if k.startswith('encoder_')}
    seen = []

    def encoder_grads(model, step):
        seen.append(max(float(p.grad.abs().max()) for n, p in
                        model.module.named_parameters()
                        if n.startswith('encoder_')))
    cds, cds_ref = _datasets(data, 'gnn_classification')
    ref_losses, losses_ = [], []
    ref_ft.fit_generator(ref_ft.default_generator(cds_ref, epochs=2),
                         checkpoint_interval=0, all_losses=ref_losses)
    ft.fit(cds, nb_epoch=2, deterministic=True, checkpoint_interval=0,
           all_losses=losses_, callbacks=encoder_grads)
    assert seen == [0.0] * 6
    state = ft.module.state_dict()
    for k, v in encoder.items():
        torch.testing.assert_close(state[k], v, rtol=0, atol=0)
    assert (state['head.weight'] - before['head.weight']).abs().max() > 1e-3
    np.testing.assert_allclose(losses_, ref_losses, rtol=1e-4)
    want = flax_state(_flatten_params(ref_ft.params), ft.module)
    for k, v in want.items():
        assert _scaled(state[k].numpy(), v.numpy()) <= 1e-5, k
    ft.unfreeze_components(['encoder'])
    assert ft._frozen == set()
    assert set(ft.components) == {'encoder', 'head'}
    assert sorted(ft.components['encoder']) == ['encoder_gcn0',
                                                'encoder_gcn1']
    assert ft.loss_func(*ft._prepare_batch(next(
        ft.default_generator(cds)))).item() > 0


@pytest.mark.parametrize('name', ['pna', 'gnn_regression', 'infograph_star'])
def test_evaluate_matches_jax(data, name):
    ds, ds_ref = data
    ref, model = _pair(data, name)
    pred, ref_pred = model.predict(ds), ref.predict(ds_ref)
    assert pred.shape == (len(SMILES), N_TASKS)
    assert _scaled(pred, ref_pred) <= 1e-5
    score = model.evaluate(ds, [Metric(rms_score)])['rms_score']
    ref_score = ref.evaluate(ds_ref, [JaxMetric(jax_scores.rms_score)])
    np.testing.assert_allclose(score, ref_score['rms_score'], atol=1e-6)


def test_infograph_embeddings_match_jax(data):
    ds, ds_ref = data
    ref, model = _pair(data, 'infograph')
    emb, ref_emb = model.predict_embeddings(ds), ref.predict_embeddings(
        ds_ref)
    assert emb.shape == np.asarray(ref_emb).shape == (len(SMILES), 16)
    assert _scaled(emb, ref_emb) <= 1e-5


def test_ssl_losses_match_jax():
    rng = np.random.RandomState(2)
    g, loc = rng.randn(4, 6), rng.randn(11, 6)
    gidx = np.array([0, 0, 1, 1, 1, 2, 3, 3, 4, 4, 4])   # 4: the ghost
    nmask = (gidx < 4).astype(np.float32)
    pos, neg = rng.randn(9) * 3, rng.randn(9) * 3
    logits, labels = rng.randn(7, 5), rng.randint(0, 5, 7)
    t = [torch.from_numpy(a.astype(np.float32)) for a in (g, loc)]
    j = [jnp.asarray(a, jnp.float32) for a in (g, loc)]
    for cls, jcls in ((losses.GlobalMutualInformationLoss,
                       jax_losses.GlobalMutualInformationLoss),
                      (losses.LocalMutualInformationLoss,
                       jax_losses.LocalMutualInformationLoss)):
        for mask in (None, nmask):
            ours = cls()(*t, torch.from_numpy(gidx),
                         None if mask is None else torch.from_numpy(mask))
            theirs = jcls()(*j, jnp.asarray(gidx), None if mask is None
                            else jnp.asarray(mask))
            assert _scaled(ours.item(), float(theirs)) <= 1e-6
    pairs = [torch.from_numpy(a.astype(np.float32)) for a in (pos, neg)]
    jpairs = [jnp.asarray(a, jnp.float32) for a in (pos, neg)]
    for cls, jcls in ((losses.EdgePredictionLoss,
                       jax_losses.EdgePredictionLoss),
                      (losses.DeepGraphInfomaxLoss,
                       jax_losses.DeepGraphInfomaxLoss)):
        assert _scaled(cls()(*pairs).item(), float(jcls()(*jpairs))) <= 1e-6
    for cls, jcls in ((losses.GraphNodeMaskingLoss,
                       jax_losses.GraphNodeMaskingLoss),
                      (losses.GraphEdgeMaskingLoss,
                       jax_losses.GraphEdgeMaskingLoss)):
        ours = cls()(torch.from_numpy(logits.astype(np.float32)),
                     torch.from_numpy(labels))
        theirs = jcls()(jnp.asarray(logits, jnp.float32),
                        jnp.asarray(labels))
        assert _scaled(ours.item(), float(theirs)) <= 1e-6


def _third_moment(msgs, edst, emask, n):
    """Each node's masked third central moment of ``msgs``, float64, for
    every feature, the smallest over the features."""
    m = emask.astype(np.float64)[:, None]
    x = msgs.astype(np.float64)
    c = np.maximum(np.bincount(edst, emask, n), 1.0)[:, None]
    mean = np.zeros((n, x.shape[1]))
    np.add.at(mean, edst, x * m)
    mean /= c
    third = np.zeros_like(mean)
    np.add.at(third, edst, ((x - mean[edst]) * m) ** 3)
    return np.abs(third / c).min(axis=1)


def test_pna_aggregators_and_scalers_match_jax(data):
    """Every aggregator of :data:`AGGREGATORS` (the JAX keys) and the extra
    ones (sum, var, the third moment), and every scaler, on one packed
    batch's edges with messages that tie and a masked ghost tail.  The
    third moment's gradient is compared on the edges of nodes whose
    moment is at least 1e-3 from 0: a node with two edges has a moment of
    exactly 0, where ``sign(m) |m + 1e-10|^(1/3)`` turns rounding noise
    into gradients of +-1e6, on either side."""
    ds, _ = data
    model = PNAModel(device='cpu', batch_size=BATCH)
    batch = model._graph_inputs(ds.X[:BATCH])
    _, esrc, edst, _, _, emask = batch[:6]
    N, E = len(batch[0]), len(esrc)
    csr = CooCsr(*(torch.from_numpy(a) for a in batch[6:]))
    msgs = np.random.RandomState(5).randn(E, 4).astype(np.float32)
    msgs[2] = msgs[3]
    assert sorted(pna.AGGREGATORS) == sorted(jax_pna.AGGREGATORS)
    assert sorted(pna.SCALERS) == sorted(jax_pna.SCALERS)
    fns = {**{k: (pna.AGGREGATORS[k], jax_pna.AGGREGATORS[k])
              for k in pna.AGGREGATORS},
           'sum': (pna.aggregate_sum, jax_pna.aggregate_sum),
           'var': (pna.aggregate_var, jax_pna.aggregate_var),
           'moment': (pna.aggregate_moment, jax_pna.aggregate_moment)}
    t = [torch.from_numpy(a) for a in (edst, emask)]
    for name, (ours, theirs) in fns.items():
        x = torch.from_numpy(msgs).requires_grad_()
        out = ours(x, t[0].long(), N, t[1], csr)
        ref, vjp = jax.vjp(lambda m: theirs(m, jnp.asarray(edst), N,
                                            jnp.asarray(emask)),
                           jnp.asarray(msgs))
        g = np.random.RandomState(6).randn(*ref.shape).astype(np.float32)
        out.backward(torch.from_numpy(g))
        assert _scaled(out.detach().numpy(), ref) <= 1e-6, name
        rows = slice(None)
        if name == 'moment':
            rows = np.abs(_third_moment(msgs, edst, emask, N))[edst] > 1e-3
            assert 0 < rows.sum() < E
        assert _scaled(x.grad.numpy()[rows],
                       np.asarray(vjp(jnp.asarray(g))[0])[rows]) <= 1e-5, name
    deg = np.random.RandomState(7).randint(0, 5, N).astype(np.float32)
    h = np.random.RandomState(8).randn(N, 3).astype(np.float32)
    for k in pna.SCALERS:
        np.testing.assert_allclose(
            pna.SCALERS[k](torch.from_numpy(h), torch.from_numpy(deg),
                           2.0).numpy(),
            jax_pna.SCALERS[k](jnp.asarray(h), jnp.asarray(deg), 2.0),
            rtol=1e-6)


def test_models_refuse_bad_arguments():
    with pytest.raises(ValueError, match='task'):
        GNNModular(device='cpu', task='context_pred')
    with pytest.raises(ValueError, match='unknown'):
        PNAModel(device='cpu', aggregators=('mean', 'median'))
    m = PNAModel(device='cpu', batch_size=4)
    X = MolGraphConvFeaturizer(use_chirality=True).featurize(['CCO'])
    with pytest.raises(ValueError, match='32 atom'):
        m.predict_on_batch(X)
