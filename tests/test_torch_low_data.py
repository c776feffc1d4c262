"""The port's few-shot slice against the JAX package's, on the CPU:
``data/supports.py`` (episodes and supports from one seed),
``convert.py``'s flax ``nn.LSTMCell`` scopes (numbered and named),
``cosine_dist``, ``AttnLSTMEmbedding``, ``IterRefLSTMEmbedding`` and
``SupportGraphClassifier`` (``siamese``, ``attn``, ``res``).

Same inputs, SMILES written inline and labels from a seed, go through the
JAX function and the port's.  The JAX supports draw from numpy's global
stream, the port's from an explicit ``RandomState``: seeded alike, they
draw the same episodes.  Tolerances: the episodes equal; ``cosine_dist``
within 1e-6; the LSTM embeddings, the module's probabilities, the loss
and every gradient from the same flax weights within 1e-5 of max(1,
|ref|); the losses of episode fits within 1e-4 relative; ``evaluate``'s
scores within 1e-6.  On the CPU the kernel wrappers (P2 in the encoder's
GCN layers and their backward, P3 in its mean readout) run their plain
versions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepchem_tpu.data import NumpyDataset as JaxNumpyDataset
from deepchem_tpu.data import supports as jax_supports
from deepchem_tpu.metrics import roc_auc_score as jax_roc_auc
from deepchem_tpu.models import low_data as jax_low
from deepchem_tpu.models.jax_model import _flatten_params
from deepchem_tpu_torch import (MolGraphConvFeaturizer, NumpyDataset,
                                SupportGraphClassifier, roc_auc_score)
from deepchem_tpu_torch.data import supports
from deepchem_tpu_torch.models import (AttnLSTMEmbedding,
                                       IterRefLSTMEmbedding, cosine_dist,
                                       params_from_flax)
from deepchem_tpu_torch.models.convert import flax_state

torch.set_num_threads(1)

SMILES = ['CCO', 'c1ccccc1O', 'C[C@H](N)C(=O)O', 'CC(=O)Oc1ccccc1C(=O)O',
          'N#Cc1ccncc1', 'c1ccsc1', 'FC(F)(F)c1ccc(Cl)cc1Br', 'CC#N',
          'C1CCCCC1', 'C[N+](C)(C)CC(=O)[O-]', 'OCC(O)CO', 'CCCCCCCC',
          'O=C1NC(=O)C(N1)(c1ccccc1)c1ccccc1', 'CCN(CC)CC', 'c1ccc2ccccc2c1',
          'CC(C)Cc1ccc(cc1)C(C)C(=O)O', 'OC(=O)c1ccccc1O', 'CCOC(=O)C',
          'NC(=O)c1ccccc1', 'Clc1ccccc1Cl']
N_TASKS = 4
SMALL = dict(n_pos=1, n_neg=3, n_test=4, n_feat=8, layer_sizes=(8, 8),
             max_depth=2, learning_rate=0.003)


def _scaled(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        1.0, np.abs(np.asarray(b)).max())


@pytest.fixture(scope='module')
def data():
    """The molecules as MolGraphConv graphs with seeded 0/1 labels for 4
    tasks, a few rows of each task unlabelled (weight 0)."""
    X = MolGraphConvFeaturizer().featurize(SMILES)
    rng = np.random.RandomState(11)
    y = (rng.rand(len(X), N_TASKS) > 0.55).astype(np.float32)
    y[0] = 1.0
    y[1] = 0.0
    w = (rng.rand(len(X), N_TASKS) > 0.15).astype(np.float32)
    w[:2] = 1.0
    return NumpyDataset(X, y, w), JaxNumpyDataset(X, y, w)


def _same_dataset(a, b):
    assert len(a) == len(b)
    for x, z in zip(a.X, b.X):
        assert x is z
    for attr in ('y', 'w', 'ids'):
        np.testing.assert_array_equal(np.asarray(getattr(a, attr)).ravel(),
                                      np.asarray(getattr(b, attr)).ravel())


def test_supports_draw_the_jax_episodes(data):
    """From one seed (the port's RandomState, JAX's global stream): the
    same task order, supports and test batches; the same supports and
    trials; the task datasets and the live rows."""
    ds, ds_ref = data
    for seed in (0, 5):
        np.random.seed(seed)
        ref = list(jax_supports.EpisodeGenerator(ds_ref, 1, 3, 4, 3))
        ours = list(supports.EpisodeGenerator(
            ds, 1, 3, 4, 3, np.random.RandomState(seed)))
        assert len(ours) == len(ref) == 3 * N_TASKS
        for (t, s, b), (tr, sr, br) in zip(ours, ref):
            assert t == tr
            _same_dataset(s, sr)
            _same_dataset(b, br)
        np.random.seed(seed)
        ref = list(jax_supports.SupportGenerator(ds_ref, 2, 5, 6))
        ours = list(supports.SupportGenerator(ds, 2, 5, 6,
                                              np.random.RandomState(seed)))
        for (t, s), (tr, sr) in zip(ours, ref, strict=True):
            assert t == tr
            _same_dataset(s, sr)
        np.random.seed(seed)
        ref = jax_supports.get_task_support(ds_ref, 3, 30, 2, 1)
        ours = supports.get_task_support(ds, 3, 30, 2, 1,
                                         np.random.RandomState(seed))
        for s, sr in zip(ours, ref, strict=True):
            _same_dataset(s, sr)
        np.random.seed(seed)
        ref = jax_supports.get_single_task_test(ds_ref, 50, 2, False)
        ours = supports.get_single_task_test(ds, 50, 2, False,
                                             np.random.RandomState(seed))
        _same_dataset(ours, ref)
    _same_dataset(supports.get_task_dataset(ds, 3),
                  jax_supports.get_task_dataset(ds_ref, 3))
    w = np.asarray(ds.w).copy()
    w[4:7] = 0.0
    dead = NumpyDataset(ds.X, ds.y, w)
    _same_dataset(supports.remove_dead_examples(dead),
                  jax_supports.remove_dead_examples(
                      JaxNumpyDataset(ds.X, ds.y, w)))
    assert len(supports.remove_dead_examples(dead)) == len(SMILES) - 3


def test_cosine_dist_matches_jax():
    rng = np.random.RandomState(1)
    x, y = rng.randn(5, 8).astype(np.float32), rng.randn(7, 8).astype(
        np.float32)
    x[2] = 0.0
    ours = cosine_dist(torch.from_numpy(x), torch.from_numpy(y))
    ref = jax_low.cosine_dist(jnp.asarray(x), jnp.asarray(y))
    assert _scaled(ours.numpy(), ref) <= 1e-6


@pytest.mark.parametrize('cls,ref_cls', [
    (AttnLSTMEmbedding, jax_low.AttnLSTMEmbedding),
    (IterRefLSTMEmbedding, jax_low.IterRefLSTMEmbedding)])
def test_lstm_embeddings_match_flax(cls, ref_cls):
    """flax's ``nn.LSTMCell`` scopes (``LSTMCell_0``; ``support_lstm`` and
    ``test_lstm``), gates ii/if/ig/io without a bias and hi/hf/hg/ho with
    it, carried into the port's cells: both outputs and the gradients of
    both inputs and every weight within 1e-5 of max(1, |ref|)."""
    rng = np.random.RandomState(2)
    x, xp = rng.randn(4, 8).astype(np.float32), rng.randn(6, 8).astype(
        np.float32)
    gx, gxp = rng.randn(4, 8).astype(np.float32), rng.randn(6, 8).astype(
        np.float32)
    flax_mod = ref_cls(8, max_depth=3)
    params = flax_mod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                           jnp.asarray(xp))
    flat = _flatten_params(params)
    assert {k.split('/')[1] for k in flat} == set(cls.flax_scopes)
    assert any(k.endswith('/ii/kernel') for k in flat)
    assert not any(k.endswith('/ii/bias') for k in flat)
    (o, op), vjp = jax.vjp(lambda p, a, b: flax_mod.apply(p, a, b), params,
                           jnp.asarray(x), jnp.asarray(xp))
    g_p, g_x, g_xp = vjp((jnp.asarray(gx), jnp.asarray(gxp)))
    mod = cls(8, max_depth=3)
    params_from_flax(flat, mod)
    tx, txp = (torch.from_numpy(a).requires_grad_(True) for a in (x, xp))
    out, outp = mod(tx, txp)
    ((out * torch.from_numpy(gx)).sum()
     + (outp * torch.from_numpy(gxp)).sum()).backward()
    assert _scaled(out.detach().numpy(), o) <= 1e-5
    assert _scaled(outp.detach().numpy(), op) <= 1e-5
    assert _scaled(tx.grad.numpy(), g_x) <= 1e-5
    assert _scaled(txp.grad.numpy(), g_xp) <= 1e-5
    grads = dict(mod.named_parameters())
    want = flax_state(_flatten_params(g_p), mod)
    assert set(want) == set(grads)
    for key, g in want.items():
        assert _scaled(grads[key].grad.numpy(), g.numpy()) <= 1e-5, key


def _pair(data, kind, seed=3):
    """A JAX classifier and a port one with the same weights, built on the
    same first episode; their caps set from the dataset."""
    ds, ds_ref = data
    ref = jax_low.SupportGraphClassifier(model=kind, **SMALL)
    model = SupportGraphClassifier(model=kind, device='cpu', **SMALL)
    ref._caps = ref._dataset_caps(ds_ref)
    model._caps = model._dataset_caps(ds)
    assert model._caps == ref._caps
    task, support, batch = next(supports.EpisodeGenerator(
        ds, 1, 3, 4, 1, np.random.RandomState(seed)))
    ep = model._pack_episode(support, batch)
    ref._build(_jax_episode(ep))
    model._build(model._to_device(ep))
    params_from_flax(_flatten_params(ref.params), model.module)
    return ref, model, ep


def _jax_episode(ep):
    """The port's packed episode as the JAX package packs it: each batch's
    six arrays, without the CSR."""
    s_in, s_y, q_in, q_y, q_w = ep
    return ([jnp.asarray(a) for a in s_in[:6]], jnp.asarray(s_y),
            [jnp.asarray(a) for a in q_in[:6]], jnp.asarray(q_y),
            jnp.asarray(q_w))


@pytest.mark.parametrize('kind', ['siamese', 'attn', 'res'])
def test_module_and_gradients_match_flax(data, kind):
    """One episode from the same flax weights: the probabilities, the loss
    and every gradient within 1e-5 of max(1, |ref|); the packed episode's
    arrays are the JAX package's; every flax leaf maps onto one
    parameter, each gradient non-zero."""
    ref, model, ep = _pair(data, kind)
    ds, ds_ref = data
    task, support, batch = next(supports.EpisodeGenerator(
        ds, 1, 3, 4, 1, np.random.RandomState(9)))
    ep = model._pack_episode(support, batch)
    ref_ep = ref._pack_episode(support, batch)
    for ours, theirs in ((ep[0][:6], ref_ep[0]), (ep[2][:6], ref_ep[2])):
        for a, b in zip(ours, theirs, strict=True):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(ep[1:2] + ep[3:], ref_ep[1:2] + ref_ep[3:]):
        np.testing.assert_array_equal(a, b)
    j_ep = _jax_episode(ep)

    def loss_fn(p):
        prob = ref.module.apply(p, j_ep[0], j_ep[1], j_ep[2])
        pc = jnp.clip(prob, 1e-6, 1.0 - 1e-6)
        ll = -(j_ep[3] * jnp.log(pc) + (1.0 - j_ep[3]) * jnp.log(1.0 - pc))
        return jnp.sum(ll * j_ep[4]) / jnp.maximum(jnp.sum(j_ep[4]),
                                                    1.0), prob
    (loss_ref, prob_ref), g_ref = jax.value_and_grad(
        loss_fn, has_aux=True)(ref.params)
    t_ep = model._to_device(ep)
    prob = model.module(t_ep[0], t_ep[1], t_ep[2])
    assert prob.shape == (4,)
    assert _scaled(prob.detach().numpy(), prob_ref) <= 1e-5
    loss = model.loss(prob, t_ep[3], t_ep[4])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
    grads = dict(model.module.named_parameters())
    flat = _flatten_params(g_ref)
    want = flax_state(flat, model.module)
    assert set(want) == set(grads)
    for key, g in want.items():
        assert _scaled(grads[key].grad.numpy(), g.numpy()) <= 1e-5, key
        assert grads[key].grad.abs().max() > 0, key


@pytest.mark.parametrize('kind', ['siamese', 'attn', 'res'])
def test_fit_and_evaluate_as_jax(data, kind):
    """Two epochs of 8 episodes from the same weights and one seed, their
    last losses within 1e-4 relative; then predictions on a support
    within 1e-5 and ``evaluate``'s per-task ROC-AUC means and deviations
    within 1e-6."""
    ds, ds_ref = data
    ref, model, _ = _pair(data, kind)
    np.random.seed(4)
    model.rng = np.random.RandomState(4)
    for _ in range(2):
        ref_loss = ref.fit(ds_ref, nb_epochs=1, n_episodes_per_epoch=8,
                           log_every=0)
        loss = model.fit(ds, nb_epochs=1, n_episodes_per_epoch=8,
                         log_every=0)
        assert np.isfinite(loss)
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-4)
    support = supports.get_task_support(ds, 1, 1, 3, 0,
                                        np.random.RandomState(1))[0]
    pred = model.predict_on_support(support, ds)
    ref_pred = ref.predict_on_support(support, ds_ref)
    assert pred.shape == (len(SMILES),)
    assert _scaled(pred, ref_pred) <= 1e-5
    np.random.seed(6)
    model.rng = np.random.RandomState(6)
    means, stds = model.evaluate(ds, roc_auc_score, n_trials=6)
    ref_means, ref_stds = ref.evaluate(ds_ref, jax_roc_auc, n_trials=6)
    assert set(means) == set(ref_means) and means
    for t in means:
        assert abs(means[t] - ref_means[t]) <= 1e-6
        assert abs(stds[t] - ref_stds[t]) <= 1e-6


def test_classifier_needs_a_device_and_a_fit(data):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SupportGraphClassifier()
    with pytest.raises(ValueError):
        SupportGraphClassifier(model='lstm', device='cpu')
    model = SupportGraphClassifier(device='cpu', **SMALL)
    with pytest.raises(ValueError, match='fit'):
        model.predict_on_support(data[0], data[0])
