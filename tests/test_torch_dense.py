"""The port's fingerprint models and their featurizer against the JAX
package's, on the CPU.

Same inputs, made with numpy from a seed or written inline, go through the
JAX function and the port's.  Tolerances: Morgan fingerprints (bits,
counts and the unfolded form, with ``CircularFingerprint``'s options), the
atoms' invariants under them and ``IRVTransformer``'s features equal (no
float arithmetic but the Tanimoto ratio, computed alike); each model's
outputs and every gradient from the same flax weights within 1e-5 of
max(1, |ref|) (matmuls summed in another order); ``regularization_loss``
within 1e-6 relative; the per-epoch losses of a 2-epoch fit (dropout 0)
within 1e-4 relative, and the predictions after it within 1e-3.  With
dropout only shapes and the train/eval difference are checked: the two
frameworks draw other masks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepchem_tpu.chem import fingerprints as jax_fp
from deepchem_tpu.chem import mol_from_smiles as jax_mol_from_smiles
from deepchem_tpu.data import NumpyDataset as JaxNumpyDataset
from deepchem_tpu.feat import CircularFingerprint as JaxCircularFingerprint
from deepchem_tpu.models import fcnet as jax_fcnet
from deepchem_tpu.models.irv import \
    MultitaskIRVClassifier as JaxMultitaskIRVClassifier
from deepchem_tpu.models.jax_model import _flatten_params
from deepchem_tpu.models.multitask import \
    SingletaskToMultitask as JaxSingletaskToMultitask
from deepchem_tpu.models.progressive import \
    ProgressiveMultitaskClassifier as JaxProgressiveMultitaskClassifier
from deepchem_tpu.models.progressive import \
    ProgressiveMultitaskRegressor as JaxProgressiveMultitaskRegressor
from deepchem_tpu.models.scscore import ScScoreModel as JaxScScoreModel
from deepchem_tpu.trans import IRVTransformer as JaxIRVTransformer
from deepchem_tpu.trans import \
    NormalizationTransformer as JaxNormalizationTransformer
from deepchem_tpu_torch import NumpyDataset
from deepchem_tpu_torch.chem import (bulk_tanimoto, mol_from_smiles,
                                     morgan_fingerprint,
                                     morgan_fingerprint_counts,
                                     sparse_morgan_fingerprint, tanimoto)
from deepchem_tpu_torch.feat import CircularFingerprint
from deepchem_tpu_torch.models import (MultitaskClassifier,
                                       MultitaskFitTransformRegressor,
                                       MultitaskIRVClassifier,
                                       MultitaskRegressor,
                                       ProgressiveMultitaskClassifier,
                                       ProgressiveMultitaskRegressor,
                                       RobustMultitaskClassifier,
                                       RobustMultitaskRegressor, ScScoreModel,
                                       SingletaskToMultitask,
                                       params_from_flax)
from deepchem_tpu_torch.models.convert import flax_state
from deepchem_tpu_torch.models.fcnet import _weight_decay_regularizer
from deepchem_tpu_torch.trans import IRVTransformer, NormalizationTransformer

torch.set_num_threads(1)

# rings, fused and aromatic rings, charges, @ and @@, cis/trans marks,
# radicals, isotopes, halogens, S and P, single atoms and ions
SMILES = ['CCO', 'c1ccccc1O', 'C[C@H](N)C(=O)O', 'C[C@@H](N)C(=O)O',
          'C/C=C/C', 'F/C=C\\F', '[NH4+]', 'C[N+](C)(C)CC(=O)[O-]',
          '[CH2]C', '[CH]1CC1', '[13CH4]', 'C', '[Na+].[Cl-]',
          'CC(=O)Oc1ccccc1C(=O)O', 'FC(F)(F)c1ccc(Cl)cc1Br', 'N#Cc1ccncc1',
          'O=S(=O)(N)c1ccc(N)cc1', 'OP(=O)(O)OP(=O)(O)O', 'c1ccsc1',
          'Clc1ccc2c(c1)C(=NCC(=O)N2)c1ccccc1', 'C1CC2CCC1C2',
          'c1ccc2ccccc2c1', 'Ic1ccc[nH]1']
N_TASKS, N_BITS = 3, 64
OPTIONS = [dict(), dict(size=N_BITS), dict(radius=3, size=512),
           dict(chiral=True), dict(features=True), dict(bonds=False),
           dict(is_counts_based=True), dict(size=N_BITS,
                                            is_counts_based=True)]


@pytest.mark.parametrize('kw', OPTIONS)
def test_circular_fingerprint_matches_jax(kw):
    ours = CircularFingerprint(**kw).featurize(SMILES)
    ref = JaxCircularFingerprint(**kw).featurize(SMILES)
    assert ours.dtype == ref.dtype == np.float64
    assert ours.shape == (len(SMILES), kw.get('size', 2048))
    np.testing.assert_array_equal(ours, ref)


def test_fingerprint_functions_match_jax():
    """The atoms' invariants, ``morgan_fingerprint_counts``, the folded
    bits (the JAX package may take its native kernel for them), the
    unfolded forms, and the Tanimoto functions."""
    fps = []
    for smi in SMILES:
        m, r = mol_from_smiles(smi), jax_mol_from_smiles(smi)
        for a, b in zip(m.atoms, r.atoms, strict=True):
            assert (a.total_hs, a.in_ring, a.mass, a.chirality,
                    a.num_radical_electrons, a.degree) == \
                (b.total_hs, b.in_ring, b.mass, b.chirality,
                 b.num_radical_electrons, b.degree), smi
        for kw in (dict(), dict(use_chirality=True), dict(radius=1)):
            assert morgan_fingerprint_counts(m, **kw) == \
                jax_fp.morgan_fingerprint_counts(r, **kw), smi
        bits = morgan_fingerprint(m, n_bits=N_BITS)
        assert bits.dtype == np.uint8
        np.testing.assert_array_equal(
            bits, jax_fp.morgan_fingerprint(r, n_bits=N_BITS))
        assert sparse_morgan_fingerprint(m) == \
            jax_fp.sparse_morgan_fingerprint(r)
        fps.append(bits)
    fps = np.stack(fps)
    assert tanimoto(fps[1], fps[9]) == jax_fp.tanimoto(fps[1], fps[9])
    assert tanimoto(fps[12] * 0, fps[12] * 0) == 0.0
    np.testing.assert_array_equal(bulk_tanimoto(fps[1], fps),
                                  jax_fp.bulk_tanimoto(fps[1], fps))
    sparse = CircularFingerprint(sparse=True, smiles=True).featurize(
        SMILES[:3])
    ref = JaxCircularFingerprint(sparse=True, smiles=True).featurize(
        SMILES[:3])
    assert list(sparse) == list(ref)


def _labels(rng, n, kind):
    if kind == 'classification':
        y = (rng.rand(n, N_TASKS) > 0.5).astype(np.float32)
    else:
        y = (rng.randn(n, N_TASKS) * 2 + 1).astype(np.float32)
    w = np.ones((n, N_TASKS), np.float32)
    w[3, 1] = 0.0                                  # one masked label
    return y, w


_DATA = {}


def _data(kind):
    """The port's and the JAX dataset for a model's input ``kind``."""
    if kind in _DATA:
        return _DATA[kind]
    X = CircularFingerprint(size=N_BITS).featurize(SMILES).astype(np.float32)
    rng = np.random.RandomState(0)
    n = len(SMILES)
    if kind == 'scscore':
        X = np.stack([X, np.roll(X, 1, axis=0)], axis=1)
        y, w = np.zeros((n, 1), np.float32), np.ones((n, 1), np.float32)
    else:
        y, w = _labels(rng, n, 'regression' if kind == 'regression'
                       else 'classification')
    ours, ref = NumpyDataset(X, y, w), JaxNumpyDataset(X, y, w)
    if kind == 'irv':
        ours = IRVTransformer(5, N_TASKS, ours).transform(ours)
        ref = JaxIRVTransformer(5, N_TASKS, ref).transform(ref)
    _DATA[kind] = (ours, ref)
    return _DATA[kind]


def test_irv_transformer_matches_jax():
    ours, ref = _data('irv')
    assert ours.X.shape == (len(SMILES), N_TASKS * 10)
    np.testing.assert_array_equal(ours.X, ref.X)
    # the sample itself is never its own neighbour
    assert (ours.X[:, :5] < 1).any()


def _fit_transformers(kind):
    ds, ds_ref = _data(kind)
    return dict(fit_transformers=[NormalizationTransformer(
        transform_X=True, dataset=ds)]), dict(fit_transformers=[
            JaxNormalizationTransformer(transform_X=True, dataset=ds_ref)])


FP = dict(n_tasks=N_TASKS, n_features=N_BITS)
# name: (port class, JAX class, data kind, arguments of both)
MODELS = {
    'classifier': (MultitaskClassifier, jax_fcnet.MultitaskClassifier,
                   'classification',
                   dict(FP, layer_sizes=[32, 16], dropouts=0.0,
                        weight_decay_penalty=0.1)),
    'classifier_residual': (MultitaskClassifier,
                            jax_fcnet.MultitaskClassifier, 'classification',
                            dict(FP, layer_sizes=[32, 32, 16], dropouts=0.0,
                                 residual=True, activation_fns='tanh',
                                 weight_decay_penalty=0.01,
                                 weight_decay_penalty_type='l1')),
    'regressor': (MultitaskRegressor, jax_fcnet.MultitaskRegressor,
                  'regression', dict(FP, layer_sizes=[32, 32], dropouts=0.0,
                                     bias_init_consts=[0.5, 1.0])),
    'fit_transform': (MultitaskFitTransformRegressor,
                      jax_fcnet.MultitaskFitTransformRegressor,
                      'regression', dict(FP, layer_sizes=[16], dropouts=0.0)),
    'robust_classifier': (RobustMultitaskClassifier,
                          jax_fcnet.RobustMultitaskClassifier,
                          'classification',
                          dict(FP, layer_sizes=[32], bypass_layer_sizes=[8],
                               dropouts=0.0, bypass_dropouts=0.0)),
    'robust_regressor': (RobustMultitaskRegressor,
                         jax_fcnet.RobustMultitaskRegressor, 'regression',
                         dict(FP, layer_sizes=[32, 16],
                              bypass_layer_sizes=[8, 4], dropouts=0.0,
                              bypass_dropouts=0.0)),
    'progressive_classifier': (ProgressiveMultitaskClassifier,
                               JaxProgressiveMultitaskClassifier,
                               'classification',
                               dict(FP, layer_sizes=[16, 8, 8],
                                    dropouts=0.0)),
    'progressive_regressor': (ProgressiveMultitaskRegressor,
                              JaxProgressiveMultitaskRegressor, 'regression',
                              dict(FP, layer_sizes=[16, 8], dropouts=0.0,
                                   alpha_init_stddevs=[0.5])),
    'irv': (MultitaskIRVClassifier, JaxMultitaskIRVClassifier, 'irv',
            dict(n_tasks=N_TASKS, K=5)),
    'scscore': (ScScoreModel, JaxScScoreModel, 'scscore',
                dict(n_features=N_BITS, layer_sizes=[16, 16])),
}


def _pair(name, **kwargs):
    """A JAX model and a port model with the same initial parameters."""
    model, ref_model, kind, kw = MODELS[name]
    ds, ds_ref = _data(kind)
    kw = dict(kw, batch_size=8, log_frequency=3, **kwargs)
    ours_kw, ref_kw = dict(kw), dict(kw)
    if name == 'fit_transform':
        extra, ref_extra = _fit_transformers(kind)
        ours_kw.update(extra)
        ref_kw.update(ref_extra)
    ref = ref_model(**ref_kw)
    ref.predict(ds_ref)                               # builds the params
    ours = model(device='cpu', **ours_kw)
    params_from_flax(_flatten_params(ref.params), ours.module)
    return ref, ours


def _scaled(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        1.0, np.abs(np.asarray(b)).max())


@pytest.mark.parametrize('name', sorted(MODELS))
def test_dense_model_matches_jax(name):
    """The first batch from the same flax weights: every output, the loss
    with its ``regularization_loss`` and every gradient within 1e-5 of
    max(1, |ref|); the parameter trees are the same."""
    _, _, kind, _ = MODELS[name]
    ds, ds_ref = _data(kind)
    ref, ours = _pair(name)
    batch = next(ours.default_generator(ds))
    j_in, j_lab, j_w = next(ref.default_generator(ds_ref))
    j_in = [jnp.asarray(a) for a in j_in]
    ref_out = jax.jit(lambda p: ref._forward(p, j_in, training=False,
                                             rng=None))(ref.params)

    def loss_fn(p):
        outputs = ref._forward(p, j_in, training=True,
                               rng=jax.random.PRNGKey(0))
        loss = ref._compute_loss(outputs, [jnp.asarray(a) for a in j_lab],
                                 [jnp.asarray(a) for a in j_w])
        if ref.regularization_loss is not None:
            loss = loss + ref.regularization_loss(p)
        return loss
    loss_ref, g_ref = jax.jit(jax.value_and_grad(loss_fn))(ref.params)
    t_in, t_lab, t_w = ours._prepare_batch(batch)
    ours.module.eval()
    with torch.no_grad():
        out = ours.module(*t_in)
    out = list(out) if isinstance(out, (list, tuple)) else [out]
    assert len(out) == len(ref_out)
    for a, b in zip(out, ref_out):
        assert a.shape == b.shape
        assert _scaled(a.numpy(), b) <= 1e-5
    loss = ours._train_step(t_in, t_lab, t_w)
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
    grads = dict(ours.module.named_parameters())
    want = flax_state(_flatten_params(g_ref), ours.module)
    assert set(want) == set(grads)
    for key, g in want.items():
        assert _scaled(grads[key].grad.numpy(), g.numpy()) <= 1e-5, key


@pytest.mark.parametrize('name', sorted(MODELS))
def test_dense_fit_follows_the_jax_losses(name):
    """2 epochs of fit from the same weights (3 batches of 8, the last
    padded; one loss window an epoch), ``regularization_loss`` in every
    step, then the predictions."""
    _, _, kind, _ = MODELS[name]
    ds, ds_ref = _data(kind)
    ref, ours = _pair(name, learning_rate=0.003)
    ref_losses, losses = [], []
    ref.fit(ds_ref, nb_epoch=2, checkpoint_interval=0,
            all_losses=ref_losses)
    ours.fit(ds, nb_epoch=2, checkpoint_interval=0, all_losses=losses)
    assert len(losses) == len(ref_losses) == 2
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    # within 1e-3: Adam scales a gradient of rounding noise (ScScore's
    # pairs of shared bits cancel to about 1e-9) up to a step of the rate
    pred, ref_pred = ours.predict(ds), ref.predict(ds_ref)
    for a, b in zip(pred if isinstance(pred, list) else [pred],
                    ref_pred if isinstance(ref_pred, list) else [ref_pred]):
        assert _scaled(a, b) <= 1e-3


@pytest.mark.parametrize('kind', ['l1', 'l2'])
def test_regularization_loss_matches_jax(kind):
    """The trunk-kernel penalty, biases and the head left out."""
    ref, ours = _pair('classifier_residual')
    want = jax_fcnet._weight_decay_regularizer(0.3, kind)(ref.params)
    got = _weight_decay_regularizer(0.3, kind)(ours.module)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    with pytest.raises(ValueError):
        _weight_decay_regularizer(0.3, 'l3')


def test_uncertainty_regressor_matches_jax():
    """With ``uncertainty`` (dropout on): the eval outputs (values,
    variance, log variance) from the same weights within 1e-5, and
    ``predict_uncertainty``'s shapes."""
    kw = dict(FP, layer_sizes=[16], dropouts=0.25, uncertainty=True,
              batch_size=8)
    ds, ds_ref = _data('regression')
    ref = jax_fcnet.MultitaskRegressor(**kw)
    ref.predict(ds_ref)
    ours = MultitaskRegressor(device='cpu', **kw)
    params_from_flax(_flatten_params(ref.params), ours.module)
    x = ds.X[:8].astype(np.float32)
    ref_out = ref._forward(ref.params, [jnp.asarray(x)], training=False,
                           rng=None)
    ours.module.eval()
    with torch.no_grad():
        out = ours.module(torch.from_numpy(x))
    for a, b in zip(out, ref_out):
        assert _scaled(a.numpy(), b) <= 1e-5
    mean, std = ours.predict_uncertainty(ds, masks=3)
    assert mean.shape == std.shape == (len(SMILES), N_TASKS)
    assert (std > 0).all()
    with pytest.raises(ValueError):
        MultitaskRegressor(device='cpu', **dict(kw, dropouts=0.0))


def test_dropout_is_seeded_and_only_in_training():
    """Dropout 0.5 draws the weights of the seed without it, leaves
    predictions alone, changes the training outputs, and two fits from one
    seed give the same losses."""
    kw = dict(FP, layer_sizes=[32], batch_size=8, device='cpu')
    ds, _ = _data('classification')
    plain = MultitaskClassifier(dropouts=0.0, **kw)
    drop = [MultitaskClassifier(dropouts=0.5, **kw) for _ in range(2)]
    np.testing.assert_array_equal(plain.predict(ds), drop[0].predict(ds))
    losses = [m.fit(ds, nb_epoch=2, checkpoint_interval=0) for m in drop]
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
    x = torch.from_numpy(ds.X[:8].astype(np.float32))
    drop[0].module.train()
    train_out = drop[0].module(x)[1].detach()
    drop[0].module.eval()
    assert train_out.shape == (8, N_TASKS, 2)
    assert not torch.equal(train_out, drop[0].module(x)[1].detach())


def test_use_kfac_raises():
    with pytest.raises(NotImplementedError, match='KFAC'):
        MultitaskClassifier(device='cpu', use_kfac=True, **FP)
    with pytest.raises(NotImplementedError, match='KFAC'):
        MultitaskRegressor(device='cpu', use_kfac=True, **FP)


def test_scscore_scores_single_molecules():
    ref, ours = _pair('scscore')
    fps = _data('classification')[0].X[:5].astype(np.float32)
    np.testing.assert_allclose(ours.predict_mols(fps),
                               ref.predict_mols(fps), atol=1e-5)
    assert ((ours.predict_mols(fps) >= 1) & (ours.predict_mols(fps) <= 5)
            ).all()


def test_singletask_to_multitask_matches_jax():
    """One :class:`MultitaskRegressor` a task from the same weights, each
    fitted on the samples whose weight for its task is not 0: the
    predictions within 1e-4."""
    ds, ds_ref = _data('regression')
    kw = dict(n_tasks=1, n_features=N_BITS, layer_sizes=[8], dropouts=0.0,
              batch_size=8, learning_rate=0.003)
    ref = JaxSingletaskToMultitask(
        list(range(N_TASKS)), lambda t: jax_fcnet.MultitaskRegressor(**kw))
    for m in ref.models:
        m.predict(ds_ref)
    ours = SingletaskToMultitask(
        list(range(N_TASKS)),
        lambda t: MultitaskRegressor(device='cpu', **kw))
    for m, r in zip(ours.models, ref.models):
        params_from_flax(_flatten_params(r.params), m.module)
    ref.fit(ds_ref, nb_epoch=2, checkpoint_interval=0)
    ours.fit(ds, nb_epoch=2, checkpoint_interval=0)
    pred = ours.predict(ds)
    assert pred.shape == (len(SMILES), N_TASKS)
    assert _scaled(pred, ref.predict(ds_ref)) <= 1e-4
    assert ours.models[1].get_global_step() == 6       # 22 samples, 3 steps
