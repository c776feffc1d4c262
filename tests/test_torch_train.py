"""PAGTN training in the port against the JAX package's, on the CPU.

Small model (2 layers, hidden 8, 32 output node features, batch 4,
dropout 0) on 12 molecules with seeded 0/1 labels.  Parameters come from
the flax model through ``params_from_flax``, so both sides start from the
same weights.  Tolerances: losses atol 1e-6 and Adam atol 1e-7 (the same
f32 formula), gradients atol 1e-5 (f32 sums in another order, as in
tests/test_torch_pagtn.py), loss trajectories rtol 1e-4 (those
differences, carried through a few Adam steps).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deepchem_tpu.data import NumpyDataset as JaxNumpyDataset
from deepchem_tpu.feat import PagtnMolGraphFeaturizer as JaxPagtnFeaturizer
from deepchem_tpu.models import PagtnModel as JaxPagtnModel
from deepchem_tpu.models.jax_model import _flatten_params
from deepchem_tpu.models.losses import L2Loss as JaxL2Loss
from deepchem_tpu.models.losses import \
    SoftmaxCrossEntropy as JaxSoftmaxCrossEntropy
from deepchem_tpu_torch import (NumpyDataset, PagtnModel,
                                PagtnMolGraphFeaturizer)
from deepchem_tpu_torch.metrics import to_one_hot
from deepchem_tpu_torch.models import (Adam, L2Loss, SoftmaxCrossEntropy,
                                       params_from_flax)
from deepchem_tpu_torch.models.convert import _torch_name

torch.set_num_threads(1)

SMILES = ['CCO', 'c1ccccc1O', 'CC(=O)Oc1ccccc1C(=O)O',
          'CN1C=NC2=C1C(=O)N(C(=O)N2C)C', 'C[N+](C)(C)CC(=O)[O-]',
          'FC(F)(F)c1ccc(Cl)cc1Br', 'N#Cc1ccncc1', 'O=S(=O)(N)c1ccc(N)cc1',
          'CCN(CC)CCOC(=O)c1ccc(N)cc1', 'Clc1ccc2c(c1)C(=NCC(=O)N2)c1ccccc1',
          'CC(C)Cc1ccc(cc1)C(C)C(=O)O', 'OC(=O)CNCP(=O)(O)O']
N_TASKS = 3
SMALL = dict(n_tasks=N_TASKS, mode='classification', batch_size=4,
             num_layers=2, hidden_features=8, output_node_features=32,
             dropout=0.0, log_frequency=1)


@pytest.fixture(scope='module')
def data():
    labels = np.random.RandomState(0).randint(0, 2, (len(SMILES), N_TASKS))
    weights = np.ones_like(labels, dtype=np.float32)
    weights[1, 2] = 0.0                      # one masked label
    X = PagtnMolGraphFeaturizer().featurize(SMILES)
    X_ref = JaxPagtnFeaturizer().featurize(SMILES)
    return (NumpyDataset(X, labels.astype(np.float32), weights),
            JaxNumpyDataset(X_ref, labels.astype(np.float32), weights))


def _pair(data, tmp_path=None, learning_rate=0.001):
    """A JAX model and a port model with the same initial parameters."""
    ds, ds_ref = data
    ref = JaxPagtnModel(data_parallel=False, seed=3,
                        learning_rate=learning_rate, **SMALL)
    ref.predict(ds_ref)                               # builds the params
    model = PagtnModel(device='cpu', learning_rate=learning_rate,
                       model_dir=None if tmp_path is None else str(tmp_path),
                       **SMALL)
    params_from_flax(_flatten_params(ref.params), model.module)
    return ref, model


def test_losses_match_jax():
    rng = np.random.RandomState(1)
    logits = rng.randn(5, 3, 2).astype(np.float32) * 3
    onehot = np.stack([to_one_hot(rng.randint(0, 2, 5)) for _ in range(3)],
                      axis=1).astype(np.float32)
    np.testing.assert_allclose(
        SoftmaxCrossEntropy()(*map(torch.from_numpy, (logits, onehot)))
        .numpy(),
        np.asarray(JaxSoftmaxCrossEntropy()(logits, onehot)), atol=1e-6)
    out = rng.randn(5, 3, 1).astype(np.float32)
    lab = rng.randn(5, 3).astype(np.float32)
    for a, b in ((out, lab), (lab, out), (lab, lab[::-1].copy())):
        ours = L2Loss()(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        ref = np.asarray(JaxL2Loss()(a, b))
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_adam_matches_optax():
    """At the models' default rate, 1e-3, on parameters at the scale of
    the model's weights (|p| < 0.5).  optax takes the bias correction
    1 - 0.999**t in f32, where 0.999 is inexact (1.3e-5 relative), and
    torch in double, so their updates differ by ~6e-6 relative: below
    1e-8 a step at this rate."""
    rng = np.random.RandomState(2)
    p0 = {'w': rng.uniform(-.4, .4, (5, 3)).astype(np.float32),
          'b': rng.uniform(-.4, .4, 4).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in
              p0.items()} for _ in range(3)]
    tx = optax.adam(0.001)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(params)
    ours = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
            for k, v in p0.items()}
    opt = Adam()._create_torch_optimizer(ours.values())
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in
                                    g.items()}, state, params)
        params = optax.apply_updates(params, updates)
        for k, p in ours.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k, p in ours.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(params[k]), atol=1e-7)


def test_one_step_gradients_match_jax(data):
    ref, model = _pair(data)
    ds, _ = data
    batch = next(model.default_generator(ds))
    inputs, labels, weights = batch
    # labels come one-hot from the generator, ghost graphs weighted 0

    def loss_fn(p):
        outputs = ref._forward(p, [jnp.asarray(a) for a in inputs],
                               training=True, rng=jax.random.PRNGKey(0))
        return ref._compute_loss(outputs, [jnp.asarray(labels[0])],
                                 [jnp.asarray(weights[0])])
    loss_ref, g_ref = jax.value_and_grad(loss_fn)(ref.params)
    loss = model.fit(NumpyDataset(ds.X[:4], ds.y[:4], ds.w[:4]),
                     nb_epoch=1, checkpoint_interval=0)
    np.testing.assert_allclose(loss, float(loss_ref), rtol=1e-6)
    grads = dict(model.module.named_parameters())
    flat = _flatten_params(g_ref)
    assert len(flat) == len(grads)
    for key, g in flat.items():
        g = np.asarray(g)
        ours = grads[_torch_name(key)].grad.numpy()
        np.testing.assert_allclose(ours, g.T if key.endswith('/kernel')
                                   else g, atol=1e-5, err_msg=key)
        # attn's bias shifts every logit of a segment alike, which leaves
        # the softmax as it is: its exact gradient is 0
        if not key.endswith('attn/bias'):
            assert np.abs(ours).max() > 0, key


@pytest.mark.parametrize('deterministic', [True, False])
def test_fit_follows_the_jax_loss_trajectory(data, deterministic):
    """3 epochs of 3 batches (the last one short and padded): per-step
    losses, the returned loss and the global step agree."""
    ds, ds_ref = data
    ref, model = _pair(data)
    ref_losses, losses = [], []
    ref_last = ref.fit(ds_ref, nb_epoch=3, checkpoint_interval=0,
                       deterministic=deterministic, all_losses=ref_losses)
    last = model.fit(ds, nb_epoch=3, checkpoint_interval=0,
                     deterministic=deterministic, all_losses=losses)
    assert len(losses) == len(ref_losses) == 9
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    np.testing.assert_allclose(last, ref_last, rtol=1e-4)
    assert model.all_losses == losses
    assert model.get_global_step() == ref.get_global_step() == 9
    assert losses[-1] < losses[0]


def test_checkpoint_round_trip(data, tmp_path):
    ds, _ = data
    _, model = _pair(data, tmp_path)
    model.fit(ds, nb_epoch=2, checkpoint_interval=2,
              max_checkpoints_to_keep=2)
    ckpts = model.get_checkpoints()
    assert [p.rsplit('/', 1)[1] for p in ckpts] == ['checkpoint1.pt',
                                                    'checkpoint2.pt']
    assert torch.load(ckpts[0])['global_step'] == 6
    assert torch.load(ckpts[1])['global_step'] == 4
    other = PagtnModel(device='cpu', model_dir=str(tmp_path), seed=9,
                       **SMALL)
    other.restore()
    assert other.get_global_step() == 6
    np.testing.assert_array_equal(other.predict(ds), model.predict(ds))
    # optimizer state came back too: the next steps agree
    a, b = [], []
    model.fit(ds, nb_epoch=1, checkpoint_interval=0, all_losses=a)
    other.fit(ds, nb_epoch=1, checkpoint_interval=0, all_losses=b)
    np.testing.assert_array_equal(a, b)


def test_fit_and_predict_switch_the_module_mode(data):
    ds, _ = data
    model = PagtnModel(device='cpu', **{**SMALL, 'dropout': 0.5})
    seen = []
    model.fit(ds, nb_epoch=1, checkpoint_interval=0,
              callbacks=lambda m, step: seen.append(m.module.training))
    assert seen == [True] * 3
    a = model.predict(ds)
    assert not model.module.training
    np.testing.assert_array_equal(a, model.predict(ds))   # no dropout
    # seeded dropout: the same seed gives the same trajectory
    runs = []
    for _ in range(2):
        m = PagtnModel(device='cpu', seed=4, **{**SMALL, 'dropout': 0.5})
        runs.append([])
        m.fit(ds, nb_epoch=1, checkpoint_interval=0, all_losses=runs[-1])
    assert runs[0] == runs[1]


def test_fit_generator_and_loss_windows(data):
    """fit_generator over the generator's batches in dataset order takes
    the steps fit(deterministic=True) takes; log_frequency windows hold
    the means of the per-step losses, the last one partial."""
    ds, _ = data
    per_step, windows, gen = [], [], []
    PagtnModel(device='cpu', **SMALL).fit(
        ds, nb_epoch=3, checkpoint_interval=0, deterministic=True,
        all_losses=per_step)
    m = PagtnModel(device='cpu', **{**SMALL, 'log_frequency': 4})
    last = m.fit(ds, nb_epoch=3, checkpoint_interval=0, deterministic=True,
                 all_losses=windows)
    np.testing.assert_allclose(windows, [np.mean(per_step[:4]),
                                         np.mean(per_step[4:8]),
                                         per_step[8]], rtol=1e-6)
    assert last == windows[-1]
    g = PagtnModel(device='cpu', **SMALL)
    g.fit_generator(g.default_generator(ds, epochs=3), checkpoint_interval=0,
                    all_losses=gen)
    np.testing.assert_array_equal(gen, per_step)
    assert g.get_global_step() == 9
