"""The port's training engine against the JAX package's, on the CPU.

Same inputs, made with numpy from a seed, and the same flax parameters go
through the JAX package and the port.  Tolerances: schedules within 1e-7
of optax's rates (the port computes them in float64, optax in float32);
optimizers within 1e-6 of optax's parameters after 20 updates (float32
moments summed in another order); losses and their gradients within 1e-6;
short GraphConv fits within 1e-4 relative per epoch (float32 differences
carried through a few Adam steps) and uncertainty outputs and loss within
1e-5 of max(1, |ref|) (matmuls in another order); transformers within
1e-12 where they compute and exactly where they copy; score functions
within 1e-12 of scikit-learn's (the JAX package re-exports them).
On the CPU each kernel wrapper runs its plain torch version.
"""

import io
import re

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax
import sklearn.metrics as sk

import deepchem_tpu.metrics as jax_metrics
import deepchem_tpu.trans as jax_trans
from deepchem_tpu.data import NumpyDataset as JaxNumpyDataset
from deepchem_tpu.feat import ConvMolFeaturizer as JaxConvMolFeaturizer
from deepchem_tpu.models import GraphConvModel as JaxGraphConvModel
from deepchem_tpu.models import losses as jax_losses
from deepchem_tpu.models import optimizers as jax_optimizers
from deepchem_tpu.models.callbacks import \
    ValidationCallback as JaxValidationCallback
from deepchem_tpu.models.jax_model import JaxModel, _flatten_params
from deepchem_tpu.utils.evaluate import Evaluator as JaxEvaluator
import deepchem_tpu_torch.metrics as metrics
import deepchem_tpu_torch.trans as trans
from deepchem_tpu_torch import ConvMolFeaturizer, GraphConvModel, NumpyDataset
from deepchem_tpu_torch.models import losses, optimizers, params_from_flax
from deepchem_tpu_torch.models.callbacks import ValidationCallback
from deepchem_tpu_torch.models.convert import flax_state
from deepchem_tpu_torch.models.torch_model import TorchModel
from deepchem_tpu_torch.utils.evaluate import Evaluator

torch.set_num_threads(1)

SMILES = ['CCO', 'c1ccccc1O', 'CC(=O)Oc1ccccc1C(=O)O',
          'CN1C=NC2=C1C(=O)N(C(=O)N2C)C', 'C[N+](C)(C)CC(=O)[O-]',
          'FC(F)(F)c1ccc(Cl)cc1Br', 'N#Cc1ccncc1', 'O=S(=O)(N)c1ccc(N)cc1',
          'CCN(CC)CCOC(=O)c1ccc(N)cc1', 'Clc1ccc2c(c1)C(=NCC(=O)N2)c1ccccc1',
          'CC(C)Cc1ccc(cc1)C(C)C(=O)O', 'OC(=O)CNCP(=O)(O)O']
N_TASKS = 3
SMALL = dict(n_tasks=N_TASKS, batch_size=4, graph_conv_layers=[8, 8],
             dense_layer_size=16, log_frequency=3)


# -- schedules and optimizers ------------------------------------------------

SCHEDULES = [
    ('ExponentialDecay', (0.002, 0.9, 10), {}),
    ('ExponentialDecay', (0.002, 0.9, 7), {'staircase': False}),
    ('PolynomialDecay', (0.01, 0.001, 25), {'power': 2.0}),
    ('LinearCosineDecay', (0.01, 30), {'alpha': 0.1}),
    ('PiecewiseConstantSchedule', (0.01, {10: 0.5, 20: 0.1, 35: 2.0}), {}),
    ('LambdaLRWithWarmup', (0.01, 10, 40), {}),
    ('LambdaLRWithWarmup', (0.01, 10), {})]


@pytest.mark.parametrize('name,args,kwargs', SCHEDULES)
def test_schedule_rates_match_optax(name, args, kwargs):
    """Counts 0-60 cross every boundary: the staircase floor, the
    polynomial's clip, the piecewise scales at and after each boundary, the
    joined schedule's restart."""
    ref = getattr(jax_optimizers, name)(*args, **kwargs
                                        )._create_optax_schedule()
    ours = getattr(optimizers, name)(*args, **kwargs)
    for count in range(61):
        want = float(ref(jnp.asarray(count, dtype=jnp.int32)))
        assert abs(ours(count) - want) <= 1e-7, (count, ours(count), want)


OPTIMIZERS = ['Adam', 'AdamW', 'SparseAdam', 'AdaGrad', 'RMSProp',
              'GradientDescent', 'Lamb']


@pytest.mark.parametrize('scheduled', [False, True])
@pytest.mark.parametrize('name', OPTIMIZERS)
def test_optimizer_updates_match_optax(name, scheduled):
    """20 updates of a small parameter tree from the same gradients, with a
    float rate and with a schedule (update k at schedule(k - 1))."""
    rng = np.random.RandomState(0)
    p0 = {'w': rng.randn(5, 3).astype(np.float32),
          'b': rng.randn(4).astype(np.float32),
          'z': np.zeros(2, np.float32)}         # a zero norm for Lamb
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in
              p0.items()} for _ in range(20)]
    grads[3]['w'][:] = 0.0                       # AdaGrad's zero sums

    def lr(module):
        return module.ExponentialDecay(0.01, 0.8, 3) if scheduled else 0.01
    tx = getattr(jax_optimizers, name)(learning_rate=lr(jax_optimizers)
                                       )._create_optax_optimizer()
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(params)
    ours = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
            for k, v in p0.items()}
    opt = getattr(optimizers, name)(learning_rate=lr(optimizers)
                                    )._create_torch_optimizer(ours.values())
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, params)
        params = optax.apply_updates(params, updates)
        for k, p in ours.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    assert opt.count == 20
    for k, p in ours.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]),
                                   atol=1e-6, rtol=0, err_msg=k)


def test_adamw_amsgrad_is_accepted_and_ignored():
    """``AdamW(amsgrad=True)`` gives optax's ``adamw`` update, as the JAX
    package's ignores the flag."""
    rng = np.random.RandomState(1)
    p0 = rng.randn(6, 4).astype(np.float32)
    g = rng.randn(6, 4).astype(np.float32)
    tx = jax_optimizers.AdamW(learning_rate=0.01, weight_decay=0.1,
                              amsgrad=True)._create_optax_optimizer()
    params = jnp.asarray(p0)
    updates, _ = tx.update(jnp.asarray(g), tx.init(params), params)
    want = np.asarray(optax.apply_updates(params, updates))
    ours = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = optimizers.AdamW(learning_rate=0.01, weight_decay=0.1,
                           amsgrad=True)._create_torch_optimizer([ours])
    ours.grad = torch.from_numpy(g)
    opt.step()
    np.testing.assert_allclose(ours.detach().numpy(), want, atol=1e-6, rtol=0)


def test_kfac_raises():
    with pytest.raises(NotImplementedError):
        optimizers.KFAC(learning_rate=0.01)


def test_optimizer_state_and_count_survive_a_checkpoint(tmp_path):
    """The update count lives in the optimizer's state: restore brings it
    back, and with it the rate of the next update."""
    sched = optimizers.ExponentialDecay(0.01, 0.5, 1)
    model = TorchModel(torch.nn.Linear(3, 2), losses.L2Loss(),
                       output_types=['prediction'], batch_size=4,
                       learning_rate=sched, device='cpu',
                       model_dir=str(tmp_path))
    rng = np.random.RandomState(0)
    ds = NumpyDataset(rng.rand(8, 3), rng.rand(8, 2))
    model.fit(ds, nb_epoch=2, checkpoint_interval=0)
    assert model._torch_optimizer.count == 4
    assert model._torch_optimizer.learning_rate() == sched(4)
    model.save_checkpoint()
    model.fit(ds, nb_epoch=1, checkpoint_interval=0)
    model.restore()
    assert model._torch_optimizer.count == 4
    assert model.get_global_step() == 4


# -- losses ------------------------------------------------------------------

def _loss_inputs(name, rng):
    """(outputs, labels) for one loss, with probabilities of exactly 0 and
    1 where the loss takes probabilities."""
    n, t = 6, 4
    prob = rng.rand(n, t).astype(np.float32)
    prob[0, :2] = [0.0, 1.0]
    onehot = np.eye(t, dtype=np.float32)[rng.randint(0, t, n)]
    if name in ('BinaryCrossEntropy', 'ShannonEntropy'):
        lab = rng.randint(0, 2, (n, t)).astype(np.float32)
        return [prob], lab
    if name == 'CategoricalCrossEntropy':
        prob[1] = [0.0, 1.0, 0.0, 0.0]
        return [prob], onehot
    if name == 'SparseSoftmaxCrossEntropy':
        return [rng.randn(n, t).astype(np.float32)], \
            rng.randint(0, t, (n, 1)).astype(np.float32)
    if name in ('HingeLoss', 'SquaredHingeLoss'):
        return [rng.randn(n, t).astype(np.float32)], \
            np.where(rng.rand(n, t) > 0.5, 1.0, -1.0).astype(np.float32)
    if name == 'PoissonLoss':
        return [rng.rand(n, t).astype(np.float32) + 0.1], \
            rng.poisson(2.0, (n, t)).astype(np.float32)
    if name == 'VAE_ELBO':
        return [rng.randn(n, 3).astype(np.float32),
                rng.randn(n, 3).astype(np.float32) * 0.5, prob], \
            rng.randint(0, 2, (n, t)).astype(np.float32)
    if name == 'VAE_KLDivergence':
        return [rng.randn(n, 3).astype(np.float32),
                rng.randn(n, 3).astype(np.float32) * 0.5], \
            np.zeros((n, 1), np.float32)
    return [rng.randn(n, t).astype(np.float32)], \
        rng.randn(n, t).astype(np.float32)


LOSSES = ['L1Loss', 'HuberLoss', 'HingeLoss', 'SquaredHingeLoss',
          'PoissonLoss', 'BinaryCrossEntropy', 'CategoricalCrossEntropy',
          'SigmoidCrossEntropy', 'SparseSoftmaxCrossEntropy', 'VAE_ELBO',
          'VAE_KLDivergence', 'ShannonEntropy']


@pytest.mark.parametrize('name', LOSSES)
def test_loss_values_and_gradients_match_jax(name):
    rng = np.random.RandomState(LOSSES.index(name))
    outs, lab = _loss_inputs(name, rng)
    multi = name.startswith('VAE')
    ref_fn, ours_fn = getattr(jax_losses, name)(), getattr(losses, name)()

    def ref_value(*o):
        v = ref_fn(list(o) if multi else o[0], jnp.asarray(lab))
        return v, jnp.sum(v * jnp.asarray(
            np.linspace(0.5, 1.5, v.size).reshape(v.shape), v.dtype))
    want, _ = ref_value(*[jnp.asarray(o) for o in outs])
    want_g = jax.grad(lambda *o: ref_value(*o)[1],
                      argnums=tuple(range(len(outs))))(
        *[jnp.asarray(o) for o in outs])
    t_outs = [torch.from_numpy(o).requires_grad_() for o in outs]
    got = ours_fn(t_outs if multi else t_outs[0], torch.from_numpy(lab))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6, rtol=0)
    weights = torch.from_numpy(np.linspace(0.5, 1.5, got.numel()).reshape(
        got.shape).astype(np.float32))
    torch.sum(got * weights).backward()
    for t, g in zip(t_outs, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-6,
                                   rtol=0)


# -- GraphConv through the engine ---------------------------------------------

@pytest.fixture(scope='module')
def graphs():
    return (ConvMolFeaturizer().featurize(SMILES),
            JaxConvMolFeaturizer().featurize(SMILES))


def _data(graphs, n=len(SMILES), mode='classification', seed=0):
    X, X_ref = graphs
    reps = np.resize(np.arange(len(SMILES)), n)
    rng = np.random.RandomState(seed)
    if mode == 'classification':
        labels = rng.randint(0, 2, (n, N_TASKS)).astype(np.float32)
        labels[:2] = [[0, 1, 0], [1, 0, 1]]
    else:
        labels = rng.randn(n, N_TASKS).astype(np.float32)
    weights = np.ones_like(labels)
    weights[1, 2] = 0.0
    return (NumpyDataset(X[reps], labels, weights),
            JaxNumpyDataset(X_ref[reps], labels, weights))


def _pair(ds_ref, ref_cls=JaxGraphConvModel, **kwargs):
    """A JAX model and a port model with the same initial parameters."""
    kw = {**SMALL, **kwargs}
    ref = ref_cls(data_parallel=False, **kw)
    ref.predict(ds_ref)                               # builds the params
    port_kw = {k: v for k, v in kw.items() if k not in ('optimizer',
                                                        'learning_rate')}
    if 'learning_rate' in kw:
        port_kw['learning_rate'] = _port_schedule(kw['learning_rate'])
    model = GraphConvModel(device='cpu', **port_kw)
    params_from_flax(_flatten_params(ref.params), model.module)
    return ref, model


def _port_schedule(lr):
    if isinstance(lr, jax_optimizers.LearningRateSchedule):
        return getattr(optimizers, type(lr).__name__)(**vars(lr))
    return lr


def _scaled(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        1.0, np.abs(np.asarray(b)).max())


def test_reinitialize_draws_a_fresh_model(graphs):
    """reinitialize(seed) gives a fresh model's parameters bit for bit, a
    fresh optimizer (count 0), step 0 and no loss history, and keeps the
    packed batches; an unseeded one continues the generator's stream."""
    ds, _ = _data(graphs)
    model = GraphConvModel(device='cpu', seed=0, **SMALL)
    model.fit(ds, nb_epoch=1, checkpoint_interval=0)
    cache = model._fit_cache
    assert model._torch_optimizer.count == 3 and model.all_losses
    assert model.reinitialize(seed=3) is model
    fresh = GraphConvModel(device='cpu', seed=3, **SMALL)
    for (name, a), b in zip(model.module.state_dict().items(),
                            fresh.module.state_dict().values()):
        assert torch.equal(a, b), name
    assert model._torch_optimizer.count == 0
    assert model.get_global_step() == 0 and model.all_losses == []
    assert model._fit_cache is cache
    model.reinitialize()
    fresh.reinitialize()
    for (name, a), b in zip(model.module.state_dict().items(),
                            fresh.module.state_dict().values()):
        assert torch.equal(a, b), name
    again = GraphConvModel(device='cpu', seed=3, **SMALL)
    assert not torch.equal(model.module.head.weight, again.module.head.weight)
    # the same losses from the same start
    a = model.reinitialize(seed=5).fit(ds, nb_epoch=1, checkpoint_interval=0)
    b = GraphConvModel(device='cpu', seed=5, **SMALL).fit(
        ds, nb_epoch=1, checkpoint_interval=0)
    assert a == b


class _MaskedGraphConv(JaxGraphConvModel):
    """The JAX model training only the parameters under ``train_scopes``:
    the JAX package's ``fit`` takes ``variables`` but trains every
    parameter, so the test masks the others' gradients, which under a
    fresh Adam state leaves them where they are, as a subset's own state
    does."""
    train_scopes = ('Dense_1',)

    def _transform_gradients(self, grads):
        return {'params': {k: (v if k in self.train_scopes else
                               jax.tree.map(jnp.zeros_like, v))
                           for k, v in grads['params'].items()}}


def test_fit_with_variables_trains_only_them(graphs):
    ds, ds_ref = _data(graphs)
    ref, model = _pair(ds_ref, ref_cls=_MaskedGraphConv, learning_rate=0.003)
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    head = [model.module.head.weight, model.module.head.bias]
    ref_losses, losses_ = [], []
    # variables sends the JAX fit down its per-step path, whose gradient
    # hook masks; batches in dataset order on both sides
    ref.fit(ds_ref, nb_epoch=2, checkpoint_interval=0, deterministic=True,
            variables=['Dense_1'], all_losses=ref_losses)
    model.fit(ds, nb_epoch=2, checkpoint_interval=0, deterministic=True,
              variables=head, all_losses=losses_)
    np.testing.assert_allclose(losses_, ref_losses, rtol=1e-4)
    for name, t in model.module.state_dict().items():
        if name.startswith('head.'):
            assert not torch.equal(t, before[name])
        else:
            assert torch.equal(t, before[name]), name
    want = flax_state(_flatten_params(ref.params), model.module)
    for name in ('head.weight', 'head.bias'):
        assert _scaled(model.module.state_dict()[name], want[name]) <= 1e-4
    # the subset's own state; the model's optimizer made no update
    assert model._torch_optimizer.count == 0
    assert model._optimizer_for(head).count == 6
    with pytest.raises(ValueError, match='without a loss'):
        TorchModel(torch.nn.Linear(2, 1), device='cpu').fit_on_batch(
            np.ones((2, 2)), np.ones((2, 1)), np.ones((2, 1)),
            variables=None)


def _jax_weighted_l1(outputs, labels, weights):
    d = jnp.abs(outputs[1][..., 1] - labels[0][..., 1]) * weights[0]
    return jnp.sum(d) / jnp.maximum(jnp.sum(weights[0]), 1e-8)


def _torch_weighted_l1(outputs, labels, weights):
    d = torch.abs(outputs[1][..., 1] - labels[0][..., 1]) * weights[0]
    return torch.sum(d) / torch.clamp_min(torch.sum(weights[0]), 1e-8)


def test_fit_with_a_custom_loss(graphs):
    """``loss`` replaces the model's: held against the JAX model built with
    that loss (the JAX package's ``fit`` takes ``loss`` but keeps its
    own)."""
    ds, ds_ref = _data(graphs)
    ref, model = _pair(ds_ref, learning_rate=0.003)
    ref._loss = _jax_weighted_l1
    ref_losses, losses_ = [], []
    ref.fit(ds_ref, nb_epoch=2, checkpoint_interval=0, all_losses=ref_losses)
    model.fit(ds, nb_epoch=2, checkpoint_interval=0, loss=_torch_weighted_l1,
              all_losses=losses_)
    np.testing.assert_allclose(losses_, ref_losses, rtol=1e-4)
    assert model._loss is not _torch_weighted_l1


def _validation_lines(text):
    return [(int(m.group(1)), float(m.group(2))) for m in re.finditer(
        r'Step (\d+) validation: roc_auc_score=(\S+)', text)]


def test_fit_with_a_schedule_and_validation_callback(graphs, tmp_path):
    """ExponentialDecay and a ValidationCallback every 2 steps that keeps
    the best ROC-AUC: the same losses, validation steps and best score as
    the JAX model; the best checkpoint scores the best score."""
    ds, ds_ref = _data(graphs)
    ref, model = _pair(ds_ref, learning_rate=jax_optimizers.ExponentialDecay(
        0.004, 0.5, 2))
    out_ref, out = io.StringIO(), io.StringIO()
    cb_ref = JaxValidationCallback(
        ds_ref, 2, [jax_metrics.Metric(jax_metrics.roc_auc_score, np.mean)],
        output_file=out_ref, save_dir=str(tmp_path / 'ref'),
        save_on_minimum=False)
    cb = ValidationCallback(
        ds, 2, [metrics.Metric(metrics.roc_auc_score, np.mean)],
        output_file=out, save_dir=str(tmp_path / 'port'),
        save_on_minimum=False)
    ref_losses, losses_ = [], []
    ref.fit(ds_ref, nb_epoch=2, checkpoint_interval=0, callbacks=[cb_ref],
            all_losses=ref_losses)
    model.fit(ds, nb_epoch=2, checkpoint_interval=0, callbacks=[cb],
              all_losses=losses_)
    np.testing.assert_allclose(losses_, ref_losses, rtol=1e-4)
    lines, ref_lines = (_validation_lines(out.getvalue()),
                        _validation_lines(out_ref.getvalue()))
    assert [s for s, _ in lines] == [s for s, _ in ref_lines] == [2, 4, 6]
    np.testing.assert_allclose([v for _, v in lines],
                               [v for _, v in ref_lines], atol=1e-6)
    np.testing.assert_allclose(cb.get_best_score(), cb_ref.get_best_score(),
                               atol=1e-6)
    assert f'{cb.get_best_score():g}' == f'{max(v for _, v in lines):g}'
    assert model._torch_optimizer.learning_rate() == \
        model.optimizer.learning_rate(6)
    model.restore(model_dir=str(tmp_path / 'port'))
    assert model.evaluate(ds, [metrics.Metric(metrics.roc_auc_score,
                                              np.mean)]
                          )['roc_auc_score'] == cb.get_best_score()


def test_streaming_fit_on_device_equals_resident_and_jax(graphs):
    """20 molecules, 5 batches: past a budget of 2 batches' worth a chunk
    holds 2 batches (chunks cross the epoch boundary); the losses and the
    parameters equal the resident run's bit for bit and follow the JAX
    package's streaming run."""
    ds, ds_ref = _data(graphs, n=20)
    ref, resident = _pair(ds_ref, learning_rate=0.003)
    streamed = GraphConvModel(device='cpu', learning_rate=0.003, **SMALL)
    streamed.module.load_state_dict(resident.module.state_dict())
    stack = streamed._host_stack(ds)
    per_batch = sum(a.nbytes for part in stack for a in part) // 5
    streamed.device_data_budget = 4 * per_batch + 1
    cache = ref._ensure_fit_cache(ds_ref)
    ref.device_data_budget = 4 * (cache['nbytes'] // 5) + 1
    runs = {}
    for name, m, r in (('resident', resident, None),
                       ('streamed', streamed, None), ('ref', None, ref)):
        out = []
        (m or r).fit_on_device(ds if m else ds_ref, nb_epoch=2, seed=3,
                               all_losses=out)
        runs[name] = out
    assert resident._fit_cache['dev'] is not None
    assert streamed._fit_cache['dev'] is None
    assert runs['streamed'] == runs['resident']
    for a, b in zip(streamed.module.state_dict().values(),
                    resident.module.state_dict().values()):
        assert torch.equal(a, b)
    np.testing.assert_allclose(runs['streamed'], runs['ref'], rtol=1e-4)
    # past the budget predict_on_device copies a batch at a time too
    np.testing.assert_array_equal(streamed.predict_on_device(ds),
                                  streamed.predict(ds))
    assert streamed._fit_cache['dev'] is None


def test_uncertainty_outputs_and_loss_match_jax(graphs):
    """With dropout off (eval), the four outputs and the Gaussian
    likelihood loss from the same weights; then predict_uncertainty's
    combination of its passes against numpy over the port's own passes
    from the same dropout seeds."""
    ds, ds_ref = _data(graphs, mode='regression')
    ref, model = _pair(ds_ref, mode='regression', uncertainty=True,
                       dropout=0.2)
    batch = next(model.default_generator(ds))
    j_in = [jnp.asarray(a) for a in batch[0]]
    ref_out = ref._forward(ref.params, j_in, training=False, rng=None)
    ref_loss = ref._compute_loss(ref_out, [jnp.asarray(batch[1][0])],
                                 [jnp.asarray(batch[2][0])])
    t_in, t_lab, t_w = model._prepare_batch(batch)
    model.module.eval()
    with torch.no_grad():
        out = model.module(*t_in)
        loss = model._compute_loss(list(out), t_lab, t_w)
    assert len(out) == 4
    for a, b in zip(out, ref_out):
        assert _scaled(a.numpy(), b) <= 1e-5
    assert _scaled(loss.item(), float(ref_loss)) <= 1e-5
    masks = 3
    model.module._dropout_generator = None
    pred, std = model.predict_uncertainty(ds, masks=masks)
    model.module._dropout_generator = None
    passes = [model._predict(model.default_generator(
        ds, mode='uncertainty', pad_batches=False), [], uncertainty=True)
        for _ in range(masks)]
    preds = np.stack([p[:len(ds)] for p, _ in passes])
    var = np.mean([v[:len(ds)] for _, v in passes], axis=0) \
        + np.mean(preds * preds, axis=0) - preds.mean(axis=0) ** 2
    np.testing.assert_allclose(pred, preds.mean(axis=0), rtol=1e-12)
    np.testing.assert_allclose(std, np.sqrt(np.maximum(var, 0)), rtol=1e-6)
    assert np.all(np.isfinite(std)) and np.all(std > 0)
    assert not np.array_equal(preds[0], preds[1])       # dropout was on
    on_batch = model.predict_uncertainty_on_batch(ds.X[:5], masks=2)
    assert on_batch[0].shape == on_batch[1].shape == (5, N_TASKS)
    with pytest.raises(ValueError, match='variances'):
        GraphConvModel(device='cpu', mode='regression',
                       **SMALL).predict_uncertainty(ds, masks=1)


def test_load_from_pretrained_without_top_copies_what_jax_copies(graphs):
    """include_top=False with no head named leaves out the module whose
    path sorts last, as the JAX package does (its MaskedBatchNorm_2, the
    port's norms.2); with top_layers the named head."""
    _, ds_ref = _data(graphs)
    src_ref, src = _pair(ds_ref, seed=0)
    dst_ref, dst = _pair(ds_ref, seed=1)
    start_ref, start = dst_ref.params, dst.module.state_dict()
    start = {k: v.clone() for k, v in start.items()}
    for top, port_top in ((None, None), (['Dense_1'], ['head'])):
        dst_ref.params = start_ref
        dst.module.load_state_dict(start)
        dst_ref.load_from_pretrained(src_ref, include_top=False,
                                     top_layers=top)
        dst.load_from_pretrained(src, include_top=False,
                                 top_layers=port_top)
        want = flax_state(_flatten_params(dst_ref.params), dst.module)
        for name, t in dst.module.state_dict().items():
            assert torch.equal(t, want[name]), (top, name)
    dst.load_from_pretrained(src)
    for a, b in zip(dst.module.state_dict().values(),
                    src.module.state_dict().values()):
        assert torch.equal(a, b)
    assert dst._torch_optimizer.count == 0
    dst.load_from_pretrained(src, assignment_map={'head.bias': 'head.bias'},
                             value_map={'head.bias': np.full(
                                 N_TASKS * 2, 0.5, np.float32)})
    assert torch.all(dst.module.head.bias == 0.5)


def test_evaluate_on_device_and_evaluate_generator_match(graphs):
    ds, ds_ref = _data(graphs)
    ref, model = _pair(ds_ref)
    ms = [metrics.Metric(metrics.roc_auc_score, np.mean),
          metrics.Metric(metrics.prc_auc_score, np.mean),
          metrics.Metric(metrics.accuracy_score, np.mean)]
    a = model.evaluate(ds, ms)
    assert model.evaluate_on_device(ds, ms) == a
    gen = model.evaluate_generator(model.default_generator(ds), ms[:1])
    want = ref.evaluate_generator(ref.default_generator(ds_ref), [
        jax_metrics.Metric(jax_metrics.roc_auc_score, np.mean)])
    np.testing.assert_allclose(gen['roc_auc_score'], want['roc_auc_score'],
                               atol=1e-6)


def test_fit_generator_prefetch_follows_the_loop_and_reraises():
    """The prefetch thread changes no loss, and its producer's exception
    is raised in the caller."""
    rng = np.random.RandomState(0)
    ds = NumpyDataset(rng.rand(16, 3), rng.rand(16, 2))
    init = torch.nn.Linear(3, 2).state_dict()
    runs = []
    for depth in (0, 2):
        model = TorchModel(torch.nn.Linear(3, 2), losses.L2Loss(),
                           batch_size=4, log_frequency=2, device='cpu',
                           learning_rate=0.01)
        model.module.load_state_dict(init)
        model.prefetch_depth = depth
        out = []
        model.fit_generator(model.default_generator(ds, epochs=2),
                            checkpoint_interval=0, all_losses=out)
        runs.append(out)
    assert runs[0] == runs[1] and len(runs[0]) == 4

    def broken():
        yield from model.default_generator(ds)
        raise RuntimeError('producer failed')
    with pytest.raises(RuntimeError, match='producer failed'):
        model.fit_generator(broken(), checkpoint_interval=0)


class _Dense(fnn.Module):
    @fnn.compact
    def __call__(self, x, training=False):
        h = jnp.tanh(fnn.Dense(5)(x))
        return fnn.Dense(3)(h), h


class _TorchDense(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0, self.Dense_1 = torch.nn.Linear(4, 5), \
            torch.nn.Linear(5, 3)

    def forward(self, x):
        h = torch.tanh(self.Dense_0(x))
        return self.Dense_1(h), h


def test_saliency_and_embedding_match_jax():
    rng = np.random.RandomState(0)
    X = rng.randn(7, 4).astype(np.float32)
    ref = JaxModel(_Dense(), jax_losses.L2Loss(),
                   output_types=['prediction', 'embedding'], batch_size=4,
                   data_parallel=False)
    ref_ds = JaxNumpyDataset(X, rng.randn(7, 3))
    ref.predict(ref_ds)
    model = TorchModel(_TorchDense(), losses.L2Loss(),
                       output_types=['prediction', 'embedding'],
                       batch_size=4, device='cpu')
    with torch.no_grad():
        for name, leaf in _flatten_params(ref.params).items():
            _, scope, kind = name.split('/')
            layer = getattr(model.module, scope)
            if kind == 'kernel':
                layer.weight.copy_(torch.from_numpy(np.asarray(leaf).T))
            else:
                layer.bias.copy_(torch.from_numpy(np.asarray(leaf)))
    ds = NumpyDataset(X, ref_ds.y)
    np.testing.assert_allclose(model.predict_embedding(ds),
                               ref.predict_embedding(ref_ds), atol=1e-6)
    np.testing.assert_allclose(model.compute_saliency(X[2]),
                               ref.compute_saliency(X[2]), atol=1e-6)


# -- transformers ------------------------------------------------------------

def _transformer_cases():
    rng = np.random.RandomState(0)
    X = rng.rand(20, 4)
    y = rng.rand(20, 3) * 5
    yc = rng.randint(0, 2, (20, 3)).astype(float)
    w = (rng.rand(20, 3) > 0.2).astype(float)
    return [
        ('MinMaxTransformer', dict(transform_X=True), X, y, w),
        ('MinMaxTransformer', dict(transform_y=True), X, y, w),
        ('ClippingTransformer', dict(transform_X=True, x_max=0.5), X, y, w),
        ('ClippingTransformer', dict(transform_y=True, y_max=2.), X, y, w),
        ('LogTransformer', dict(transform_y=True), X, y, w),
        ('LogTransformer', dict(transform_X=True, features=[0, 2]), X, y, w),
        ('LogTransformer', dict(transform_y=True, tasks=[1]), X, y, w),
        ('BalancingTransformer', dict(), X, yc, w),
        ('DuplicateBalancingTransformer', dict(), X, yc[:, :1], w[:, :1]),
        ('CDFTransformer', dict(transform_y=True), X, y, w),
        ('CDFTransformer', dict(transform_X=True), X, y, w),
        ('PowerTransformer', dict(transform_X=True, powers=[1, 2, 3]), X, y,
         w),
        ('PowerTransformer', dict(transform_y=True, powers=[1, 2]), X, y, w),
        ('NormalizationTransformer', dict(transform_y=True), X, y, w)]


@pytest.mark.parametrize('case', range(14))
def test_transformers_match_jax(case):
    name, kw, X, y, w = _transformer_cases()[case]
    ds_ref, ds = JaxNumpyDataset(X, y, w), NumpyDataset(X, y, w)
    ref = getattr(jax_trans, name)(dataset=ds_ref, **kw)
    ours = getattr(trans, name)(dataset=ds, **kw)
    a, b = ref.transform(ds_ref), ours.transform(ds)
    for f in ('X', 'y', 'w'):
        np.testing.assert_allclose(np.asarray(getattr(b, f), float),
                                   np.asarray(getattr(a, f), float),
                                   atol=1e-12, rtol=0, err_msg=f)
    assert list(a.ids) == list(b.ids)
    if name == 'BalancingTransformer':
        assert ours.weights == ref.weights
    z = np.asarray(a.y if ref.transform_y else a.X)
    try:
        want = ref.untransform(z)
    except (NotImplementedError, AttributeError) as e:
        with pytest.raises(type(e)):
            ours.untransform(z)
        return
    np.testing.assert_allclose(ours.untransform(z), want, atol=1e-12,
                               rtol=0)


def test_flattening_transformer_and_undo_grad_transforms_match_jax():
    X = np.empty(3, dtype=object)
    for i, n in enumerate((2, 3, 1)):
        X[i] = np.arange(float(n))
    ds_ref, ds = JaxNumpyDataset(X, np.arange(3.)), NumpyDataset(
        X, np.arange(3.))
    a = jax_trans.FlatteningTransformer(ds_ref).transform(ds_ref)
    b = trans.FlatteningTransformer(ds).transform(ds)
    for f in ('X', 'y', 'w'):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    assert list(a.ids) == list(b.ids)
    rng = np.random.RandomState(1)
    Xn, yn, g = rng.rand(10, 2), rng.rand(10, 3) * 4, rng.rand(10, 3)
    ref = [jax_trans.NormalizationTransformer(
        transform_y=True, dataset=JaxNumpyDataset(Xn, yn))]
    ours = [trans.NormalizationTransformer(transform_y=True,
                                           dataset=NumpyDataset(Xn, yn))]
    np.testing.assert_allclose(trans.undo_grad_transforms(g, None, ours),
                               jax_trans.undo_grad_transforms(g, None, ref),
                               atol=1e-12, rtol=0)


# -- score functions and the evaluator ----------------------------------------

WEIGHTED = {'accuracy_score', 'balanced_accuracy_score', 'f1_score',
            'jaccard_score', 'matthews_corrcoef', 'precision_score',
            'recall_score', 'cohen_kappa_score', 'mean_absolute_error',
            'mean_squared_error', 'median_absolute_error', 'r2_score',
            'roc_auc_score', 'precision_recall_curve', 'roc_curve',
            'top_k_accuracy_score'}
SCORES = ['accuracy_score', 'balanced_accuracy_score', 'f1_score',
          'jaccard_score', 'matthews_corrcoef', 'precision_score',
          'recall_score', 'cohen_kappa_score', 'auc',
          'precision_recall_curve', 'roc_curve', 'top_k_accuracy_score',
          'mean_absolute_error', 'mean_squared_error',
          'median_absolute_error', 'r2_score', 'pearsonr', 'jaccard_index',
          'pixel_error', 'prc_auc_score', 'kappa_score', 'bedroc_score',
          'concordance_index', 'rmse']


def _score_inputs(name, trial, rng):
    n = rng.randint(5, 60)
    yb = rng.randint(0, 2, n)
    if trial % 5 == 0:
        yb[:] = 1                                   # constant labels
    pb = rng.randint(0, 2, n)
    if trial % 7 == 0:
        pb[:] = 0                                   # constant predictions
    if trial % 11 == 0:
        pb = yb.copy()
    score = rng.rand(n) if trial % 3 else np.round(rng.rand(n), 1)  # ties
    yr, pr = rng.randn(n), rng.randn(n)
    if trial % 4 == 0:
        yr[:] = 1.5
    if name in ('auc',):
        return (np.sort(score), score)
    if name in ('precision_recall_curve', 'roc_curve', 'prc_auc_score',
                'bedroc_score'):
        return (yb, score)
    if name == 'top_k_accuracy_score':
        ym = rng.randint(0, 3, n)
        ym[:3] = [0, 1, 2]
        sm = rng.rand(n, 3)
        return (ym, np.round(sm, 1) if trial % 2 else sm)
    if name in ('mean_absolute_error', 'mean_squared_error',
                'median_absolute_error', 'r2_score', 'pearsonr',
                'concordance_index', 'rmse'):
        return (yr, pr)
    return (yb, pb)


def _sklearn_or_jax(name):
    return getattr(jax_metrics, name, None) or getattr(sk, name)


@pytest.mark.parametrize('name', SCORES)
def test_score_functions_match_sklearn(name):
    """Random inputs, ties, constant labels and predictions, with and
    without sample weights, against the JAX package's function (scikit-
    learn's, which it re-exports)."""
    rng = np.random.RandomState(SCORES.index(name))
    ref, ours = _sklearn_or_jax(name), getattr(metrics, name)
    for trial in range(24):
        args = _score_inputs(name, trial, rng)
        n = len(args[0])
        w = rng.rand(n) * (rng.rand(n) > 0.2)
        kws = [{}, {'sample_weight': w}] if name in WEIGHTED else [{}]
        if name == 'top_k_accuracy_score':
            kws = [dict(kw, k=k) for kw in kws for k in (1, 2)]
        for kw in kws:
            try:
                want = ref(*args, **kw)
            except ValueError:
                with pytest.raises(ValueError):
                    ours(*args, **kw)
                continue
            got = ours(*args, **kw)
            for g, r in zip(np.atleast_1d(np.asarray(got, dtype=object)),
                            np.atleast_1d(np.asarray(want, dtype=object))):
                g, r = np.asarray(g, float), np.asarray(r, float)
                assert g.shape == r.shape
                assert np.array_equal(np.isnan(g), np.isnan(r))
                np.testing.assert_allclose(g, r, atol=1e-12, rtol=0)


@pytest.mark.parametrize('average', ['macro', 'micro', 'weighted', None])
def test_averaged_set_scores_match_sklearn(average):
    rng = np.random.RandomState(0)
    y, p = rng.randint(0, 3, 50), rng.randint(0, 3, 50)
    for name in ('f1_score', 'precision_score', 'recall_score',
                 'jaccard_score'):
        np.testing.assert_allclose(
            getattr(metrics, name)(y, p, average=average),
            getattr(sk, name)(y, p, average=average), atol=1e-12, rtol=0)


class _Fixed:
    """A model whose predictions are fixed."""

    def __init__(self, pred):
        self.pred = pred

    def predict(self, dataset, transformers=()):
        return self.pred

    predict_on_device = predict


@pytest.mark.parametrize('mode', ['classification', 'regression'])
def test_evaluator_matches_jax(mode):
    """Per-task and weighted scores of fixed predictions, through the
    transformer of the labels for regression."""
    rng = np.random.RandomState(0)
    n, t = 40, 3
    w = rng.rand(n, t) * (rng.rand(n, t) > 0.1)
    if mode == 'classification':
        y = rng.randint(0, 2, (n, t)).astype(float)
        p1 = rng.rand(n, t)
        pred = np.stack([1 - p1, p1], axis=-1)
        names = ['roc_auc_score', 'prc_auc_score', 'accuracy_score',
                 'f1_score', 'matthews_corrcoef', 'balanced_accuracy_score']
    else:
        y, pred = rng.randn(n, t), rng.randn(n, t)
        names = ['mean_absolute_error', 'r2_score', 'pearson_r2_score',
                 'rms_score', 'median_absolute_error']
    ds_ref, ds = JaxNumpyDataset(rng.rand(n, 2), y, w), NumpyDataset(
        rng.rand(n, 2), y, w)
    tr_ref = [jax_trans.NormalizationTransformer(transform_y=True,
                                                 dataset=ds_ref)] \
        if mode == 'regression' else []
    tr = [trans.NormalizationTransformer(transform_y=True, dataset=ds)] \
        if mode == 'regression' else []
    for per_task in (False, True):
        for weighted in (False, True):
            if weighted:
                # the JAX package's pearson_r2_score and rms_score take no
                # sample_weight (a NaN score); the port's rms_score does
                names = [m for m in names
                         if m not in ('pearson_r2_score', 'rms_score')]
            want = JaxEvaluator(_Fixed(pred), ds_ref, tr_ref
                                ).compute_model_performance(
                [jax_metrics.Metric(getattr(jax_metrics, m), np.mean)
                 for m in names], per_task_metrics=per_task,
                use_sample_weights=weighted)
            got = Evaluator(_Fixed(pred), ds, tr, use_device_path=True
                            ).compute_model_performance(
                [metrics.Metric(getattr(metrics, m), np.mean)
                 for m in names], per_task_metrics=per_task,
                use_sample_weights=weighted)
            if not per_task:
                got, want = (got,), (want,)
            for g, r in zip(got, want):
                assert set(g) == set(r)
                for k in r:
                    np.testing.assert_allclose(g[k], r[k], atol=1e-12,
                                               rtol=0, err_msg=k)
