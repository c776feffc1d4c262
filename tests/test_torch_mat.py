"""The port's MAT, attention layers and GROVER and NT-Xent losses against
the JAX package's, on the CPU.

Tolerances: the featurizer's arrays equal (no arithmetic past the 3D
distances, which both compute with numpy); each model's outputs and every
gradient from the same flax weights within 1e-5 of max(1, |ref|); a
2-epoch ``fit`` within rtol 1e-4; the layers and losses within 1e-5 (their
gradients too).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepchem_tpu.chem import mol_from_smiles as jax_mol_from_smiles
from deepchem_tpu.data import NumpyDataset as JaxNumpyDataset
from deepchem_tpu.models import attention_layers as JA
from deepchem_tpu.models import losses as JL
from deepchem_tpu.models import mat as JM
from deepchem_tpu.models.jax_model import _flatten_params
from deepchem_tpu_torch.chem import mol_from_smiles
from deepchem_tpu_torch.data import NumpyDataset
from deepchem_tpu_torch.models import attention_layers as A
from deepchem_tpu_torch.models import losses as L
from deepchem_tpu_torch.models import mat as M
from deepchem_tpu_torch.models.convert import flax_state, params_from_flax

torch.set_num_threads(1)

# a salt (two fragments: unreachable pairs), charges, rings, Se and Si
SMILES = ['CCO', 'c1ccccc1', '[Na+].[Cl-]', 'C[N+](C)(C)CC(=O)[O-]',
          'CC(=O)Nc1ccc(O)cc1', 'C[Se]C', 'C[Si](C)(C)C', 'OC(=O)c1ccccc1']
SMALL = dict(dim=8, n_layers=2, n_heads=2, batch_size=3)
N_TASKS = 2


def _scaled(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


@pytest.fixture(scope='module')
def data():
    X = M.MATFeaturizer().featurize(SMILES)
    jX = JM.MATFeaturizer().featurize(SMILES)
    y = np.random.RandomState(0).randn(len(SMILES), N_TASKS).astype(
        np.float32)
    return X, jX, y


def test_featurizer_matches_jax(data):
    X, jX, _ = data
    for smi, a, b in zip(SMILES, X, jX, strict=True):
        for k in ('node_features', 'adjacency_matrix', 'distance_matrix'):
            x, r = getattr(a, k), getattr(b, k)
            assert x.dtype == r.dtype == np.float32, (smi, k)
            np.testing.assert_array_equal(x, r, err_msg=f'{smi} {k}')
    salt = X[2].distance_matrix
    assert salt[1, 2] == salt[0, 1] == M.FAR and salt[1, 1] == 0
    assert X[0].node_features.shape == (4, 31)
    # a conformer's distances replace the bond counts
    xyz = np.random.RandomState(1).randn(3, 3).tolist()
    mol, jmol = mol_from_smiles('CCO'), jax_mol_from_smiles('CCO')
    mol.conformer = jmol.conformer = xyz
    a = M.MATFeaturizer()._featurize(mol)
    b = JM.MATFeaturizer()._featurize(jmol)
    np.testing.assert_array_equal(a.distance_matrix, b.distance_matrix)
    with pytest.raises(ValueError):
        M.MATFeaturizer().construct_mol('C1CC')


def _pair(kw, data):
    X, jX, y = data
    kw = {**SMALL, **kw}
    ref = JM.MATModel(n_tasks=N_TASKS, **kw)
    model = M.MATModel(n_tasks=N_TASKS, device='cpu', **kw)
    ref.build(ref._prepare_batch(next(ref.default_generator(
        JaxNumpyDataset(jX), mode='predict')))[0])
    params_from_flax(_flatten_params(ref.params), model.module)
    return ref, model


# one layer each (the fit runs two)
CONFIGS = [dict(norm=n, dist_kernel=d, aggregation_type=a, n_layers=1,
                mode='classification' if i % 2 else 'regression')
           for i, (n, d, a) in enumerate(
               (n, d, a) for n in ('layer', 'scale')
               for d in ('softmax', 'exp')
               for a in ('mean', 'sum', 'grover'))]


@pytest.mark.parametrize('kw', CONFIGS, ids=lambda kw: '-'.join(
    kw[k] for k in ('norm', 'dist_kernel', 'aggregation_type', 'mode')))
def test_model_outputs_and_gradients_match_flax(data, kw):
    """The JAX side draws its parameters and takes its loss and gradients
    in one jitted function (one compile a configuration)."""
    X, jX, y = data
    ref = JM.MATModel(n_tasks=N_TASKS, **{**SMALL, **kw})
    model = M.MATModel(n_tasks=N_TASKS, device='cpu', **{**SMALL, **kw})
    ds = NumpyDataset(X, (y > 0).astype(np.float32)
                      if kw['mode'] == 'classification' else y)
    inputs, labels, weights = next(model.default_generator(ds))

    @jax.jit
    def run(j_in, j_lab, j_w):
        params = ref.module.init(jax.random.PRNGKey(0), *j_in,
                                 training=False)

        def loss_fn(p):
            out = ref._forward(p, j_in, True, jax.random.PRNGKey(0))
            return ref._compute_loss(out, j_lab, j_w), out
        return params, jax.value_and_grad(loss_fn, has_aux=True)(params)
    params, ((loss_ref, ref_out), g_ref) = run(
        *([jnp.asarray(a) for a in part]
          for part in (inputs, labels, weights)))
    params_from_flax(_flatten_params(params), model.module)
    t_in, t_lab, t_w = model._prepare_batch((inputs, labels, weights))
    with torch.no_grad():
        out = model.module(*t_in)
    out = out if isinstance(out, tuple) else (out,)
    for a, b in zip(out, ref_out, strict=True):
        assert tuple(a.shape) == b.shape
        assert _scaled(a.numpy(), b) <= 1e-5
    loss = model._train_step(t_in, t_lab, t_w)
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
    want = flax_state(_flatten_params(g_ref), model.module)
    grads = dict(model.module.named_parameters())
    assert set(want) == set(grads)
    for key, g in want.items():
        assert _scaled(grads[key].grad.numpy(), g.numpy()) <= 1e-5, key


def test_fit_follows_the_jax_losses(data):
    """2 epochs of fit (3 batches of 3, the last short and padded; one
    loss window an epoch) from the same weights."""
    X, jX, y = data
    ref, model = _pair(dict(learning_rate=0.003, log_frequency=3), data)
    ref_losses, losses = [], []
    ref.fit(JaxNumpyDataset(jX, y), nb_epoch=2, checkpoint_interval=0,
            all_losses=ref_losses)
    model.fit(NumpyDataset(X, y), nb_epoch=2, checkpoint_interval=0,
              all_losses=losses)
    assert len(losses) == len(ref_losses) == 2
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    pred, ref_pred = model.predict(NumpyDataset(X)), ref.predict(
        JaxNumpyDataset(jX))
    assert pred.shape == (len(SMILES), N_TASKS)
    assert _scaled(pred, ref_pred) <= 1e-4


def _grad_pair(fn_t, fn_j, *arrays):
    """Value and the gradient of its sum of squares by every input, the
    port's against JAX's."""
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn_t(*ts)
    outs = out if isinstance(out, tuple) else (out,)
    sum(o.pow(2).sum() for o in outs).backward()

    def f(*xs):
        r = fn_j(*xs)
        rs = r if isinstance(r, tuple) else (r,)
        return sum(jnp.sum(o ** 2) for o in rs), rs
    grads, ref = jax.jit(jax.grad(f, argnums=tuple(range(len(arrays))),
                                  has_aux=True))(
        *[jnp.asarray(a) for a in arrays])
    for a, b in zip(outs, ref, strict=True):
        assert _scaled(a.detach().numpy(), b) <= 1e-5
    for t, g in zip(ts, grads):
        assert _scaled(t.grad.numpy(), g) <= 1e-5


def test_attention_layers_match_flax():
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(2, 3, 5, 4).astype(np.float32) for _ in range(3))
    mask = (rng.rand(2, 3, 5, 5) > 0.3).astype(np.float32)
    sdpa = JA.ScaledDotProductAttention()
    for m in (None, mask):
        extra = () if m is None else (m,)
        _grad_pair(lambda a, b, c: A.ScaledDotProductAttention()(
            a, b, c, None if m is None else torch.from_numpy(m)),
            lambda a, b, c: sdpa.apply({}, a, b, c, *extra), q, k, v)
    X = rng.randn(7, 6).astype(np.float32)
    jsa = JA.SelfAttention(in_features=6, out_features=3, hidden_size=5)
    params = jsa.init(jax.random.PRNGKey(0), jnp.asarray(X))
    sa = A.SelfAttention(6, 3, 5)
    params_from_flax(_flatten_params(params), sa)
    _grad_pair(sa, lambda x: jsa.apply(params, x), X)
    scope = [(0, 3), (3, 0), (3, 4)]
    for rtype in ('mean', 'self_attention'):
        jro = JA.GroverReadout(rtype=rtype, in_features=6,
                               attn_hidden_size=5, attn_out_size=2)
        params = jro.init(jax.random.PRNGKey(1), jnp.asarray(X), scope)
        ro = A.GroverReadout(rtype, 6, 5, 2)
        if rtype == 'self_attention':
            params_from_flax(_flatten_params(params), ro)
        out = ro(torch.from_numpy(X), scope)
        assert out.shape == ((3, 6) if rtype == 'mean' else (3, 12))
        assert float(out[1].detach().abs().max()) == 0.0   # the empty scope
        _grad_pair(lambda x: ro(x, scope),
                   lambda x: jro.apply(params, x, scope), X)


def test_grover_and_ntxent_losses_match_jax():
    rng = np.random.RandomState(3)
    av, bv, fg = (rng.randn(9, 7).astype(np.float32),
                  rng.randn(12, 5).astype(np.float32),
                  rng.randn(4, 10).astype(np.float32))
    av_l, bv_l = rng.randint(0, 7, 9), rng.randint(0, 5, 12)
    fg_l = (rng.rand(4, 10) > 0.5).astype(np.float32)
    _grad_pair(lambda a, b, c: L.GroverPretrainLoss()(
        a, b, c, torch.from_numpy(av_l), torch.from_numpy(bv_l),
        torch.from_numpy(fg_l)),
        lambda a, b, c: JL.GroverPretrainLoss()(a, b, c, av_l, bv_l, fg_l),
        av, bv, fg)
    z1, z2 = (rng.randn(6, 8).astype(np.float32) for _ in range(2))
    for t in (0.5, 0.1):
        _grad_pair(L.NTXentMultiplePositives(t),
                   JL.NTXentMultiplePositives(t), z1, z2)
