"""The port's Weave slice (``WeaveFeaturizer``, ``WeaveLayer``,
``WeaveGather``, ``WeaveModel``) against the JAX package's, on the CPU.

Same inputs, SMILES written inline and numpy arrays from a seed, go through
the JAX function and the port's.  Tolerances: the featurizer's atom and
pair features, the molecules' neighbours and rings, and the packed batch
equal (no arithmetic); each layer's and the model's outputs and every
gradient from the same flax weights within 1e-5 of max(1, |ref|) (matmuls
summed in another order; the port splits the weight of ``[a_i ; a_j]``
over its two halves); per-epoch losses of a short ``fit`` and of
``fit_on_device`` within 1e-4 relative (those differences carried
through a few Adam steps).  Weave runs no kernel of the port's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepchem_tpu.chem import mol_from_smiles as jax_mol_from_smiles
from deepchem_tpu.data import NumpyDataset as JaxNumpyDataset
from deepchem_tpu.feat import WeaveFeaturizer as JaxWeaveFeaturizer
from deepchem_tpu.models.graph_layers import WeaveGather as JaxWeaveGather
from deepchem_tpu.models.graph_layers import WeaveLayer as JaxWeaveLayer
from deepchem_tpu.models.jax_model import _flatten_params
from deepchem_tpu.models.weave_models import WeaveModel as JaxWeaveModel
from deepchem_tpu_torch import NumpyDataset, WeaveFeaturizer, WeaveModel
from deepchem_tpu_torch.chem import mol_from_smiles
from deepchem_tpu_torch.models import (WeaveGather, WeaveLayer,
                                       WeaveTensorGraph, params_from_flax)
from deepchem_tpu_torch.models.convert import flax_state

torch.set_num_threads(1)

# rings, fused and bridged rings, aromatics, charges, @ and @@, cis/trans,
# a single atom, two fragments (no path between them), and chains whose
# ends lie 7 and 10 bonds apart (the ">= 7" distance column)
SMILES = ['CCO', 'c1ccccc1O', 'C[C@H](N)C(=O)O', 'C/C=C/C', '[NH4+]',
          'C[N+](C)(C)CC(=O)[O-]', 'C', '[Na+].[Cl-]',
          'CC(=O)Oc1ccccc1C(=O)O', 'FC(F)(F)c1ccc(Cl)cc1Br', 'N#Cc1ccncc1',
          'O=S(=O)(N)c1ccc(N)cc1', 'c1ccsc1', 'C1CC2CCC1C2',
          'c1ccc2ccccc2c1', 'Clc1ccc2c(c1)C(=NCC(=O)N2)c1ccccc1',
          'CCCCCCCC', 'CCCCCCCCCCN', 'C1=CC=CC=C1C#N', 'Ic1ccc[nH]1']
N_TASKS = 2
SMALL = dict(n_tasks=N_TASKS, n_hidden=8, n_graph_feat=12, batch_size=8,
             log_frequency=2)


def _scaled(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        1.0, np.abs(np.asarray(b)).max())


@pytest.fixture(scope='module')
def graphs():
    return (WeaveFeaturizer().featurize(SMILES),
            JaxWeaveFeaturizer().featurize(SMILES))


def test_featurizer_matches_jax(graphs):
    ours, ref = graphs
    far = False
    for smi, a, b in zip(SMILES, ours, ref, strict=True):
        n = a.num_nodes
        assert a.node_features.dtype == a.pair_features.dtype == np.float32
        assert a.node_features.shape == (n, 75)
        assert a.pair_features.shape == (n * n, 14)
        np.testing.assert_array_equal(a.node_features, b.node_features,
                                      err_msg=smi)
        np.testing.assert_array_equal(a.pair_features, b.pair_features,
                                      err_msg=smi)
        np.testing.assert_array_equal(a.edge_index, b.edge_index,
                                      err_msg=smi)
        pf = a.pair_features
        assert not pf[:, 5].any() and not pf[:, 13].any(), smi
        far |= bool(pf[:, 12].any())
    assert far                          # a pair 7 or more bonds apart
    by = dict(zip(SMILES, ours))
    # a fragment pair has no distance column; a ring pair its column 4
    salt = by['[Na+].[Cl-]'].pair_features.reshape(2, 2, 14)
    assert not salt[0, 1].any()
    benzene = by['c1ccccc1O'].pair_features.reshape(7, 7, 14)
    assert benzene[0, 3, 4] == 1 and benzene[0, 6, 4] == 0


def test_neighbors_and_rings_match_jax():
    for smi in SMILES:
        mol, ref = mol_from_smiles(smi), jax_mol_from_smiles(smi)
        assert mol.rings() == ref.rings(), smi
        for i in range(mol.num_atoms):
            assert mol.neighbors(i) == ref.neighbors(i), smi


def test_featurizer_with_chirality_matches_jax():
    ours = WeaveFeaturizer(use_chirality=True).featurize(SMILES[:4])
    ref = JaxWeaveFeaturizer(use_chirality=True).featurize(SMILES[:4])
    for a, b in zip(ours, ref, strict=True):
        assert a.node_features.shape[1] == 78
        np.testing.assert_array_equal(a.node_features, b.node_features)


def _grads_match(layer, ref_apply, params, args, ct):
    """The port's layer and flax's from ``params``: outputs, and the
    gradients of ``Σ out * ct`` for the inputs and every parameter."""
    def f(p, *xs):
        out = ref_apply(p, *xs)
        outs = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o * c) for o, c in zip(outs, ct)), outs
    (_, ref_outs), g_ref = jax.value_and_grad(
        f, argnums=tuple(range(len(args) + 1)), has_aux=True)(
        params, *[jnp.asarray(a) for a in args])
    params_from_flax(_flatten_params({'params': params}), layer)
    xs = [torch.tensor(a, requires_grad=True) for a in args]
    out = layer(*xs)
    outs = out if isinstance(out, tuple) else (out,)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, ct)).backward()
    for o, r in zip(outs, ref_outs, strict=True):
        assert _scaled(o.detach().numpy(), r) <= 1e-5
    for x, g in zip(xs, g_ref[1:]):
        assert _scaled(x.grad.numpy(), g) <= 1e-5
    want = flax_state(_flatten_params({'params': g_ref[0]}), layer)
    got = dict(layer.named_parameters())
    assert set(want) == set(got)
    for k, g in want.items():
        assert _scaled(got[k].grad.numpy(), g.numpy()) <= 1e-5, k


@pytest.mark.parametrize('update_pair', [True, False])
def test_weave_layer_matches_flax(update_pair):
    rng = np.random.RandomState(1)
    B, A, F, P, H = 3, 6, 7, 5, 4
    atoms = rng.randn(B, A, F).astype(np.float32)
    pairs = rng.randn(B, A, A, P).astype(np.float32)
    pmask = (rng.rand(B, A, A) > 0.3).astype(np.float32)
    ref = JaxWeaveLayer(H, H, H, update_pair=update_pair)
    params = ref.init(jax.random.PRNGKey(0), atoms, pairs, pmask)['params']
    layer = WeaveLayer(F, P, H, H, H, update_pair=update_pair)
    ct = (rng.randn(B, A, H).astype(np.float32),
          rng.randn(B, A, A, H if update_pair else P).astype(np.float32))
    _grads_match(layer, lambda p, *xs: ref.apply({'params': p}, *xs),
                 params, (atoms, pairs, pmask), ct)


@pytest.mark.parametrize('gaussian_expand', [True, False])
def test_weave_gather_matches_flax(gaussian_expand):
    rng = np.random.RandomState(2)
    B, A, F = 3, 6, 5
    atoms = np.tanh(rng.randn(B, A, F)).astype(np.float32)
    amask = (rng.rand(B, A) > 0.3).astype(np.float32)
    ref = JaxWeaveGather(gaussian_expand=gaussian_expand)
    params = ref.init(jax.random.PRNGKey(0), atoms, amask).get('params', {})
    layer = WeaveGather(F, gaussian_expand)
    ct = (rng.randn(B, F).astype(np.float32),)
    _grads_match(layer, lambda p, *xs: ref.apply({'params': p}, *xs),
                 params, (atoms, amask), ct)


def _labels(mode, n):
    rng = np.random.RandomState(0)
    if mode == 'classification':
        y = rng.randint(0, 2, (n, N_TASKS)).astype(np.float32)
    else:
        y = (rng.randn(n, N_TASKS) * 2 + 1).astype(np.float32)
    w = np.ones_like(y)
    w[2, 1] = 0.0                                   # one masked label
    return y, w


def _pair(mode, X, X_ref, y, w, **kwargs):
    """A JAX model and a port model with the same initial parameters."""
    kw = {**SMALL, 'mode': mode, **kwargs}
    ref = JaxWeaveModel(**kw)
    ref.predict(JaxNumpyDataset(X_ref, y, w))          # builds the params
    model = WeaveModel(device='cpu', **kw)
    params_from_flax(_flatten_params(ref.params), model.module)
    return ref, model


def test_packed_batch_matches_jax(graphs):
    X, X_ref = graphs
    model, ref = WeaveModel(device='cpu', **SMALL), JaxWeaveModel(**SMALL)
    ours = model.compute_features_on_batch(X[:5])
    theirs = ref.compute_features_on_batch(X_ref[:5])
    for a, b in zip(ours, theirs, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    atoms, pairs, amask, pmask = ours
    A = 16                              # the largest (13 atoms), rounded
    assert atoms.shape == (8, A, 75) and pairs.shape == (8, A, A, 14)
    n = int(amask[4].sum())
    assert pmask[4, :n, :n].all() and pmask[4].sum() == n * n


@pytest.mark.parametrize('mode', ['classification', 'regression'])
def test_model_outputs_and_gradients_match_flax(graphs, mode):
    X, X_ref = graphs
    y, w = _labels(mode, len(SMILES))
    ref, model = _pair(mode, X, X_ref, y, w)
    ds = NumpyDataset(X, y, w)
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
    if mode == 'classification':
        assert out[1].shape == (8, N_TASKS, 2)
        assert _scaled(out[1].numpy(), ref_out[1]) <= 1e-5
        out = out[0]
    assert _scaled(out.numpy(), ref_out[0]) <= 1e-5
    loss = model._train_step(t_in, t_lab, t_w)
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
    grads = dict(model.module.named_parameters())
    want = flax_state(_flatten_params(g_ref), model.module)
    # every flax leaf maps onto one parameter, and every parameter has one
    assert len(want) == len(_flatten_params(g_ref)) == len(grads)
    assert set(want) == set(grads)
    for key, g in want.items():
        assert _scaled(grads[key].grad.numpy(), g.numpy()) <= 1e-5, key
        assert grads[key].grad.abs().max() > 0, key


def test_last_layer_has_no_pair_update():
    module = WeaveModel(device='cpu', n_weave=3, **SMALL).module
    assert [layer.update_pair for layer in module.layers] == [
        True, True, False]
    assert not hasattr(module.layers[2], 'pair_out')
    assert WeaveTensorGraph is WeaveModel


def _one_a_sets(graphs):
    """The molecules of at most 16 atoms, whose batches all pack to A 16,
    and the whole set, whose batches pack to A 16 and A 32 (19 atoms)."""
    X, X_ref = graphs
    small = [i for i, g in enumerate(X) if g.num_nodes <= 16]
    return (X[small], X_ref[small]), (X, X_ref)


def test_fit_follows_the_jax_losses(graphs):
    """2 epochs of fit from the same weights on the 19 molecules of at
    most 16 atoms (3 batches of 8, the last short and padded; a loss
    window every 2 steps) on both sides."""
    (X, X_ref), _ = _one_a_sets(graphs)
    y, w = _labels('classification', len(X))
    ref, model = _pair('classification', X, X_ref, y, w,
                       learning_rate=0.003)
    ref_losses, losses = [], []
    ref_last = ref.fit(JaxNumpyDataset(X_ref, y, w), nb_epoch=2,
                       checkpoint_interval=0, all_losses=ref_losses)
    last = model.fit(NumpyDataset(X, y, w), nb_epoch=2,
                     checkpoint_interval=0, all_losses=losses)
    assert len(losses) == len(ref_losses) == 3
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    np.testing.assert_allclose(last, ref_last, rtol=1e-4)
    assert model.get_global_step() == ref.get_global_step() == 6


def test_fit_on_device_on_one_atom_count_follows_jax(graphs):
    (X, X_ref), _ = _one_a_sets(graphs)
    y, w = _labels('regression', len(X))
    ref, model = _pair('regression', X, X_ref, y, w, learning_rate=0.003)
    ref_losses, losses = [], []
    ref.fit_on_device(JaxNumpyDataset(X_ref, y, w), nb_epoch=2, seed=4,
                      all_losses=ref_losses)
    model.fit_on_device(NumpyDataset(X, y, w), nb_epoch=2, seed=4,
                        all_losses=losses)
    assert len(losses) == len(ref_losses) == 2
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)


def test_fit_on_device_on_two_atom_counts_raises_as_jax(graphs):
    """Batches of A 16 and A 32 cannot be stacked: both packages'
    ``fit_on_device`` raise, and both ``fit`` loops take the batches one
    by one."""
    _, (X, X_ref) = _one_a_sets(graphs)
    y, w = _labels('regression', len(X))
    ref, model = _pair('regression', X, X_ref, y, w)
    sizes = {b[0][0].shape[1] for b in model.default_generator(
        NumpyDataset(X, y, w))}
    assert sizes == {16, 32}
    with pytest.raises(ValueError):
        ref.fit_on_device(JaxNumpyDataset(X_ref, y, w), nb_epoch=1)
    with pytest.raises(ValueError):
        model.fit_on_device(NumpyDataset(X, y, w), nb_epoch=1)
    ref_losses, losses = [], []
    ref.fit(JaxNumpyDataset(X_ref, y, w), nb_epoch=1, deterministic=True,
            checkpoint_interval=0, all_losses=ref_losses)
    model.fit(NumpyDataset(X, y, w), nb_epoch=1, deterministic=True,
              checkpoint_interval=0, all_losses=losses)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)


def test_predict_trims_and_refuses_other_widths(graphs):
    X, X_ref = graphs
    y, w = _labels('classification', len(SMILES))
    ref, model = _pair('classification', X, X_ref, y, w)
    pred = model.predict(NumpyDataset(X))
    assert pred.shape == (len(SMILES), N_TASKS, 2)
    assert _scaled(pred, ref.predict(JaxNumpyDataset(X_ref))) <= 1e-5
    with pytest.raises(ValueError, match='75 atom and 14 pair'):
        WeaveModel(device='cpu', n_atom_feat=70, **SMALL).predict(
            NumpyDataset(X[:2]))
