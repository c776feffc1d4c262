"""The port's InfoMax3D slice against the JAX package's, on the CPU:
``RDKitConformerFeaturizer``, the positions in the packed batch,
``fourier_encode_dist``, ``Net3DLayer``, the 2D and 3D encoders,
``ntxent_loss`` and ``InfoMax3DModular`` (pretraining, regression,
classification, and fine-tuning from a pretrained model).

Same inputs, SMILES written inline and numpy arrays from a seed, go
through the JAX function and the port's.  Tolerances: the graphs and
positions equal (the same numpy operations in the same order); the packed
batch equal; ``fourier_encode_dist`` and ``ntxent_loss`` (value and
gradients) within 1e-6; the layer's and each model's outputs, loss and
every gradient from the same flax weights within 1e-5 of max(1, |ref|)
(matmuls summed in another order); per-epoch losses of 2-epoch fits within
1e-4 relative.  On the CPU the kernel wrappers (P2 in the sums and the 3D
gathers' backwards, K3 in the 2D encoder's max and min, P3 in the
readouts) run their plain versions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepchem_tpu.data import NumpyDataset as JaxNumpyDataset
from deepchem_tpu.feat import conformer_featurizers as jax_conformer
from deepchem_tpu.models import gnn3d as jax_gnn3d
from deepchem_tpu.models.jax_model import _flatten_params
from deepchem_tpu_torch import (InfoMax3DModular, MolGraphConvFeaturizer,
                                NumpyDataset, RDKitConformerFeaturizer)
from deepchem_tpu_torch.chem import mol_from_smiles
from deepchem_tpu_torch.models import (Net3DLayer, fourier_encode_dist,
                                       ntxent_loss, params_from_flax)
from deepchem_tpu_torch.models.convert import flax_state
from deepchem_tpu_torch.ops import N_CSR, CooCsr, coo_csr

torch.set_num_threads(1)

# rings, aromatics, charges, stereo marks, a single atom, two fragments
SMILES = ['CCO', 'c1ccccc1O', 'C[C@H](N)C(=O)O', '[NH4+]', 'C',
          'C/C=C/C', 'CC(=O)Oc1ccccc1C(=O)O', 'N#Cc1ccncc1',
          'c1ccsc1', 'FC(F)(F)c1ccc(Cl)cc1Br', 'O', 'CC#N', 'C1CCCCC1',
          'C[N+](C)(C)CC(=O)[O-]']
# two atoms and no bond: both packages embed it in 2 coordinates a row,
# so its graph cannot join a batch of 3D ones
SALT = '[Na+].[Cl-]'
SMALL = dict(hidden_dim=8, num_layers=2, batch_size=6, log_frequency=3,
             learning_rate=0.003)


def _scaled(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        1.0, np.abs(np.asarray(b)).max())


@pytest.fixture(scope='module')
def graphs():
    X = RDKitConformerFeaturizer().featurize(SMILES)
    X_ref = jax_conformer.RDKitConformerFeaturizer().featurize(SMILES)
    y = np.random.RandomState(3).randn(len(X), 2).astype(np.float32)
    return X, X_ref, y


def test_conformer_featurizer_equals_jax(graphs):
    """The MolGraphConv graph with bond features, and the positions; with
    ``num_conformers`` 2 the positions are stacked twice, as in JAX."""
    X, X_ref, _ = graphs
    for smi, g, r in zip(SMILES, X, X_ref, strict=True):
        for attr in ('node_features', 'edge_index', 'edge_features',
                     'node_pos_features'):
            a, b = getattr(g, attr), getattr(r, attr)
            assert a.dtype == b.dtype, (smi, attr)
            np.testing.assert_array_equal(a, b, err_msg=f'{smi} {attr}')
        plain = MolGraphConvFeaturizer(use_edges=True).featurize([smi])[0]
        np.testing.assert_array_equal(g.node_features, plain.node_features)
        assert g.node_pos_features.shape == (g.num_nodes, 3)
    two = RDKitConformerFeaturizer(num_conformers=2).featurize(SMILES[:3])
    ref = jax_conformer.RDKitConformerFeaturizer(
        num_conformers=2).featurize(SMILES[:3])
    for g, r in zip(two, ref, strict=True):
        np.testing.assert_array_equal(g.node_pos_features,
                                      r.node_pos_features)
        assert len(g.node_pos_features) == 2 * g.num_nodes
    salt, salt_ref = (f().featurize([SALT])[0] for f in (
        RDKitConformerFeaturizer, jax_conformer.RDKitConformerFeaturizer))
    np.testing.assert_array_equal(salt.node_pos_features,
                                  salt_ref.node_pos_features)
    assert salt.node_pos_features.shape == (2, 2)
    ours = RDKitConformerFeaturizer()
    theirs = jax_conformer.RDKitConformerFeaturizer()
    from deepchem_tpu.chem import mol_from_smiles as jax_mol_from_smiles
    for smi in SMILES + [SALT]:
        m, mr = mol_from_smiles(smi), jax_mol_from_smiles(smi)
        assert [ours.atom_to_feature_vector(a) for a in m.atoms] == \
            [theirs.atom_to_feature_vector(a) for a in mr.atoms]
        assert [ours.bond_to_feature_vector(b) for b in m.bonds] == \
            [theirs.bond_to_feature_vector(b) for b in mr.bonds]


def test_a_given_conformer_is_kept():
    m = mol_from_smiles('CCO')
    m.conformer = [(0.0, 0.0, 0.0), (1.5, 0.0, 0.0), (2.0, 1.4, 0.0)]
    g = RDKitConformerFeaturizer().featurize([m])[0]
    np.testing.assert_array_equal(g.node_pos_features,
                                  np.asarray(m.conformer, np.float32))


def test_packed_batch_matches_jax(graphs):
    """The JAX package's arrays, with the CSR of the edges between the
    edge mask and the positions (zero on pad rows); a graph without
    positions raises, as in JAX."""
    X, X_ref, _ = graphs
    model = InfoMax3DModular(device='cpu', **SMALL)
    ref = jax_gnn3d.InfoMax3DModular(**SMALL)
    ours, theirs = model._graph_inputs(X[:5]), ref._graph_inputs(X_ref[:5])
    assert len(ours) == 6 + N_CSR + 1 and len(theirs) == 7
    for a, b in zip(ours[:6] + ours[-1:], theirs, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ours[6:6 + N_CSR], coo_csr(ours[1], ours[2],
                                               len(ours[0]))):
        np.testing.assert_array_equal(a, b)
    n = sum(g.num_nodes for g in X[:5])
    assert ours[-1].shape == (len(ours[0]), 3) and not ours[-1][n:].any()
    flat = MolGraphConvFeaturizer(use_edges=True).featurize(SMILES[:2])
    with pytest.raises(ValueError, match='positions'):
        model._graph_inputs(flat)
    with pytest.raises(ValueError, match='positions'):
        ref._graph_inputs(flat)


def test_fourier_encode_dist_matches_jax():
    d = np.random.RandomState(0).rand(7, 5).astype(np.float32) * 9
    for k, self_ in ((4, True), (2, False)):
        ours = fourier_encode_dist(torch.from_numpy(d), k, self_)
        ref = jax_gnn3d.fourier_encode_dist(jnp.asarray(d), k, self_)
        assert ours.shape == ref.shape == (7, 5, 2 * k + self_)
        assert _scaled(ours.numpy(), ref) <= 1e-6


def test_ntxent_loss_matches_jax():
    """Value and both gradients at two temperatures; with a zero row among
    the embeddings (its norm clamped at 1e-7) the value is finite and the
    gradients NaN where JAX's are."""
    rng = np.random.RandomState(1)
    a, b = (rng.randn(6, 8).astype(np.float32) for _ in range(2))
    zero = a.copy()
    zero[2] = 0.0
    for a, t in ((a, 0.1), (a, 0.5), (zero, 0.1)):
        ta, tb = (torch.from_numpy(x).requires_grad_(True) for x in (a, b))
        loss = ntxent_loss(ta, tb, t)
        loss.backward()
        ref, (ga, gb) = jax.value_and_grad(
            lambda x, y: jax_gnn3d.ntxent_loss(x, y, t), argnums=(0, 1))(
                jnp.asarray(a), jnp.asarray(b))
        assert abs(loss.item() - float(ref)) <= 1e-6 * max(1.0, abs(ref))
        for ours, theirs in ((ta.grad.numpy(), ga), (tb.grad.numpy(), gb)):
            theirs = np.asarray(theirs)
            np.testing.assert_array_equal(np.isnan(ours), np.isnan(theirs))
            ok = ~np.isnan(theirs)
            assert not ok.any() or _scaled(ours[ok], theirs[ok]) <= 1e-6
    assert np.isnan(ta.grad.numpy()[2]).all()


def test_net3d_layer_matches_flax(graphs):
    """One layer on a packed batch from flax's initial weights: output and
    the gradients of h, the edge features and every weight within 1e-5 of
    max(1, |ref|); flax numbers the message MLP's outer layer Dense_0."""
    X = graphs[0]
    model = InfoMax3DModular(device='cpu', **SMALL)
    arrays = model._graph_inputs(X[:6])
    esrc, edst, emask = (arrays[i] for i in (1, 2, 5))
    csr = CooCsr(*(torch.from_numpy(a) for a in arrays[6:6 + N_CSR]))
    rng = np.random.RandomState(2)
    h = rng.randn(len(arrays[0]), 8).astype(np.float32)
    ef = rng.randn(len(esrc), 8).astype(np.float32)
    g = rng.randn(*h.shape).astype(np.float32)
    flax_layer = jax_gnn3d.Net3DLayer(8)
    j_in = [jnp.asarray(x) for x in (h, ef, esrc, edst, emask)]
    params = flax_layer.init(jax.random.PRNGKey(0), *j_in)

    def f(p, hh, ee):
        return flax_layer.apply(p, hh, ee, *j_in[2:])
    out_ref, vjp = jax.vjp(f, params, j_in[0], j_in[1])
    gp, gh, ge = vjp(jnp.asarray(g))
    layer = Net3DLayer(8)
    params_from_flax(_flatten_params(params), layer)
    th, te = (torch.from_numpy(x).requires_grad_(True) for x in (h, ef))
    out = layer(th, te, torch.from_numpy(esrc).long(),
                torch.from_numpy(edst).long(), torch.from_numpy(emask), csr)
    (out * torch.from_numpy(g)).sum().backward()
    assert _scaled(out.detach().numpy(), out_ref) <= 1e-5
    assert _scaled(th.grad.numpy(), gh) <= 1e-5
    assert _scaled(te.grad.numpy(), ge) <= 1e-5
    grads = dict(layer.named_parameters())
    for key, v in flax_state(_flatten_params(gp), layer).items():
        assert _scaled(grads[key].grad.numpy(), v.numpy()) <= 1e-5, key


# JAX models by task, built once: a later test redraws their parameters
# with ``reinitialize``, which keeps the compiled executables
_REFS = {}


def _pair(task, data):
    """A JAX model and a port model of ``task`` with the same initial
    parameters, and their datasets: three batches of 6, the last short
    (classification labels 0/1); for pretraining two full batches, since
    the port leaves a short batch's padding slots out of the loss where
    the JAX package counts them."""
    X, X_ref, y = data
    if task == 'pretrain':
        X, X_ref, y = X[:12], X_ref[:12], y[:12]
    if task == 'classification':
        y = (y > 0).astype(np.float32)
    kw = dict(SMALL, task=task, n_tasks=2)
    ds_ref = JaxNumpyDataset(X_ref, y)
    ref = _REFS.get(task)
    if ref is None:
        ref = _REFS[task] = jax_gnn3d.InfoMax3DModular(**kw)
        ref.predict(ds_ref)                            # builds the params
    else:
        ref.reinitialize()
    model = InfoMax3DModular(device='cpu', **kw)
    params_from_flax(_flatten_params(ref.params), model.module)
    return ref, model, ds_ref, NumpyDataset(X, y)


@pytest.mark.parametrize('task', ['pretrain', 'regression',
                                  'classification'])
def test_outputs_and_gradients_match_flax(graphs, task):
    """The first batch from the same flax weights: the 2D and 3D
    embeddings (pretraining) or the heads' outputs, the loss and every
    gradient within 1e-5 of max(1, |ref|); every flax leaf mapped onto
    exactly one parameter.  The JAX batch is the port's without the CSR
    arrays."""
    ref, model, _, ds = _pair(task, graphs)
    inputs, labels, weights = next(model.default_generator(ds))
    j_in = [jnp.asarray(a) for a in inputs[:6] + inputs[-1:]]

    def loss_fn(p):
        outputs = ref._forward(p, j_in, training=False, rng=None)
        return ref._compute_loss(outputs, [jnp.asarray(labels[0])],
                                 [jnp.asarray(weights[0])]), outputs
    (loss_ref, ref_out), g_ref = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(ref.params)
    t_in, t_lab, t_w = model._prepare_batch((inputs, labels, weights))
    model.module.eval()
    with torch.no_grad():
        out = model.module(*t_in)
    outs = out if isinstance(out, tuple) else (out,)
    assert len(outs) == len(ref_out)
    for o, r in zip(outs, ref_out, strict=True):
        assert _scaled(o.numpy(), r) <= 1e-5
    loss = model._train_step(t_in, t_lab, t_w)
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
    grads = dict(model.module.named_parameters())
    flat = _flatten_params(g_ref)
    want = flax_state(flat, model.module)
    assert len(want) == len(flat) == len(grads)
    assert set(want) == set(grads)
    for key, g in want.items():
        assert _scaled(grads[key].grad.numpy(), g.numpy()) <= 1e-5, key
        assert grads[key].grad.abs().max() > 0, key
    assert set(model.components) == (
        {'encoder2d', 'encoder3d'} if task == 'pretrain'
        else {'encoder2d', 'hidden', 'head'})


@pytest.mark.parametrize('task,loop', [('pretrain', 'fit'),
                                       ('pretrain', 'fit_on_device'),
                                       ('regression', 'fit')])
def test_fits_as_jax(graphs, task, loop):
    """2 epochs of ``fit`` or ``fit_on_device`` from the same weights, the
    losses finite."""
    ref, model, ds_ref, ds = _pair(task, graphs)
    ref_losses, losses = [], []
    for m, d, out in ((ref, ds_ref, ref_losses), (model, ds, losses)):
        if loop == 'fit':
            m.fit(d, nb_epoch=2, checkpoint_interval=0, all_losses=out)
        else:
            m.fit_on_device(d, nb_epoch=2, seed=1, all_losses=out)
    assert len(losses) == len(ref_losses) == 2
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)


def test_pretrain_then_finetune_as_jax(graphs):
    """Pretrain 2 epochs, carry the 2D encoder into a regression model by
    ``load_from_pretrained`` (every encoder2d tensor, nothing else), then
    fine-tune 2 epochs: each side's losses within 1e-4 relative, and the
    2D embeddings after pretraining within 1e-4 of max(1, |ref|)."""
    pre, pre_model, ds_ref, ds = _pair('pretrain', graphs)
    fine, fine_model, _, _ = _pair('regression', graphs)
    for m, d in ((pre, ds_ref), (pre_model, ds)):
        m.fit(d, nb_epoch=2, checkpoint_interval=0)
    emb = pre_model.predict_embeddings(ds)
    emb_ref = pre.predict_embeddings(ds_ref)
    assert emb.shape == (12, 8)
    assert _scaled(emb, emb_ref) <= 1e-4
    before = {k: v.clone() for k, v in
              fine_model.module.state_dict().items()}
    fine_model.load_from_pretrained(pre_model)
    fine.load_from_pretrained(pre)
    after = fine_model.module.state_dict()
    changed = {k for k in after if not torch.equal(after[k], before[k])}
    assert changed == {k for k in after if k.startswith('encoder2d.')}
    losses, ref_losses = [], []
    for m, d, out in ((fine, ds_ref, ref_losses), (fine_model, ds, losses)):
        m.fit(d, nb_epoch=2, checkpoint_interval=0, all_losses=out)
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)


def test_pretraining_leaves_padding_slots_out(graphs):
    """A short batch (2 molecules, 4 padding slots): the port's loss is
    JAX's ``ntxent_loss`` over the 2 real rows' embeddings (within 1e-6),
    and every gradient is finite, at the initial weights too, where JAX's
    loss over all 6 rows has NaN gradients (the padding slots' embeddings
    are zero there)."""
    X, X_ref, y = graphs
    ref, model, _, _ = _pair('pretrain', graphs)
    ds = NumpyDataset(X[:2], y[:2])
    inputs, labels, weights = next(model.default_generator(ds))
    t_in, t_lab, t_w = model._prepare_batch((inputs, labels, weights))
    model.module.eval()
    with torch.no_grad():
        e2d, e3d = model.module(*t_in)
    assert not e2d[2:].any() and not e3d[2:].any()     # zero at init
    loss = model._train_step(t_in, t_lab, t_w)
    want = jax_gnn3d.ntxent_loss(jnp.asarray(e2d[:2].numpy()),
                                 jnp.asarray(e3d[:2].numpy()))
    assert abs(loss.item() - float(want)) <= 1e-6 * max(1.0, abs(want))
    for name, p in model.module.named_parameters():
        assert torch.isfinite(p.grad).all(), name
    j_in = [jnp.asarray(a) for a in inputs[:6] + inputs[-1:]]

    def loss_fn(p):
        outputs = ref._forward(p, j_in, training=False, rng=None)
        return ref._compute_loss(outputs, [], [])
    g_ref = jax.jit(jax.grad(loss_fn))(ref.params)
    assert np.isnan(np.concatenate([np.ravel(v) for v in
                                    _flatten_params(g_ref).values()])).any()


def test_entry_points_need_a_device():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InfoMax3DModular()
