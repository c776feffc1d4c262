"""The port's MXMNet slice against the JAX package's, on the CPU:
``MXMNetFeaturizer``, the packed batch (both edge sets, their CSRs and the
positions), ``PlexLayer`` and ``MXMNetModel``.

Same inputs, SMILES written inline (embedded in 3D by each package's own
conformer code, which agree bit for bit) and numpy arrays from a seed, go
through the JAX function and the port's.  Tolerances: the featurized
arrays and the packed batch equal; the layer's and the model's outputs,
loss and every gradient from the same flax weights within 1e-5 of max(1,
|ref|) (matmuls summed in another order); per-epoch losses of 2-epoch fits
within 1e-4 relative; ``evaluate``'s score within 1e-6.  On the CPU the
kernel wrappers (P2 in the plexes' sums and their gathers' backwards, P3
in the readout) run their plain versions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepchem_tpu.chem import mol_from_smiles as jax_mol_from_smiles
from deepchem_tpu.data import NumpyDataset as JaxNumpyDataset
from deepchem_tpu.metrics import Metric as JaxMetric
from deepchem_tpu.metrics import score_function as jax_scores
from deepchem_tpu.models import mxmnet as jax_mxmnet
from deepchem_tpu.models.jax_model import _flatten_params
from deepchem_tpu_torch import (Metric, MXMNetFeaturizer, MXMNetModel,
                                NumpyDataset, rms_score)
from deepchem_tpu_torch.chem import mol_from_smiles
from deepchem_tpu_torch.models import PlexLayer, params_from_flax
from deepchem_tpu_torch.models.convert import flax_state
from deepchem_tpu_torch.models.mxmnet import rbf
from deepchem_tpu_torch.ops import N_CSR, CooCsr, coo_csr

torch.set_num_threads(1)

SMILES = ['CCO', 'c1ccccc1O', 'C[C@H](N)C(=O)O', 'CC(=O)Oc1ccccc1C(=O)O',
          'N#Cc1ccncc1', 'c1ccsc1', 'FC(F)(F)c1ccc(Cl)cc1Br', 'CC#N',
          'C1CCCCC1', 'C[N+](C)(C)CC(=O)[O-]', 'OCC(O)CO', 'CCCCCCCC',
          'O=C1NC(=O)C(N1)(c1ccccc1)c1ccccc1', 'C']
SMALL = dict(n_tasks=2, dim=8, n_layers=2, batch_size=5, log_frequency=3,
             learning_rate=0.003)


def _scaled(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        1.0, np.abs(np.asarray(b)).max())


@pytest.fixture(scope='module')
def graphs():
    X = MXMNetFeaturizer().featurize(SMILES)
    X_ref = jax_mxmnet.MXMNetFeaturizer().featurize(SMILES)
    y = np.random.RandomState(3).randn(len(X), 2).astype(np.float32)
    return X, X_ref, y


def _assert_graphs_equal(X, X_ref):
    for g, r in zip(X, X_ref, strict=True):
        for attr in ('node_features', 'edge_index', 'node_pos_features',
                     'global_edges'):
            a, b = getattr(g, attr), getattr(r, attr)
            assert a.dtype == b.dtype, attr
            np.testing.assert_array_equal(a, b, err_msg=attr)


def test_featurizer_equals_jax(graphs):
    """The one-hots, the bonds both ways, the positions and the radius
    edges equal; also at a radius and a neighbour cap that cut."""
    X, X_ref, _ = graphs
    _assert_graphs_equal(X, X_ref)
    assert X[0].node_features.shape == (3, 10)
    kw = dict(radius=2.6, max_neighbors=3)
    _assert_graphs_equal(MXMNetFeaturizer(**kw).featurize(SMILES),
                         jax_mxmnet.MXMNetFeaturizer(**kw).featurize(SMILES))


def test_tied_distances_pick_the_jax_neighbours():
    """A square of atoms and its centre, from a given conformer: each
    corner has two neighbours at the side and one at the diagonal, so a
    cap of 2 cuts inside a tie; numpy's argsort picks the same ones on
    both sides, and the conformer's float32 positions are kept."""
    pos = [(0.0, 0.0, 0.0), (1.5, 0.0, 0.0), (1.5, 1.5, 0.0),
           (0.0, 1.5, 0.0), (0.75, 0.75, 0.0)]
    m, mr = mol_from_smiles('CCCCC'), jax_mol_from_smiles('CCCCC')
    m.conformer, mr.conformer = pos, pos
    for cap in (1, 2, 3, 16):
        g = MXMNetFeaturizer(max_neighbors=cap).featurize([m])[0]
        r = jax_mxmnet.MXMNetFeaturizer(max_neighbors=cap).featurize([mr])[0]
        np.testing.assert_array_equal(g.global_edges, r.global_edges)
        np.testing.assert_array_equal(g.node_pos_features,
                                      np.asarray(pos, np.float32))
    assert g.global_edges.shape == (2, 20)


def test_packed_batch_matches_jax(graphs):
    """The JAX package's ten arrays, with the local edges' CSR and the
    global edges' between the global mask and the positions; in the
    uniform mode the global edges' cap is 4 times the local one and a
    batch above it raises, as in JAX."""
    X, X_ref, _ = graphs
    model = MXMNetModel(device='cpu', **SMALL)
    ref = jax_mxmnet.MXMNetModel(**SMALL)
    for caps in (None, (64, 128)):
        model._fixed_caps = ref._fixed_caps = caps
        ours, theirs = model._graph_inputs(X[:5]), ref._graph_inputs(
            X_ref[:5])
        assert len(ours) == 10 + 2 * N_CSR and len(theirs) == 10
        for a, b in zip(ours[:9] + ours[-1:], theirs, strict=True):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        n = len(ours[0])
        for k, (src, dst) in enumerate(((ours[1], ours[2]),
                                        (ours[3], ours[4]))):
            got = ours[9 + k * N_CSR:9 + (k + 1) * N_CSR]
            for a, b in zip(got, coo_csr(src, dst, n), strict=True):
                np.testing.assert_array_equal(a, b)
        ghost = ours[8] == 0
        assert (ours[3][ghost] == n - 1).all() and (ours[4][ghost] == n - 1
                                                    ).all()
    assert len(ours[3]) == 4 * 128
    # a chain of 10 atoms within 50 Å of each other: 18 bond edges, 90
    # radius edges
    chain = ['CCCCCCCCCC']
    long_range = [f(radius=50.0).featurize(chain) for f in (
        MXMNetFeaturizer, jax_mxmnet.MXMNetFeaturizer)]
    model._fixed_caps = ref._fixed_caps = (64, 18)
    for m, xs in zip((model, ref), long_range):
        with pytest.raises(ValueError, match='exceed cap'):
            m._graph_inputs(xs)
    model._fixed_caps = ref._fixed_caps = None


def test_rbf_matches_jax():
    """Within 1e-5, as the layers: ``exp`` of a steep Gaussian (10 d^2)
    moves by a few ulps of its argument between XLA and torch."""
    d = np.random.RandomState(0).rand(40).astype(np.float32) * 6
    ours = rbf(torch.from_numpy(d))
    ref = jax_mxmnet._rbf(jnp.asarray(d))
    assert ours.shape == (40, 16)
    assert _scaled(ours.numpy(), ref) <= 1e-5


def test_plex_layer_matches_flax(graphs):
    """One plex on a packed batch's global edges from flax's initial
    weights: output and the gradients of h, the distances' path and
    every weight within 1e-5 of max(1, |ref|)."""
    X = graphs[0]
    model = MXMNetModel(device='cpu', **SMALL)
    arrays = model._graph_inputs(X[:5])
    src, dst, emask = arrays[3], arrays[4], arrays[8]
    csr = CooCsr(*(torch.from_numpy(a)
                   for a in arrays[9 + N_CSR:9 + 2 * N_CSR]))
    rng = np.random.RandomState(2)
    h = rng.randn(len(arrays[0]), 8).astype(np.float32)
    dist = (rng.rand(len(src)) * 5).astype(np.float32)
    g = rng.randn(*h.shape).astype(np.float32)
    flax_layer = jax_mxmnet._PlexLayer(8)
    j_in = [jnp.asarray(x) for x in (h, src, dst, dist, emask)]
    params = flax_layer.init(jax.random.PRNGKey(0), *j_in)

    def f(p, hh):
        return flax_layer.apply(p, hh, *j_in[1:])
    out_ref, vjp = jax.vjp(f, params, j_in[0])
    gp, gh = vjp(jnp.asarray(g))
    layer = PlexLayer(8)
    params_from_flax(_flatten_params(params), layer)
    th = torch.from_numpy(h).requires_grad_(True)
    out = layer(th, torch.from_numpy(src).long(),
                torch.from_numpy(dst).long(), torch.from_numpy(dist),
                torch.from_numpy(emask), csr)
    (out * torch.from_numpy(g)).sum().backward()
    assert _scaled(out.detach().numpy(), out_ref) <= 1e-5
    assert _scaled(th.grad.numpy(), gh) <= 1e-5
    grads = dict(layer.named_parameters())
    for key, v in flax_state(_flatten_params(gp), layer).items():
        assert _scaled(grads[key].grad.numpy(), v.numpy()) <= 1e-5, key


_REF = []


def _pair(data, **kw):
    """A JAX model and a port model with the same initial parameters (the
    JAX model built once, then redrawn by ``reinitialize``), and their
    datasets: three batches of 5, the last short."""
    X, X_ref, y = data
    kw = dict(SMALL, **kw)
    ds_ref = JaxNumpyDataset(X_ref, y)
    if not _REF or _REF[0][1] != kw:
        ref = jax_mxmnet.MXMNetModel(**kw)
        ref.predict(ds_ref)                            # builds the params
        _REF[:] = [(ref, kw)]
    else:
        ref = _REF[0][0]
        ref.reinitialize()
    model = MXMNetModel(device='cpu', **kw)
    params_from_flax(_flatten_params(ref.params), model.module)
    return ref, model, ds_ref, NumpyDataset(X, y)


def test_outputs_and_gradients_match_flax(graphs):
    """The first batch from the same flax weights: outputs, loss and
    every gradient within 1e-5 of max(1, |ref|); every flax leaf mapped
    onto exactly one parameter, each gradient non-zero."""
    ref, model, _, ds = _pair(graphs)
    inputs, labels, weights = next(model.default_generator(ds))
    j_in = [jnp.asarray(a) for a in inputs[:9] + inputs[-1:]]

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
    assert out.shape == (5, 2)
    assert _scaled(out.numpy(), ref_out[0]) <= 1e-5
    loss = model._train_step(t_in, t_lab, t_w)
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
    grads = dict(model.module.named_parameters())
    flat = _flatten_params(g_ref)
    want = flax_state(flat, model.module)
    assert len(want) == len(flat) == len(grads)
    for key, g in want.items():
        assert _scaled(grads[key].grad.numpy(), g.numpy()) <= 1e-5, key
        assert grads[key].grad.abs().max() > 0, key


@pytest.mark.parametrize('loop', ['fit', 'fit_on_device'])
def test_fits_as_jax(graphs, loop):
    """2 epochs from the same weights: the per-epoch losses within 1e-4
    relative."""
    ref, model, ds_ref, ds = _pair(graphs)
    ref_losses, losses = [], []
    for m, d, out in ((ref, ds_ref, ref_losses), (model, ds, losses)):
        if loop == 'fit':
            m.fit(d, nb_epoch=2, checkpoint_interval=0, all_losses=out)
        else:
            m.fit_on_device(d, nb_epoch=2, seed=1, all_losses=out)
    assert len(losses) == len(ref_losses) == 2
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)


def test_evaluate_matches_jax(graphs):
    ref, model, ds_ref, ds = _pair(graphs)
    pred, ref_pred = model.predict(ds), ref.predict(ds_ref)
    assert pred.shape == (len(SMILES), 2)
    assert _scaled(pred, ref_pred) <= 1e-5
    score = model.evaluate(ds, [Metric(rms_score)])['rms_score']
    ref_score = ref.evaluate(ds_ref, [JaxMetric(jax_scores.rms_score)])
    np.testing.assert_allclose(score, ref_score['rms_score'], atol=1e-6)


def test_entry_points_need_a_device():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MXMNetModel()
