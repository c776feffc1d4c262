"""The port's materials slice against the JAX package's, on the CPU: the
crystal featurizers (``periodic_neighbors``, ``CGCNNFeaturizer``,
``LCNNFeaturizer``), the composition featurizers
(``ElementPropertyFingerprint``, ``ElemNetFeaturizer``,
``SineCoulombMatrix``), and ``CGCNNModel``, ``LCNNModel``, ``MEGNetModel``
and ``ElemNetModel``.

Same inputs, crystal structures written inline as dicts and numpy arrays
from a seed, go through the JAX function and the port's.  Tolerances: the
element tables, edge lists, node features and composition features equal,
edge features within 1e-6 (the same numpy operations in the same order);
the packed batch equal; the edges-into-graphs sum and its gradient within
1e-6; each model's outputs, loss and every gradient from the same flax
weights within 1e-5 of max(1, |ref|) (matmuls summed in another order),
MEGNet's global state on all ``num_graphs + 1`` rows; per-epoch losses of
2-epoch fits within 1e-4 relative.  On the CPU the kernel wrappers (P2 in
the gathers' backwards and the edge sums, P3 in the readouts) run their
plain versions.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepchem_tpu.chem import mol as jax_mol
from deepchem_tpu.data import NumpyDataset as JaxNumpyDataset
from deepchem_tpu.feat import crystal_featurizers as jax_crystal
from deepchem_tpu.feat import material_featurizers as jax_material
from deepchem_tpu.models import material_models as jax_models
from deepchem_tpu.models.jax_model import _flatten_params
from deepchem_tpu.ops import segment_sum as jax_segment_sum
from deepchem_tpu_torch import (CGCNNFeaturizer, CGCNNModel,
                                ElementPropertyFingerprint,
                                ElemNetFeaturizer, ElemNetModel,
                                LCNNFeaturizer, LCNNModel, MEGNetModel,
                                NumpyDataset, SineCoulombMatrix)
from deepchem_tpu_torch.chem import mol as port_mol
from deepchem_tpu_torch.feat import crystal_featurizers, material_featurizers
from deepchem_tpu_torch.models import params_from_flax
from deepchem_tpu_torch.models.convert import flax_state
from deepchem_tpu_torch.ops import (N_CSR, CooCsr, coo_csr, csr_row_ptr,
                                    csr_segment_sum, dst_segment_sum,
                                    graph_edge_row_ptr)

torch.set_num_threads(1)


def _cubic(a, species, frac):
    return {'lattice': np.eye(3) * a, 'species': list(species),
            'frac_coords': np.asarray(frac, dtype=float)}


FCC = [(0, 0, 0), (0, .5, .5), (.5, 0, .5), (.5, .5, 0)]
# cubic cells, where every neighbour shell is a tie, and two that are not
CRYSTALS = {
    'nacl': _cubic(5.64, ['Na'] * 4 + ['Cl'] * 4,
                   FCC + [(.5, 0, 0), (0, .5, 0), (0, 0, .5), (.5, .5, .5)]),
    'cscl': _cubic(4.12, ['Cs', 'Cl'], [(0, 0, 0), (.5, .5, .5)]),
    'cu': _cubic(3.615, ['Cu'] * 4, FCC),
    'fe': _cubic(2.87, ['Fe'] * 2, [(0, 0, 0), (.5, .5, .5)]),
    'srtio3': _cubic(3.905, ['Sr', 'Ti', 'O', 'O', 'O'],
                     [(0, 0, 0), (.5, .5, .5), (.5, .5, 0), (.5, 0, .5),
                      (0, .5, .5)]),
    'tio2': {'lattice': np.diag([4.594, 4.594, 2.959]),
             'species': ['Ti', 'Ti', 'O', 'O', 'O', 'O'],
             'frac_coords': np.array(
                 [(0, 0, 0), (.5, .5, .5), (.305, .305, 0),
                  (.695, .695, 0), (.805, .195, .5), (.195, .805, .5)])},
    'zno': {'lattice': np.array([[3.25, 0, 0],
                                 [-1.625, 3.25 * np.sqrt(3) / 2, 0],
                                 [0, 0, 5.21]]),
            'species': ['Zn', 'Zn', 'O', 'O'],
            'frac_coords': np.array([(1 / 3, 2 / 3, 0), (2 / 3, 1 / 3, .5),
                                     (1 / 3, 2 / 3, .382),
                                     (2 / 3, 1 / 3, .882)])},
}
# random cells of 2 to 4 atoms, as the JAX package's CGCNN test draws them
_rng = np.random.RandomState(0)
RANDOM = [{'lattice': np.eye(3) * 4.0 + _rng.rand(3, 3) * 0.3,
           'frac_coords': _rng.rand(n, 3),
           'species': [['Na', 'Cl', 'Mg', 'O'][j % 4] for j in range(n)]}
          for n in _rng.randint(2, 5, 12)]
STRUCTS = list(CRYSTALS.values()) + RANDOM
FORMULAS = ['Fe2O3', 'NaCl', 'CsCl', 'Cs', 'SrTiO3', 'Mg0.5Fe0.5O',
            'Al2 O3', 'TiO2', 'GaAs', 'Fr', 'Xx2O']


def _scaled(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        1.0, np.abs(np.asarray(b)).max())


def test_element_tables_equal_jax():
    for name in ('PERIODIC_TABLE', 'ATOMIC_SYMBOL', 'ATOMIC_MASS'):
        assert getattr(port_mol, name) == getattr(jax_mol, name), name
    assert material_featurizers._ELEM_PROPS == jax_material._ELEM_PROPS


@pytest.mark.parametrize('radius,k', [(8.0, 12), (4.0, 8), (3.0, 3),
                                      (6.0, 4)])
def test_periodic_neighbors_equal_jax(radius, k):
    """Edge lists and distances equal, ties included: fcc Cu's first shell
    holds 12 equal distances, so at 8 or 3 neighbours the cut falls inside
    a tie and ``np.argsort``'s order picks the neighbours."""
    for s in STRUCTS:
        lat, frac, _ = crystal_featurizers._structure_arrays(s)
        ours = crystal_featurizers.periodic_neighbors(lat, frac, radius, k)
        ref = jax_crystal.periodic_neighbors(lat, frac, radius, k)
        for a, b in zip(ours, ref, strict=True):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    lat, frac, _ = crystal_featurizers._structure_arrays(CRYSTALS['cu'])
    src, dst, d = crystal_featurizers.periodic_neighbors(lat, frac, 4.0, 8)
    first = d[dst == 0]
    assert len(first) == 8 and np.ptp(first) == 0      # a cut inside a tie


@pytest.mark.parametrize('ours,ref', [
    (CGCNNFeaturizer(), jax_crystal.CGCNNFeaturizer()),
    (CGCNNFeaturizer(radius=4.0, max_neighbors=8),
     jax_crystal.CGCNNFeaturizer(radius=4.0, max_neighbors=8)),
    (LCNNFeaturizer(), jax_crystal.LCNNFeaturizer()),
    (LCNNFeaturizer(cutoff=3.0, max_neighbors=3, n_occupancy=2),
     jax_crystal.LCNNFeaturizer(cutoff=3.0, max_neighbors=3,
                                n_occupancy=2))])
def test_crystal_featurizers_equal_jax(ours, ref):
    structs = STRUCTS + [dict(CRYSTALS['nacl'], occupancy=[0, 1, 2, 3] * 2)]
    for g, r in zip(ours.featurize(structs), ref.featurize(structs),
                    strict=True):
        np.testing.assert_array_equal(g.node_features, r.node_features)
        np.testing.assert_array_equal(g.edge_index, r.edge_index)
        assert g.edge_features.dtype == r.edge_features.dtype
        np.testing.assert_allclose(g.edge_features, r.edge_features,
                                   rtol=0, atol=1e-6)
    if isinstance(ours, CGCNNFeaturizer):
        np.testing.assert_array_equal(ours.centers, ref.centers)
        if ours.radius == 8.0:
            assert len(ours.centers) == 41


def test_structure_objects_read_as_dicts():
    """An object with ``lattice.matrix``, ``frac_coords`` and species with
    ``Z`` (a pymatgen ``Structure``'s attributes) featurizes as its dict."""
    s = CRYSTALS['srtio3']
    obj = types.SimpleNamespace(
        lattice=types.SimpleNamespace(matrix=s['lattice']),
        frac_coords=s['frac_coords'],
        species=[types.SimpleNamespace(Z=port_mol.PERIODIC_TABLE[e])
                 for e in s['species']])
    for feat in (CGCNNFeaturizer(), SineCoulombMatrix(max_atoms=8)):
        a, b = feat.featurize([obj])[0], feat.featurize([s])[0]
        if isinstance(feat, CGCNNFeaturizer):
            np.testing.assert_array_equal(a.edge_features, b.edge_features)
        else:
            np.testing.assert_array_equal(a, b)


def test_composition_featurizers_equal_jax():
    """Cs has no row of ``_ELEM_PROPS`` (its columns drop it; alone, its
    columns are zeros); Fr lies past ElemNet's 86 elements; 'Xx2O' has an
    unknown symbol."""
    for formula in FORMULAS:
        assert material_featurizers.parse_composition(formula) == \
            jax_material.parse_composition(formula)
    cases = [(ElementPropertyFingerprint(),
              jax_material.ElementPropertyFingerprint(), FORMULAS),
             (ElemNetFeaturizer(), jax_material.ElemNetFeaturizer(),
              FORMULAS),
             (SineCoulombMatrix(max_atoms=70),
              jax_material.SineCoulombMatrix(max_atoms=70), STRUCTS),
             (SineCoulombMatrix(max_atoms=8, flatten=False),
              jax_material.SineCoulombMatrix(max_atoms=8, flatten=False),
              STRUCTS)]
    for ours, ref, data in cases:
        a, b = ours.featurize(data), ref.featurize(data)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    fp = ElementPropertyFingerprint().featurize(['Cs', 'CsCl'])
    assert fp.shape == (2, 30)
    assert (fp[0, 5:] == 0).all() and (fp[1, 5:10] != 0).any()
    assert ElementPropertyFingerprint().featurize(['Xx'])[0].size == 0
    feat, ref = ElemNetFeaturizer(), jax_material.ElemNetFeaturizer()
    for comp in ({'Fe': 2, 'O': 3}, {26: 1.0, 8: 1.5}, {'Fr': 1},
                 {'Qq': 1}, {}):
        a, b = feat.get_vector(comp), ref.get_vector(comp)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope='module')
def crystal_graphs():
    structs = STRUCTS[:15]
    y = np.random.RandomState(3).randn(len(structs), 2).astype(np.float32)
    return (CGCNNFeaturizer().featurize(structs),
            jax_crystal.CGCNNFeaturizer().featurize(structs),
            LCNNFeaturizer().featurize(structs),
            jax_crystal.LCNNFeaturizer().featurize(structs), y)


def test_packed_batch_matches_jax(crystal_graphs):
    """The JAX package's arrays, with the CSR of the edges between the
    edge mask and the edge features."""
    X, X_ref = crystal_graphs[:2]
    model = CGCNNModel(n_tasks=2, batch_size=6, device='cpu')
    ref = jax_models.CGCNNModel(n_tasks=2, batch_size=6,
                                data_parallel=False)
    ours, theirs = model._graph_inputs(X[:5]), ref._graph_inputs(X_ref[:5])
    assert len(ours) == 6 + N_CSR + 1 and len(theirs) == 7
    for a, b in zip(ours[:6] + ours[-1:], theirs, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ours[6:6 + N_CSR], coo_csr(ours[1], ours[2],
                                               len(ours[0]))):
        np.testing.assert_array_equal(a, b)


def test_edges_into_graphs_sum_matches_jax(crystal_graphs):
    """MEGNet's ``segment_sum(e, graph_index[edge_dst], G + 1)`` and its
    edge count ``segment_sum(edge_mask, ...)``: P2 into the nodes, then P3
    over the nodes' sums by graph (their gradients gathers); counts from
    the CSR's row pointers."""
    X = crystal_graphs[0]
    model = MEGNetModel(batch_size=6, device='cpu')
    arrays = model._graph_inputs(X[:5])
    nf, esrc, edst, gidx, nmask, emask = (torch.from_numpy(a)
                                          for a in arrays[:6])
    csr = CooCsr(*(torch.from_numpy(a) for a in arrays[6:6 + N_CSR]))
    G = 6 + 1
    egidx = gidx.long()[edst.long()]
    e = torch.from_numpy(np.random.RandomState(0).randn(
        len(edst), 5).astype(np.float32)) * emask[:, None]
    e.requires_grad_(True)
    rp = csr_row_ptr(gidx, G)
    out = csr_segment_sum(dst_segment_sum(e, edst.long(), csr), rp)
    g = torch.from_numpy(np.random.RandomState(1).randn(G, 5).astype(
        np.float32))
    (out * g).sum().backward()

    def f(x):
        return jax_segment_sum(x, jnp.asarray(egidx.numpy()), G)
    ref, vjp = jax.vjp(f, jnp.asarray(e.detach().numpy()))
    assert _scaled(out.detach().numpy(), ref) <= 1e-6
    assert _scaled(e.grad.numpy(), vjp(jnp.asarray(g.numpy()))[0]) <= 1e-6
    real = graph_edge_row_ptr(csr, rp)
    counts = jax_segment_sum(jnp.asarray(emask.numpy()),
                             jnp.asarray(egidx.numpy()), G)
    np.testing.assert_array_equal((real[1:] - real[:-1]).numpy(), counts)
    assert int(counts[-1]) == 0 and int(counts[:5].min()) > 0


SMALL = {'cgcnn': dict(atom_fea_len=8, n_conv=2, h_fea_len=16),
         'lcnn': {}, 'megnet': dict(dim=8, n_blocks=2)}


# JAX models by (name, mode), built once: a later test redraws their
# parameters with ``reinitialize``, which keeps the compiled executables
_REFS = {}


def _pair(name, data, mode='regression'):
    """A JAX model and a port model with the same initial parameters, and
    their datasets (six-graph batches, the last short), at learning rate
    0.003."""
    X, X_ref, Xl, Xl_ref, y = data
    if name == 'elemnet':
        X = X_ref = ElemNetFeaturizer().featurize(FORMULAS * 2)
        y = np.random.RandomState(4).randn(len(X), 1).astype(np.float32)
        kw = dict(batch_size=8, log_frequency=3, learning_rate=0.003)
        classes = (ElemNetModel, jax_models.ElemNetModel)
    else:
        if name == 'lcnn':
            X, X_ref = Xl, Xl_ref
        if mode == 'classification':
            y = (y > 0).astype(np.float32)
        kw = dict(SMALL[name], batch_size=6, n_tasks=2, log_frequency=3,
                  learning_rate=0.003, data_parallel=False)
        if name != 'lcnn':
            kw['mode'] = mode
        classes = {'cgcnn': (CGCNNModel, jax_models.CGCNNModel),
                   'lcnn': (LCNNModel, jax_models.LCNNModel),
                   'megnet': (MEGNetModel, jax_models.MEGNetModel)}[name]
    ds_ref = JaxNumpyDataset(X_ref, y)
    ref = _REFS.get((name, mode))
    if ref is None:
        ref = _REFS[name, mode] = classes[1](**kw)
        ref.predict(ds_ref)                            # builds the params
    else:
        ref.reinitialize()
    model = classes[0](device='cpu', **kw)
    params_from_flax(_flatten_params(ref.params), model.module)
    return ref, model, ds_ref, NumpyDataset(X, y)


@pytest.mark.parametrize('name,mode', [
    ('cgcnn', 'regression'), ('cgcnn', 'classification'),
    ('lcnn', 'regression'), ('megnet', 'regression'),
    ('megnet', 'classification'), ('elemnet', 'regression')])
def test_outputs_and_gradients_match_flax(crystal_graphs, name, mode):
    """The first batch from the same flax weights: outputs, the loss and
    every gradient within 1e-5 of max(1, |ref|); every flax leaf mapped
    onto exactly one parameter.  The JAX batch is the port's without the
    CSR arrays.  ElemNet compares in eval mode (no dropout) for the
    outputs and with dropout off for the gradients."""
    ref, model, _, ds = _pair(name, crystal_graphs, mode)
    inputs, labels, weights = next(model.default_generator(ds))
    ref_in = inputs if name == 'elemnet' else inputs[:6] + inputs[-1:]
    j_in = [jnp.asarray(a) for a in ref_in]

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
    for o, r in zip(outs, ref_out, strict=True):
        assert _scaled(o.numpy(), r) <= 1e-5
    if name == 'elemnet':
        model.module.dropout = 0.0
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


def test_megnet_state_on_every_row(crystal_graphs):
    """Each block's ``h``, ``e`` and global state ``u`` against the JAX
    block's, ``u`` on all ``num_graphs + 1`` rows: the empty graph slots
    of a short batch and the ghost slot included."""
    ref, model, _, ds = _pair('megnet', crystal_graphs)
    inputs, _, _ = next(model.default_generator(NumpyDataset(ds.X[:4])))
    j_in = [jnp.asarray(a) for a in inputs[:6] + inputs[-1:]]
    _, state = jax.jit(lambda p: ref.module.apply(
        p, *j_in, training=False, capture_intermediates=True,
        mutable=['intermediates']))(ref.params)
    seen = []
    hooks = [b.register_forward_hook(lambda m, i, o: seen.append(o))
             for b in model.module.blocks]
    model.module.eval()
    with torch.no_grad():
        model.module(*model._prepare_batch((inputs, [], []))[0])
    for h in hooks:
        h.remove()
    for i, ours in enumerate(seen):
        theirs = state['intermediates'][f'_MEGNetBlock_{i}']['__call__'][0]
        assert ours[2].shape == (6 + 1, 8) == theirs[2].shape
        for a, b in zip(ours, theirs, strict=True):
            assert _scaled(a.numpy(), b) <= 1e-5
    assert not np.allclose(seen[-1][2][-1].numpy(), 0)   # the ghost row


@pytest.mark.parametrize('name,loop', [
    ('cgcnn', 'fit'), ('cgcnn', 'fit_on_device'), ('megnet', 'fit'),
    ('megnet', 'fit_on_device'), ('elemnet', 'fit')])
def test_fits_as_jax(crystal_graphs, name, loop, monkeypatch):
    """2 epochs of ``fit`` or ``fit_on_device`` from the same weights (3
    batches of 6, the last short; ElemNet 3 of 8), regression.  ElemNet's
    dropout is off on both sides, since the two packages draw their masks
    from different generators."""
    if name == 'elemnet':
        monkeypatch.setattr(jax_models.nn, 'Dropout',
                            lambda *a, **k: (lambda h: h))
    ref, model, ds_ref, ds = _pair(name, crystal_graphs)
    if name == 'elemnet':
        model.module.dropout = 0.0
    ref_losses, losses = [], []
    for m, d, out in ((ref, ds_ref, ref_losses), (model, ds, losses)):
        if loop == 'fit':
            m.fit(d, nb_epoch=2, checkpoint_interval=0, all_losses=out)
        else:
            m.fit_on_device(d, nb_epoch=2, seed=1, all_losses=out)
    assert len(losses) == len(ref_losses) == 2
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)


def test_elemnet_dropout_seeded_and_only_in_training():
    """Dropout at 0.2 after the 4th and the 8th layer: masks drawn from
    the seed (two models of one seed train alike), none in ``eval()``
    mode, about a fifth of the units dropped."""
    X = ElemNetFeaturizer().featurize(FORMULAS * 3)
    y = np.random.RandomState(0).randn(len(X), 1).astype(np.float32)
    a, b = (ElemNetModel(batch_size=8, seed=5, device='cpu')
            for _ in range(2))
    assert [i for i, d in enumerate(a.module.drops) if d] == [3, 7]
    la, lb = ([], [])
    a.fit(NumpyDataset(X, y), nb_epoch=1, checkpoint_interval=0,
          all_losses=la)
    b.fit(NumpyDataset(X, y), nb_epoch=1, checkpoint_interval=0,
          all_losses=lb)
    assert la == lb
    m = ElemNetModel(batch_size=8, seed=5, device='cpu')
    x = torch.from_numpy(X[:8])
    with torch.no_grad():
        m.module.eval()
        e1, e2 = m.module(x), m.module(x)
        m.module.train()
        t1 = m.module(x)
    assert torch.equal(e1, e2) and not torch.equal(e1, t1)
    h = torch.ones(200, 1024)
    kept = (m.module._dropout(h) > 0).float().mean().item()
    assert abs(kept - 0.8) < 0.01


def test_models_raise_without_a_device_or_widths():
    """No GPU here: every entry point needs ``device='cpu'``; a batch of
    other widths than the module's raises."""
    for cls in (CGCNNModel, LCNNModel, MEGNetModel, ElemNetModel):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls()
    X = LCNNFeaturizer().featurize(STRUCTS[:3])
    with pytest.raises(ValueError, match='features'):
        CGCNNModel(batch_size=3, device='cpu').predict(NumpyDataset(X))
