"""The port's AtomicConv slice against the JAX package's, on the CPU:
``compute_neighbor_list``, ``neighbor_dict``, ``pdb_atoms``,
``AtomicConvFeaturizer`` (and its older name), ``AtomicConvolution``,
``AtomicConvModel`` and ``ani_symmetry_features``.

Same inputs, PDB text written by the test (a few records by hand, the
rest from seeded coordinates) and numpy arrays from a seed, go through
the JAX function and the port's, at small fragment sizes.  Tolerances:
neighbour lists, parsed atoms, featurized complexes and padded batch
arrays equal; the convolution, the model's outputs, loss and every
gradient from the same flax weights within 1e-5 of max(1, |ref|) (sums
in another order); per-epoch losses of 2-epoch fits within 1e-4
relative; ``evaluate``'s score within 1e-6; the ANI features within 1e-5
of max(1, |ref|).  A complex of more atoms than the model's
``complex_num_atoms`` (the featurizer's default maximum is above the
model's) names neighbours past the padded block: ``jnp.take`` gives NaN
there, and so does the port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepchem_tpu.data import NumpyDataset as JaxNumpyDataset
from deepchem_tpu.metrics import Metric as JaxMetric
from deepchem_tpu.metrics import score_function as jax_scores
from deepchem_tpu.models import atomic_conv as jax_ac
from deepchem_tpu.models.jax_model import _flatten_params
from deepchem_tpu_torch import Metric, NumpyDataset, rms_score
from deepchem_tpu_torch.models import atomic_conv as ac
from deepchem_tpu_torch.models import params_from_flax
from deepchem_tpu_torch.models.convert import flax_state

torch.set_num_threads(1)

# hand-written records: an element column, a name only ('CL', which both
# packages read as C, and 'N1'), an unknown element, a HETATM, and lines
# that are skipped
PDB_LINES = [
    'HEADER    TEST COMPLEX\n',
    'ATOM      1  N   ALA A   1      11.104   6.134  -6.504  1.00  0.00'
    '           N\n',
    'ATOM      2  CA  ALA A   1      11.639   6.071  -5.147  1.00  0.00'
    '           C\n',
    'ATOM      3 CL   CLX A   2       9.000   1.500   2.250  1.00  0.00\n',
    'ATOM      4  N1  NXX A   3       8.125  -1.000   0.500\n',
    'HETATM    5 ZN    ZN B   4       1.000   2.000   3.000  1.00  0.00'
    '          ZN\n',
    'HETATM    6  XX  UNK B   5       0.500   0.250   0.125  1.00  0.00'
    '          Xx\n',
    'ATOM      7  H   ALA A   1      12.000   6.500  -7.000  1.00  0.00'
    '           H\n',
    'ATOM      8  C   BAD A   6     notanumber   1.000   1.000\n',
    'TER\n', 'END\n']
ELEMENTS = ['C', 'N', 'O', 'S', 'C', 'C', 'N', 'O', 'H', 'Cl', 'P', 'Zn',
            'C', 'Se']
# small sizes: a ligand of at most 8 heavy atoms, a pocket of 20, the
# complex 28; 4 neighbour slots; a short radial grid
SIZES = dict(frag1_num_atoms=8, frag2_num_atoms=20, complex_num_atoms=28,
             max_num_neighbors=4)
RADIAL = (tuple(np.arange(1.5, 6.1, 1.5)), (0.0, 4.0), (0.4,))
SMALL = dict(SIZES, n_tasks=2, batch_size=3, radial=RADIAL,
             layer_sizes=(8, 8, 4), log_frequency=3, learning_rate=0.003)


def _scaled(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        1.0, np.abs(np.asarray(b)).max())


def _pdb(coords, elems, record='ATOM'):
    """PDB records of the given atoms, element in columns 77-78."""
    return [f'{record:<6}{i + 1:5d} {e.upper():<4} LIG A   1    '
            f'{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00          {e:>2}\n'
            for i, ((x, y, z), e) in enumerate(zip(coords, elems))]


def _fragment(rng, n, spread, record='ATOM', elements=ELEMENTS):
    coords = rng.rand(n, 3) * spread
    elems = [elements[k] for k in rng.randint(0, len(elements), n)]
    return _pdb(coords, elems, record)


def _complexes(seed=0, n=7, lig=(5, 9), prot=(14, 21), elements=ELEMENTS):
    """``n`` (ligand, pocket) PDB pairs from seeded coordinates; with the
    default elements some carry hydrogens, which are stripped."""
    rng = np.random.RandomState(seed)
    return [(_fragment(rng, rng.randint(*lig), 5.0, 'HETATM', elements),
             _fragment(rng, rng.randint(*prot), 9.0, 'ATOM', elements))
            for _ in range(n)]


def test_neighbor_lists_equal_jax():
    """Ids, validity and the dict format, at a cutoff that leaves slots
    empty and with fewer atoms than slots."""
    rng = np.random.RandomState(0)
    for n, cutoff, m in ((30, 3.0, 6), (30, 12.0, 12), (3, 12.0, 12),
                         (1, 12.0, 4)):
        c = (rng.rand(n, 3) * 8).astype(np.float32)
        ours, theirs = (f.compute_neighbor_list(c, cutoff, m)
                        for f in (ac, jax_ac))
        for a, b in zip(ours, theirs, strict=True):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert ac.neighbor_dict(c, cutoff, m) == jax_ac.neighbor_dict(
            c, cutoff, m)


def test_pdb_atoms_equal_jax(tmp_path):
    ours, theirs = ac.pdb_atoms(PDB_LINES), jax_ac.pdb_atoms(PDB_LINES)
    for a, b in zip(ours, theirs, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours[1], [7, 6, 6, 7, 30, -1, 1])
    path = tmp_path / 'x.pdb'
    path.write_text(''.join(PDB_LINES))
    for a, b in zip(ac.pdb_atoms(str(path)), ours, strict=True):
        np.testing.assert_array_equal(a, b)


def _assert_complexes_equal(ours, theirs):
    assert len(ours) == len(theirs)
    for t, r in zip(ours, theirs, strict=True):
        assert len(t) == len(r) == 9
        for k, (a, b) in enumerate(zip(t, r)):
            if isinstance(b, dict):
                assert a == b, k
            else:
                assert a.dtype == b.dtype, k
                np.testing.assert_array_equal(a, b)


def test_featurizer_equals_jax():
    """The 9-tuples equal, hydrogens stripped (or kept), a pre-parsed
    fragment, a complex past a maximum and an empty fragment dropped, the
    kept indices; the older name; ``get_Z_matrix`` and
    ``featurize_mol``."""
    pairs = _complexes()
    pairs.append((_fragment(np.random.RandomState(9), 20, 5.0,
                            elements=['C', 'N']),
                  _complexes(1, 1)[0][1]))                # ligand too big
    pairs.append(([], _complexes(2, 1)[0][1]))             # empty ligand
    pairs.append((ac.pdb_atoms(_complexes(3, 1)[0][0]),
                  _complexes(3, 1)[0][1]))                 # pre-parsed
    for kw in ({}, {'strip_hydrogens': False}, {'neighbor_cutoff': 4.0}):
        for ours_cls, ref_cls in (
                (ac.AtomicConvFeaturizer, jax_ac.AtomicConvFeaturizer),
                (ac.ComplexNeighborListFragmentAtomicCoordinates,
                 jax_ac.ComplexNeighborListFragmentAtomicCoordinates)):
            f, r = ours_cls(**SIZES, **kw), ref_cls(**SIZES, **kw)
            _assert_complexes_equal(f.featurize(pairs), r.featurize(pairs))
            np.testing.assert_array_equal(f.kept_indices, r.kept_indices)
    assert list(f.kept_indices) == [0, 1, 2, 3, 4, 5, 6, 9]
    z = np.array([6, 7, 8])
    np.testing.assert_array_equal(
        ac.AtomicConvFeaturizer.get_Z_matrix(z, 5),
        jax_ac.AtomicConvFeaturizer.get_Z_matrix(z, 5))
    with pytest.raises(ValueError, match='max_atoms'):
        ac.AtomicConvFeaturizer.get_Z_matrix(z, 2)
    c = np.random.RandomState(4).rand(3, 3)
    for a, b in zip(ac.AtomicConvFeaturizer().featurize_mol(c, z, 5),
                    jax_ac.AtomicConvFeaturizer().featurize_mol(c, z, 5)):
        if isinstance(b, dict):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)


def test_atomic_convolution_matches_jax():
    """``[B, N, T K]`` from seeded coordinates, neighbour ids (one of them
    negative, counted from the end as ``jnp.take`` counts it) and types,
    within 1e-5 of max(1, |ref|), at the default radial grid."""
    rng = np.random.RandomState(1)
    B, N, M = 2, 9, 4
    coords = (rng.rand(B, N, 3) * 6).astype(np.float32)
    nbrs = rng.randint(0, N, (B, N, M)).astype(np.int32)
    nbrs[0, 0, 0] = -2
    z = rng.choice([0.0, 6.0, 7.0, 8.0, 16.0, -1.0], (B, N, M)).astype(
        np.float32)
    radial = [tuple(t) for t in __import__('itertools').product(
        *jax_ac.DEFAULT_RADIAL)]
    types = [float(t) for t in jax_ac.DEFAULT_ATOM_TYPES]
    ref = jax_ac.AtomicConvolution(tuple(radial), tuple(types)).apply(
        {}, jnp.asarray(coords), jnp.asarray(nbrs), jnp.asarray(z))
    ours = ac.AtomicConvolution(radial, types)(
        torch.from_numpy(coords), torch.from_numpy(nbrs),
        torch.from_numpy(z))
    assert ours.shape == ref.shape == (B, N, 66 * 15)
    assert np.isfinite(ref).all()
    assert _scaled(ours.numpy(), ref) <= 1e-5


_REF = []


def _data():
    feat = ac.AtomicConvFeaturizer(**SIZES)
    X = feat.featurize(_complexes())
    y = np.random.RandomState(3).randn(len(X), 2).astype(np.float32)
    return X, y


def _pair(**kw):
    """A JAX model and a port model with the same initial parameters (the
    JAX model built once a configuration, then redrawn by
    ``reinitialize``), and the datasets: 7 complexes, batches of 3."""
    X, y = _data()
    kw = dict(SMALL, **kw)
    ds_ref = JaxNumpyDataset(X, y)
    hit = [r for r, k in _REF if k == kw]
    if hit:
        ref = hit[0]
        ref.reinitialize()
    else:
        ref = jax_ac.AtomicConvModel(**kw)
        ref.predict(ds_ref)
        _REF.append((ref, kw))
    model = ac.AtomicConvModel(device='cpu', **kw)
    params_from_flax(_flatten_params(ref.params), model.module)
    return ref, model, ds_ref, NumpyDataset(X, y)


def test_batch_arrays_equal_jax():
    """The 12 padded arrays of a batch: ids and types from the dicts,
    unknown atomic numbers as -1; and from ``[N, M]`` id arrays."""
    ref, model, ds_ref, ds = _pair()
    ours = next(model.default_generator(ds))
    theirs = next(ref.default_generator(ds_ref))
    for a, b in zip(ours[0], theirs[0], strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours[1][0], theirs[1][0])
    X = ds.X
    as_arrays = np.empty(len(X), dtype=object)
    for i, t in enumerate(X):
        t = list(t)
        for off in (0, 3, 6):
            t[off + 1] = ac.compute_neighbor_list(
                t[off], 12.0, SIZES['max_num_neighbors'])[0]
        as_arrays[i] = tuple(t)
    a = model._frag_arrays(as_arrays[:3], 6, SIZES['complex_num_atoms'])
    b = ref._frag_arrays(as_arrays[:3], 6, SIZES['complex_num_atoms'])
    for u, v in zip(a, b, strict=True):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize('kw', [{}, {'residual': True,
                                     'layer_sizes': (8, 8)}])
def test_outputs_and_gradients_match_flax(kw):
    """The first batch from the same flax weights: outputs, loss and
    every gradient within 1e-5 of max(1, |ref|); every flax leaf mapped
    onto exactly one parameter."""
    ref, model, _, ds = _pair(**kw)
    inputs, labels, weights = next(model.default_generator(ds))
    j_in = [jnp.asarray(a) for a in inputs]

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
    assert out.shape == (3, 2)
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


def test_fit_follows_the_jax_losses():
    ref, model, ds_ref, ds = _pair()
    ref_losses, losses = [], []
    for m, d, out in ((ref, ds_ref, ref_losses), (model, ds, losses)):
        m.fit(d, nb_epoch=2, checkpoint_interval=0, all_losses=out)
    assert len(losses) == len(ref_losses) == 2
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)


def test_evaluate_matches_jax():
    ref, model, ds_ref, ds = _pair()
    pred, ref_pred = model.predict(ds), ref.predict(ds_ref)
    assert pred.shape == (7, 2)
    assert _scaled(pred, ref_pred) <= 1e-5
    score = model.evaluate(ds, [Metric(rms_score)])['rms_score']
    ref_score = ref.evaluate(ds_ref, [JaxMetric(jax_scores.rms_score)])
    np.testing.assert_allclose(score, ref_score['rms_score'], atol=1e-6)


def test_complex_past_the_model_atoms_gives_jax_nan():
    """The featurizer keeps complexes up to its own maximum (the default
    704 against the model's 701); here 3 above the model's 28.  Such a
    complex's atoms within the padded block name neighbours past it:
    ``jnp.take`` fills those rows with NaN, so that complex's answer is
    NaN in both packages, and the others' are within 1e-5."""
    big = dict(SIZES, complex_num_atoms=SIZES['complex_num_atoms'] + 3,
               frag2_num_atoms=SIZES['frag2_num_atoms'] + 3)
    pairs = _complexes(5, 4, lig=(8, 9), prot=(22, 23),
                       elements=['C', 'N', 'O', 'S', 'Zn'])
    X = ac.AtomicConvFeaturizer(**big).featurize(pairs)
    X_ref = jax_ac.AtomicConvFeaturizer(**big).featurize(pairs)
    _assert_complexes_equal(X, X_ref)
    assert all(len(t[6]) == 30 for t in X)
    y = np.zeros((len(X), 2), np.float32)
    ref, model, _, _ = _pair()
    kw = dict(SIZES, frag2_num_atoms=big['frag2_num_atoms'])
    ref = jax_ac.AtomicConvModel(**dict(SMALL, **kw))
    ref_pred = ref.predict(JaxNumpyDataset(X_ref, y))
    model = ac.AtomicConvModel(device='cpu', **dict(SMALL, **kw))
    params_from_flax(_flatten_params(ref.params), model.module)
    pred = model.predict(NumpyDataset(X, y))
    nbrs = model._frag_arrays(X, 6, SIZES['complex_num_atoms'])[1]
    past = (nbrs >= SIZES['complex_num_atoms']).any(axis=(1, 2))
    assert past.any()
    np.testing.assert_array_equal(np.isnan(pred), np.isnan(ref_pred))
    assert np.isnan(pred[past]).all() and np.isfinite(pred[~past]).all()
    if (~past).any():
        assert _scaled(pred[~past], ref_pred[~past]) <= 1e-5


def test_ani_symmetry_features_match_jax():
    rng = np.random.RandomState(6)
    c = (rng.rand(7, 3) * 3).astype(np.float32)
    z = np.array([1, 6, 7, 8, 16, 6, 9], np.int32)
    mask = np.array([1, 1, 1, 1, 1, 1, 0], np.float32)
    for m in (None, mask):
        ref = jax_ac.ani_symmetry_features(
            jnp.asarray(c), jnp.asarray(z),
            None if m is None else jnp.asarray(m))
        ours = ac.ani_symmetry_features(
            torch.from_numpy(c), torch.from_numpy(z),
            None if m is None else torch.from_numpy(m))
        assert ours.shape == ref.shape == (7, 1 + 5 * 32 + 15 * 64)
        assert _scaled(ours.numpy(), ref) <= 1e-5


def test_dropout_is_seeded_and_only_in_training():
    X, y = _data()
    plain = ac.AtomicConvModel(device='cpu', **SMALL)
    drop = [ac.AtomicConvModel(device='cpu', dropouts=0.5, **SMALL)
            for _ in range(2)]
    np.testing.assert_array_equal(plain.predict(NumpyDataset(X, y)),
                                  drop[0].predict(NumpyDataset(X, y)))
    losses = [m.fit(NumpyDataset(X, y), nb_epoch=1, checkpoint_interval=0)
              for m in drop]
    assert np.isfinite(losses[0]) and losses[0] == losses[1]


def test_entry_points_need_a_device():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ac.AtomicConvModel()
