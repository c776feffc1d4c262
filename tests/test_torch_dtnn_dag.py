"""The port's DTNN and DAG slices against the JAX package's, on the CPU:
the conformer embedding and the SDF reader and writer, ``CoulombMatrix``,
``CoulombMatrixEig``, ``CoulombFitTransformer``, ``DTNNModel``,
``DAGTransformer`` and ``DAGModel``.

Same inputs, SMILES and molblocks written inline and numpy arrays from a
seed, go through the JAX function and the port's.  Tolerances: the
embedded coordinates, parsed molecules, written molblocks, Coulomb
matrices (plain, randomized, upper triangles, eigenvalues),
``CoulombFitTransformer``'s features, DTNN's recovered atoms and distances
and DAG's depth tables and packed batch equal (the same numpy operations
in the same order); the models' outputs and every gradient from the same
flax weights within 1e-5 of max(1, |ref|) (matmuls summed in another
order; DTNN's distance centres may differ from XLA's by an ulp); per-epoch
losses of a short ``fit`` and ``fit_on_device`` within 1e-4 relative.
DAG's level passes run P2 and its readout P3: on the CPU their plain
versions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepchem_tpu.chem import mol_from_smiles as jax_mol_from_smiles
from deepchem_tpu.chem import sdf as jax_sdf
from deepchem_tpu.data import NumpyDataset as JaxNumpyDataset
from deepchem_tpu.feat import ConvMolFeaturizer as JaxConvMolFeaturizer
from deepchem_tpu.feat import CoulombMatrix as JaxCoulombMatrix
from deepchem_tpu.feat import CoulombMatrixEig as JaxCoulombMatrixEig
from deepchem_tpu.models import fcnet as jax_fcnet
from deepchem_tpu.models.dag import DAGModel as JaxDAGModel
from deepchem_tpu.models.dag import DAGTransformer as JaxDAGTransformer
from deepchem_tpu.models.jax_model import _flatten_params
from deepchem_tpu.models.weave_models import DTNNModel as JaxDTNNModel
from deepchem_tpu.trans import CoulombFitTransformer as \
    JaxCoulombFitTransformer
from deepchem_tpu.utils import conformers as jax_conformers
from deepchem_tpu_torch import (ConvMolFeaturizer, CoulombMatrix, DAGModel,
                                DTNNModel, NumpyDataset)
from deepchem_tpu_torch.chem import mol_from_smiles, sdf
from deepchem_tpu_torch.feat import CoulombMatrixEig
from deepchem_tpu_torch.models import (DAGTensorGraph, DTNNTensorGraph,
                                       MultitaskFitTransformRegressor,
                                       params_from_flax)
from deepchem_tpu_torch.models.convert import flax_state
from deepchem_tpu_torch.ops import N_CSR, coo_csr
from deepchem_tpu_torch.trans import CoulombFitTransformer, DAGTransformer
from deepchem_tpu_torch.utils import conformers

torch.set_num_threads(1)

# rings, fused rings, aromatics, charges, a single atom, two fragments, a
# chain longer than DAG's 12 levels at the test's max_atoms
SMILES = ['CCO', 'c1ccccc1O', 'C[C@H](N)C(=O)O', '[NH4+]', 'C',
          'C[N+](C)(C)CC(=O)[O-]', '[Na+].[Cl-]', 'CC(=O)Oc1ccccc1C(=O)O',
          'N#Cc1ccncc1', 'c1ccsc1', 'C1CC2CCC1C2', 'c1ccc2ccccc2c1',
          'FC(F)(F)c1ccc(Cl)cc1Br', 'CCCCCCCCCCCCCCN', 'O']
MAX_ATOMS = 16
DTNN_SMALL = dict(n_tasks=1, n_embedding=8, n_hidden=12, n_steps=2,
                  n_distance=20, batch_size=6, log_frequency=3)
DAG_SMALL = dict(n_tasks=2, n_graph_feat=10, batch_size=6, log_frequency=3)

# molblocks: explicit hydrogens with a charge code on an atom line, an
# aromatic bond code and an M  CHG line, properties, an empty title line,
# and a record that does not parse (an unknown element)
WATER_H = """water
  test

  3  2  0  0  0  0  0  0  0  0999 V2000
    0.0000    0.0000    0.1173 O   0  0  0  0  0  0  0  0  0  0  0  0
    0.0000    0.7572   -0.4692 H   0  0  0  0  0  0  0  0  0  0  0  0
    0.0000   -0.7572   -0.4692 H   0  0  0  0  0  0  0  0  0  0  0  0
  1  2  1  0
  1  3  1  0
M  END
"""
PYRIDINIUM = """
     test          3D

  6  6  0  0  0  0  0  0  0  0999 V2000
    1.3900    0.0000    0.0000 N   0  3  0  0  0  0  0  0  0  0  0  0
    0.6950    1.2038    0.0000 C   0  0  0  0  0  0  0  0  0  0  0  0
   -0.6950    1.2038    0.0000 C   0  0  0  0  0  0  0  0  0  0  0  0
   -1.3900    0.0000    0.0000 C   0  0  0  0  0  0  0  0  0  0  0  0
   -0.6950   -1.2038    0.0000 C   0  0  0  0  0  0  0  0  0  0  0  0
    0.6950   -1.2038    0.0000 C   0  0  0  0  0  0  0  0  0  0  0  0
  1  2  4  0
  2  3  4  0
  3  4  4  0
  4  5  4  0
  5  6  4  0
  6  1  4  0
M  CHG  1   1   1
M  END
"""
ACETATE = """acetate
  test

  4  3  0  0  0  0  0  0  0  0999 V2000
    0.0000    0.0000    0.0000 C   0  0  0  0  0  0  0  0  0  0  0  0
    1.5000    0.0000    0.0000 C   0  0  0  0  0  0  0  0  0  0  0  0
    2.1000    1.0000    0.0000 O   0  0  0  0  0  0  0  0  0  0  0  0
    2.1000   -1.0000    0.0000 O   0  5  0  0  0  0  0  0  0  0  0  0
  1  2  1  0
  2  3  2  0
  2  4  1  0
M  END
"""
BAD = """bad
  test

  1  0  0  0  0  0  0  0  0  0999 V2000
    0.0000    0.0000    0.0000 Xx  0  0  0  0  0  0  0  0  0  0  0  0
M  END
"""
SDF_TEXT = (WATER_H + '>  <energy>\n-76.4\n\n>  <name>\nwater\n\n$$$$\n'
            + PYRIDINIUM + '>  <energy>\n-247.8\n\n$$$$\n' + ACETATE
            + '$$$$\n' + BAD + '>  <energy>\n0\n\n$$$$\n')


def _scaled(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        1.0, np.abs(np.asarray(b)).max())


def _same_molecule(a, b):
    assert a.num_atoms == b.num_atoms and a.num_bonds == b.num_bonds
    for x, y in zip(a.atoms, b.atoms):
        assert (x.atomic_num, x.formal_charge, x.total_hs, x.is_aromatic,
                x.degree, x.hybridization) == (
            y.atomic_num, y.formal_charge, y.total_hs, y.is_aromatic,
            y.degree, y.hybridization)
    assert [(c.a1, c.a2, c.order, c.is_aromatic) for c in a.bonds] == [
        (c.a1, c.a2, c.order, c.is_aromatic) for c in b.bonds]
    assert a.conformer == b.conformer


def test_embedding_equals_jax_bit_for_bit():
    """A molecule of two atoms gets two coordinates a row (MDS keeps the
    eigenvectors there are), in both packages."""
    for smi in SMILES:
        ours = conformers.embed_molecule_3d(
            mol_from_smiles(smi), rng=np.random.RandomState(5))
        ref = jax_conformers.embed_molecule_3d(
            jax_mol_from_smiles(smi), rng=np.random.RandomState(5))
        n = mol_from_smiles(smi).num_atoms
        assert ours.shape == (n, 2 if n == 2 else 3)
        np.testing.assert_array_equal(ours, ref, err_msg=smi)


def test_conformer_generator_equals_jax_bit_for_bit():
    """One seed, drawn on molecule after molecule; the energy, its
    minimisation and the pruning by RMSD on top."""
    gen = conformers.ConformerGenerator(seed=7, max_conformers=2)
    ref = jax_conformers.ConformerGenerator(seed=7, max_conformers=2)
    mols = [gen.generate_conformers(mol_from_smiles(s)) for s in SMILES]
    refs = [ref.generate_conformers(jax_mol_from_smiles(s)) for s in SMILES]
    for smi, m, r in zip(SMILES, mols, refs):
        assert m.conformer == r.conformer, smi
    m, r = mols[7], refs[7]
    np.testing.assert_array_equal(gen.get_conformer_energies(m),
                                  ref.get_conformer_energies(r))
    assert gen.get_molecule_force_field(m).CalcEnergy() == \
        ref.get_molecule_force_field(r).CalcEnergy()
    assert gen.minimize_conformers(m).conformer == \
        ref.minimize_conformers(r).conformer
    pool = [np.asarray(x.conformer) for x in (mols[7], mols[7])] + [
        np.asarray(mols[7].conformer) + 1.0]
    for a, b in zip(gen.prune_conformers(pool), ref.prune_conformers(pool),
                    strict=True):
        np.testing.assert_array_equal(a, b)
    # a molecule that has a conformer keeps it
    before = list(m.conformer)
    assert gen.generate_conformers(m).conformer == before


@pytest.mark.parametrize('block', [WATER_H, PYRIDINIUM, ACETATE, BAD])
def test_molblock_parses_as_jax(block):
    ours, ref = sdf.mol_from_molblock(block), \
        jax_sdf.mol_from_molblock(block)
    if ref is None:
        assert ours is None
        return
    _same_molecule(ours, ref)


def test_sdf_records_parse_as_jax():
    ours = list(sdf.parse_sdf(SDF_TEXT))
    ref = list(jax_sdf.parse_sdf(SDF_TEXT))
    assert len(ours) == len(ref) == 4
    for (m, p), (rm, rp) in zip(ours, ref):
        assert p == rp
        if rm is None:
            assert m is None
        else:
            _same_molecule(m, rm)
    assert ours[0][0].num_atoms == 1 and ours[0][0].atoms[0].total_hs == 2
    assert ours[1][0].atoms[0].formal_charge == 1
    assert ours[0][1] == {'energy': '-76.4', 'name': 'water'}


def test_molblocks_are_written_as_jax():
    """With a conformer, and without one (embedded from RandomState(0)),
    the same text; each parses back to the same molecule.  Without a
    conformer a molecule of two atoms cannot be written (its embedding has
    two coordinates a row) in either package."""
    for smi in SMILES[:10]:
        if mol_from_smiles(smi).num_atoms == 2:
            for write, parse in ((sdf.mol_to_molblock, mol_from_smiles),
                                 (jax_sdf.mol_to_molblock,
                                  jax_mol_from_smiles)):
                with pytest.raises(ValueError):
                    write(parse(smi))
            continue
        ours = sdf.mol_to_molblock(mol_from_smiles(smi), name=smi)
        assert ours == jax_sdf.mol_to_molblock(jax_mol_from_smiles(smi),
                                               name=smi)
        back = sdf.mol_from_molblock(ours)
        assert back is not None and back.num_atoms == \
            mol_from_smiles(smi).num_atoms
    m = sdf.mol_from_molblock(PYRIDINIUM)
    assert sdf.mol_to_molblock(m) == jax_sdf.mol_to_molblock(
        jax_sdf.mol_from_molblock(PYRIDINIUM))


@pytest.fixture(scope='module')
def molecules():
    """The SMILES with conformers from one seed, on both sides."""
    gen = conformers.ConformerGenerator(seed=3)
    ref = jax_conformers.ConformerGenerator(seed=3)
    return ([gen.generate_conformers(mol_from_smiles(s)) for s in SMILES],
            [ref.generate_conformers(jax_mol_from_smiles(s))
             for s in SMILES])


@pytest.mark.parametrize('kw', [dict(), dict(upper_tri=True),
                                dict(randomize=True, seed=4),
                                dict(randomize=True, n_samples=3, seed=4),
                                dict(randomize=True, n_samples=2,
                                     upper_tri=True, seed=9)])
def test_coulomb_matrix_equals_jax(molecules, kw):
    mols, refs = molecules
    ours = CoulombMatrix(MAX_ATOMS, **kw).featurize(mols)
    ref = JaxCoulombMatrix(MAX_ATOMS, **kw).featurize(refs)
    assert ours.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(ours, ref)
    n = kw.get('n_samples', 1)
    tri = MAX_ATOMS * (MAX_ATOMS + 1) // 2
    shape = (tri,) if kw.get('upper_tri') else (MAX_ATOMS, MAX_ATOMS)
    assert ours.shape == (len(SMILES),) + ((n,) if n > 1 else ()) + shape


def test_coulomb_eig_and_distances_equal_jax(molecules):
    mols, refs = molecules
    np.testing.assert_array_equal(
        CoulombMatrixEig(MAX_ATOMS).featurize(mols),
        JaxCoulombMatrixEig(MAX_ATOMS).featurize(refs))
    np.testing.assert_array_equal(
        CoulombMatrix.get_interatomic_distances(mols[7]),
        JaxCoulombMatrix.get_interatomic_distances(refs[7]))
    # without a conformer a molecule fails, as any featurizer's failure
    out = CoulombMatrix(MAX_ATOMS).featurize(['CCO'])
    assert out.shape == (1, 0)


@pytest.fixture(scope='module')
def coulomb(molecules):
    mols, refs = molecules
    X = CoulombMatrix(MAX_ATOMS).featurize(mols)
    y = np.random.RandomState(1).randn(len(X), 1).astype(np.float32)
    return X, y


def test_coulomb_fit_transformer_equals_jax(coulomb):
    X, y = coulomb
    ours = CoulombFitTransformer(NumpyDataset(X, y), random_seed=2)
    ref = JaxCoulombFitTransformer(JaxNumpyDataset(X, y), random_seed=2)
    np.testing.assert_array_equal(ours.mean, ref.mean)
    np.testing.assert_array_equal(ours.std, ref.std)
    # 3-D: realize (two draws of the seed's noise), expand, normalize
    for _ in range(2):
        np.testing.assert_array_equal(ours.X_transform(X),
                                      ref.X_transform(X))
    flat = X.reshape(len(X), -1)
    np.testing.assert_array_equal(ours.X_transform(flat),
                                  ref.X_transform(flat))
    np.testing.assert_array_equal(ours.expand(flat), ref.expand(flat))
    assert ours.X_transform(flat).shape == (len(X), 3 * MAX_ATOMS ** 2)
    out, y_out, _, _ = ours.transform_array(flat, y, None, None)
    assert y_out is y and out.shape[1] == 3 * MAX_ATOMS ** 2


def test_fit_transform_regressor_on_coulomb_matches_jax(coulomb):
    X, y = coulomb
    kw = dict(n_tasks=1, n_features=[MAX_ATOMS, MAX_ATOMS],
              layer_sizes=[16], dropouts=0.0, batch_size=6)
    ref = jax_fcnet.MultitaskFitTransformRegressor(
        fit_transformers=[JaxCoulombFitTransformer(JaxNumpyDataset(X, y))],
        **kw)
    ref_pred = ref.predict(JaxNumpyDataset(X, y))
    ours = MultitaskFitTransformRegressor(
        fit_transformers=[CoulombFitTransformer(NumpyDataset(X, y))],
        device='cpu', **kw)
    params_from_flax(_flatten_params(ref.params), ours.module)
    assert ours.module.state_dict()['trunk.layers.0.weight'].shape[1] == \
        3 * MAX_ATOMS ** 2
    assert _scaled(ours.predict(NumpyDataset(X, y)), ref_pred) <= 1e-5


def test_dtnn_host_features_equal_jax(coulomb):
    X, _ = coulomb
    ours = DTNNModel(device='cpu', **DTNN_SMALL).compute_features_on_batch(X)
    ref = JaxDTNNModel(**DTNN_SMALL).compute_features_on_batch(X)
    for a, b in zip(ours, ref, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    zi, d, mask = ours
    np.testing.assert_array_equal(
        mask.sum(axis=1), [mol_from_smiles(s).num_atoms for s in SMILES])
    assert zi[7, 0] == 6 and zi[14, 0] == 8          # C, O


@pytest.fixture(scope='module')
def dag_graphs():
    X = ConvMolFeaturizer().featurize(SMILES)
    X_ref = JaxConvMolFeaturizer().featurize(SMILES)
    return (DAGTransformer(max_atoms=MAX_ATOMS).transform_array(
                X, None, None, None)[0],
            JaxDAGTransformer(max_atoms=MAX_ATOMS).transform_array(
                X_ref, None, None, None)[0])


def _pair(name, data, mode='regression', **kwargs):
    """A JAX model and a port model (``'dtnn'`` or ``'dag'``) with the same
    initial parameters, and their datasets: the Coulomb matrices, or the
    DAG graphs with two seeded label columns."""
    if name == 'dtnn':
        X, y = data
        X_ref = X
        kw = dict(DTNN_SMALL, **kwargs)
        ref, model = JaxDTNNModel(**kw), DTNNModel(device='cpu', **kw)
    else:
        X, X_ref = data
        rng = np.random.RandomState(3)
        y = (rng.randn(len(X), 2) if mode == 'regression'
             else rng.randint(0, 2, (len(X), 2))).astype(np.float32)
        kw = dict(DAG_SMALL, max_atoms=MAX_ATOMS, mode=mode, **kwargs)
        ref = JaxDAGModel(data_parallel=False, **kw)
        model = DAGModel(device='cpu', **kw)
    ds_ref = JaxNumpyDataset(X_ref, y)
    ref.predict(ds_ref)                                # builds the params
    params_from_flax(_flatten_params(ref.params), model.module)
    return ref, model, ds_ref, NumpyDataset(X, y)


@pytest.mark.parametrize('name,mode', [('dtnn', 'regression'),
                                       ('dag', 'regression'),
                                       ('dag', 'classification')])
def test_outputs_and_gradients_match_flax(coulomb, dag_graphs, name, mode):
    """The first batch from the same flax weights: outputs, the loss and
    every gradient within 1e-5 of max(1, |ref|); every flax leaf mapped
    onto exactly one parameter.  DAG's JAX batch is the port's without
    the CSR arrays."""
    ref, model, _, ds = _pair(name, coulomb if name == 'dtnn'
                              else dag_graphs, mode)
    inputs, labels, weights = next(model.default_generator(ds))
    ref_in = inputs if name == 'dtnn' else inputs[:6] + inputs[-1:]
    j_in = [jnp.asarray(a) for a in ref_in]
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
    outs = out if isinstance(out, tuple) else (out,)
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
    if name == 'dag':
        assert model.module.max_levels == 12
        assert DAGTensorGraph is DAGModel
    else:
        assert DTNNTensorGraph is DTNNModel


@pytest.mark.parametrize('name', ['dtnn', 'dag'])
@pytest.mark.parametrize('loop', ['fit', 'fit_on_device'])
def test_fits_as_jax(coulomb, dag_graphs, name, loop):
    """2 epochs of ``fit`` or ``fit_on_device`` from the same weights (3
    batches of 6, the last short), regression."""
    ref, model, ds_ref, ds = _pair(name, coulomb if name == 'dtnn'
                                   else dag_graphs, learning_rate=0.003)
    ref_losses, losses = [], []
    for m, d, out in ((ref, ds_ref, ref_losses), (model, ds, losses)):
        if loop == 'fit':
            m.fit(d, nb_epoch=2, checkpoint_interval=0, all_losses=out)
        else:
            m.fit_on_device(d, nb_epoch=2, seed=1, all_losses=out)
    assert len(losses) == len(ref_losses) == 2
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)


def test_dag_depth_tables_equal_jax(dag_graphs):
    X, X_ref = dag_graphs
    for smi, g, r in zip(SMILES, X, X_ref, strict=True):
        assert g.dag_depth.dtype == np.int32
        np.testing.assert_array_equal(g.dag_depth, r.dag_depth, err_msg=smi)
        assert g.kwargs['dag_depth'] is g.dag_depth
    salt = X[SMILES.index('[Na+].[Cl-]')].dag_depth
    np.testing.assert_array_equal(salt, [[0, 2], [2, 0]])   # unreachable: n
    chain = X[SMILES.index('CCCCCCCCCCCCCCN')].dag_depth
    assert chain[0].max() == 14


def test_dag_packed_batch_matches_jax(dag_graphs):
    """The JAX package's arrays, then the CSR of the edges between the
    edge mask and ``root_depth``; an untransformed molecule's depth 0."""
    X, X_ref = dag_graphs
    model = DAGModel(device='cpu', max_atoms=MAX_ATOMS, **DAG_SMALL)
    ref = JaxDAGModel(max_atoms=MAX_ATOMS, data_parallel=False, **DAG_SMALL)
    ours, theirs = model._graph_inputs(X[:6]), ref._graph_inputs(X_ref[:6])
    assert len(ours) == 6 + N_CSR + 1 and len(theirs) == 7
    for a, b in zip(ours[:6] + ours[-1:], theirs, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ours[6:6 + N_CSR], coo_csr(ours[1], ours[2],
                                               len(ours[0]))):
        np.testing.assert_array_equal(a, b)
    depth = ours[-1]
    assert (depth[int(sum(g.num_nodes for g in X[:6])):] == 1000).all()
    plain = ConvMolFeaturizer().featurize(SMILES[:2])
    np.testing.assert_array_equal(model._graph_inputs(plain)[-1][:10], 0)
