"""The port's PAGTN featurizer and batch packing against the JAX
package's: node features, edge index and pair features equal exactly, and
so does the padded, dst-sorted batch the model consumes."""

import numpy as np
import pytest
import torch

from deepchem_tpu.data import NumpyDataset as JaxNumpyDataset
from deepchem_tpu.feat import PagtnMolGraphFeaturizer as JaxPagtnFeaturizer
from deepchem_tpu.models import PagtnModel as JaxPagtnModel
from deepchem_tpu_torch import (NumpyDataset, PagtnModel,
                                PagtnMolGraphFeaturizer)
from deepchem_tpu_torch.chem import mol_from_smiles

torch.set_num_threads(1)

SMILES = [
    'CCO',
    'c1ccccc1O',
    'CC(=O)Oc1ccccc1C(=O)O',                 # aspirin
    'CN1C=NC2=C1C(=O)N(C(=O)N2C)C',          # caffeine
    'C[N+](C)(C)CC(=O)[O-]',                 # charges
    'FC(F)(F)c1ccc(Cl)cc1Br',
    'C1CC2CCC1C2',                           # bridged rings
    'N#Cc1ccncc1',
    'O=S(=O)(N)c1ccc(N)cc1',
    '[Na+].[Cl-]',                           # disconnected, one-atom parts
    'C/C=C/C(=O)[O-]',
    'c1ccc2c(c1)[nH]c1ccccc12',              # carbazole
]


def test_featurizer_equals_jax():
    ours = PagtnMolGraphFeaturizer(max_length=5).featurize(SMILES)
    ref = JaxPagtnFeaturizer(max_length=5).featurize(SMILES)
    assert len(ours) == len(ref) == len(SMILES)
    for s, a, b in zip(SMILES, ours, ref):
        n = mol_from_smiles(s).num_atoms
        assert a.node_features.shape == (n, 49)
        assert a.edge_features.shape == (n * n, 38)
        np.testing.assert_array_equal(a.node_features, b.node_features)
        np.testing.assert_array_equal(a.edge_index, b.edge_index)
        np.testing.assert_array_equal(a.edge_features, b.edge_features)


def test_unparseable_smiles_gives_empty_entry():
    out = PagtnMolGraphFeaturizer().featurize(['CCO', 'C1CC(', 'N'])
    assert out[1].size == 0 and out[0].num_nodes == 3


@pytest.mark.parametrize('batch', [SMILES[:5], SMILES[5:]])
def test_padded_batch_equals_jax(batch):
    X = PagtnMolGraphFeaturizer().featurize(batch)
    X_ref = JaxPagtnFeaturizer().featurize(batch)
    model = PagtnModel(n_tasks=12, mode='classification', num_layers=1,
                       batch_size=8, device='cpu')
    ref = JaxPagtnModel(n_tasks=12, mode='classification', num_layers=1,
                        batch_size=8, data_parallel=False)
    ours = model._graph_inputs(X)
    theirs = ref._graph_inputs(X_ref)
    assert len(ours) == len(theirs) == 7
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype
    edst = ours[2]
    assert np.all(np.diff(edst) >= 0), 'edges not sorted by destination'
    assert ours[0].shape[0] == 512 and edst.shape[0] % 2048 == 0


def test_generator_pads_the_short_last_batch():
    X = PagtnMolGraphFeaturizer().featurize(SMILES[:5])
    model = PagtnModel(n_tasks=2, batch_size=4, num_layers=1, device='cpu')
    batches = list(model.default_generator(NumpyDataset(X)))
    ref = JaxPagtnModel(n_tasks=2, batch_size=4, num_layers=1,
                        data_parallel=False)
    ref_batches = list(ref.default_generator(
        JaxNumpyDataset(JaxPagtnFeaturizer().featurize(SMILES[:5])),
        mode='predict'))
    assert len(batches) == len(ref_batches) == 2
    for (xs, ys, ws), (xr, yr, wr) in zip(batches, ref_batches):
        assert ys[0].shape == (4, 1) and ws[0].shape == (4, 1)
        for a, b in zip(xs + ys + ws, xr + yr + wr):
            np.testing.assert_array_equal(a, np.asarray(b))
    gidx = batches[1][0][3]
    assert set(gidx.tolist()) == {0, 4}      # one graph, then the ghost slot
