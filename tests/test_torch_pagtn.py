"""The port's PAGTN model against the JAX package's, on the CPU.

Parameters come from the flax model through ``params_from_flax``, so both
sides compute with the same weights.  Tolerance atol 1e-5: f32 on both
sides, with sums (matmuls, segment sums, the segment softmax) taken in
another order.  Also: the package imports nothing of JAX, and it never
falls back to the CPU on its own.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepchem_tpu.data import NumpyDataset as JaxNumpyDataset
from deepchem_tpu.feat import PagtnMolGraphFeaturizer as JaxPagtnFeaturizer
from deepchem_tpu.models import PagtnModel as JaxPagtnModel
from deepchem_tpu.models.graph_models import PagtnLayer as JaxPagtnLayer
from deepchem_tpu.models.graph_models import _PagtnModule as JaxPagtnModule
from deepchem_tpu.models.jax_model import _flatten_params
from deepchem_tpu_torch import (NumpyDataset, PagtnModel,
                                PagtnMolGraphFeaturizer)
from deepchem_tpu_torch.models import PagtnLayer, params_from_flax
from deepchem_tpu_torch.models.graph_models import _PagtnModule

torch.set_num_threads(1)
ATOL = 1e-5
REPO = Path(__file__).resolve().parent.parent

SMILES = ['CCO', 'c1ccccc1O', 'CC(=O)Oc1ccccc1C(=O)O',
          'CN1C=NC2=C1C(=O)N(C(=O)N2C)C', 'C[N+](C)(C)CC(=O)[O-]',
          'FC(F)(F)c1ccc(Cl)cc1Br', 'N#Cc1ccncc1', 'O=S(=O)(N)c1ccc(N)cc1',
          'CCN(CC)CCOC(=O)c1ccc(N)cc1', 'Clc1ccc2c(c1)C(=NCC(=O)N2)c1ccccc1']


def _t(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _sorted_graph(rng, N=16, E=60, FN=8, FE=6):
    nf = rng.randn(N, FN).astype(np.float32)
    esrc = rng.randint(0, N, E).astype(np.int32)
    edst = np.sort(rng.randint(0, N, E)).astype(np.int32)
    ef = rng.randn(E, FE).astype(np.float32)
    emask = (rng.rand(E) > 0.2).astype(np.float32)
    emask[edst == edst[-1]] = 0.0          # a fully masked (ghost) node
    return nf, ef, esrc, edst, emask


@pytest.mark.parametrize('n_heads', [1, 2])
def test_layer_matches_jax(n_heads):
    rng = np.random.RandomState(0)
    h, ef, esrc, edst, emask = _sorted_graph(rng, FN=8 * n_heads)
    layer = JaxPagtnLayer(hidden_features=8, n_heads=n_heads)
    params = layer.init(jax.random.PRNGKey(1), h, ef, esrc, edst, emask)
    ref = np.asarray(layer.apply(params, h, ef, esrc, edst, emask))
    ours = PagtnLayer(8 * n_heads, 6, 8, n_heads)
    params_from_flax(_flatten_params(params), ours)
    with torch.no_grad():
        out = ours(*_t([h, ef]), torch.from_numpy(esrc).long(),
                   *_t([edst, emask])).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def _packed_batch(smiles, num_graphs):
    X = PagtnMolGraphFeaturizer().featurize(smiles)
    return PagtnModel(n_tasks=1, batch_size=num_graphs, num_layers=1,
                      device='cpu')._graph_inputs(X)


@pytest.mark.parametrize('mode,n_tasks', [('classification', 12),
                                          ('regression', 3)])
def test_module_matches_jax(mode, n_tasks):
    inputs = _packed_batch(SMILES[:6], num_graphs=8)
    kw = dict(n_tasks=n_tasks, n_classes=2, mode=mode, num_graphs=8,
              hidden_features=8, output_node_features=32, num_layers=2)
    ref_module = JaxPagtnModule(sorted_edges=False, **kw)
    params = ref_module.init(jax.random.PRNGKey(2),
                             *[jnp.asarray(a) for a in inputs])
    ref = ref_module.apply(params, *[jnp.asarray(a) for a in inputs])
    ours = _PagtnModule(node_features=49, edge_features=38, **kw).eval()
    params_from_flax(_flatten_params(params), ours)
    with torch.no_grad():
        out = ours(*_t(inputs))
    ref = ref if isinstance(ref, tuple) else (ref,)
    out = out if isinstance(out, tuple) else (out,)
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def test_predict_matches_jax_with_short_last_batch():
    """Default widths, 12 tasks, batches of 4 over 10 molecules."""
    X_ref = JaxPagtnFeaturizer().featurize(SMILES)
    ref_model = JaxPagtnModel(n_tasks=12, mode='classification',
                              batch_size=4, data_parallel=False, seed=3)
    ref = ref_model.predict(JaxNumpyDataset(X_ref))
    model = PagtnModel(n_tasks=12, mode='classification', batch_size=4,
                       device='cpu')
    params_from_flax(_flatten_params(ref_model.params), model.module)
    out = model.predict(NumpyDataset(PagtnMolGraphFeaturizer().featurize(
        SMILES)))
    assert out.shape == ref.shape == (10, 12, 2)
    np.testing.assert_allclose(out, ref, atol=ATOL)
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-6)
    batch = model.predict_on_batch(PagtnMolGraphFeaturizer().featurize(
        SMILES[:3]))
    np.testing.assert_allclose(batch, ref[:3], atol=ATOL)


def test_params_from_flax_rejects_missing_and_extra_keys():
    module = _PagtnModule(n_tasks=1, n_classes=2, mode='regression',
                          num_graphs=2, node_features=5, edge_features=3,
                          hidden_features=4, output_node_features=8,
                          num_layers=1)
    flat = {}
    for name, p in module.state_dict().items():
        scope, leaf = name.rsplit('.', 1)
        scope = {'readout': 'Dense_0', 'head': 'Dense_1'}.get(
            scope, scope.replace('layers.', 'pagtn_').replace('.', '/'))
        flat[f'params/{scope}/{"kernel" if leaf == "weight" else "bias"}'] \
            = p.T.numpy() if leaf == 'weight' else p.numpy()
    params_from_flax(flat, module)
    with pytest.raises(KeyError):
        params_from_flax({k: v for k, v in flat.items()
                          if k != 'params/embed/bias'}, module)
    with pytest.raises(KeyError):
        params_from_flax({**flat, 'params/Dense_2/bias': np.zeros(1)},
                         module)
    with pytest.raises(ValueError):
        params_from_flax({**flat, 'params/embed/bias': np.zeros(5)}, module)


def test_seeded_init_is_reproducible():
    a = PagtnModel(n_tasks=2, num_layers=1, device='cpu', seed=7)
    b = PagtnModel(n_tasks=2, num_layers=1, device='cpu', seed=7)
    c = PagtnModel(n_tasks=2, num_layers=1, device='cpu', seed=8)
    sa, sb, sc = (m.module.state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa['embed.weight'], sc['embed.weight'])
    w = sa['readout.weight']
    std = (1.0 / w.shape[1]) ** 0.5
    assert w.abs().max() <= 2 * std / .87962566103423978 + 1e-6
    assert torch.all(sa['readout.bias'] == 0)


def test_wrong_feature_width_is_reported():
    model = PagtnModel(n_tasks=1, number_atom_features=50, num_layers=1,
                       device='cpu')
    with pytest.raises(ValueError, match='atom and'):
        model.predict_on_batch(PagtnMolGraphFeaturizer().featurize(['CCO']))


def test_no_device_and_no_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        PagtnModel(n_tasks=1, num_layers=1)
    model = PagtnModel(n_tasks=1, num_layers=1, device='cpu')
    assert model.predict_on_batch(
        PagtnMolGraphFeaturizer().featurize(['CCO'])).shape == (1, 1)


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / 'deepchem_tpu_torch').rglob('*.py'))
    files += [REPO / 'chip_smoke.py'] + [
        REPO / 'scripts' / f for f in ('card_determinism.py',
                                       'image_float32_drift.py',
                                       'profile_torch_encoder.py',
                                       'profile_torch_pagtn.py',
                                       'rehearse_chip_smoke.py')]
    assert len(files) > 15
    # the card's machine has none of these: PIL, pandas and sklearn too
    banned = ('jax', 'jaxlib', 'flax', 'optax', 'deepchem_tpu', 'PIL',
              'pandas', 'sklearn')
    for path in files:
        for mod in _imported_modules(path):
            root = mod.split('.')[0]
            assert root not in banned, f'{path.name} imports {mod}'
