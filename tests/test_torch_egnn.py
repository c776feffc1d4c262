"""The port's ``EGNNLayer`` and ``EquivariantGraphFeaturizer`` against the
JAX package's, on the CPU.

Same inputs, SMILES written inline (embedded in 3D by each package's own
conformer code, which agree bit for bit) and numpy arrays from a seed, go
through the JAX function and the port's.  Tolerances: the featurized
arrays equal; the layer's outputs (features and coordinates) and the
gradients of ``h``, ``x``, the edge features and every weight from the
same flax weights within 1e-5 of max(1, |ref|) (matmuls and sums in
another order).  No model of either package calls the layer.  On the CPU
the kernel wrappers (P2 in the three sums over the destinations and in
the gathers' backwards) run their plain versions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepchem_tpu.feat import conformer_featurizers as jax_conformer
from deepchem_tpu.models import graph_layers as jax_layers
from deepchem_tpu.models.jax_model import _flatten_params
from deepchem_tpu_torch import EquivariantGraphFeaturizer
from deepchem_tpu_torch.chem import mol_from_smiles
from deepchem_tpu_torch.feat import BatchGraphData
from deepchem_tpu_torch.models import EGNNLayer, params_from_flax
from deepchem_tpu_torch.models.convert import flax_state
from deepchem_tpu_torch.ops import CooCsr, coo_csr

torch.set_num_threads(1)

SMILES = ['CCO', 'c1ccccc1O', 'C[C@H](N)C(=O)O', 'N#Cc1ccncc1', 'c1ccsc1',
          'FC(F)(F)c1ccc(Cl)cc1Br', 'C[N+](C)(C)CC(=O)[O-]', 'C']


def _scaled(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        1.0, np.abs(np.asarray(b)).max())


@pytest.mark.parametrize('kw', [{}, {'fully_connected': True},
                                {'weight_bins': [1.2, 1.45, 2.5]}])
def test_featurizer_equals_jax(kw):
    """Node one-hots and atomic numbers, the edges, the displacements, the
    positions and the binned lengths equal; a conformer given is kept."""
    ours = EquivariantGraphFeaturizer(**kw).featurize(SMILES)
    ref = jax_conformer.EquivariantGraphFeaturizer(**kw).featurize(SMILES)
    for smi, g, r in zip(SMILES, ours, ref, strict=True):
        for attr in ('node_features', 'edge_index', 'edge_features',
                     'node_pos_features', 'edge_weights'):
            a, b = getattr(g, attr), getattr(r, attr)
            assert a.dtype == b.dtype, (smi, attr)
            np.testing.assert_array_equal(a, b, err_msg=f'{smi} {attr}')
    assert ours[0].node_features.shape == (3, 7)
    assert ours[-1].num_edges == 0
    m = mol_from_smiles('CO')
    m.conformer = [(0.0, 0.0, 0.0), (1.43, 0.0, 0.0)]
    g = EquivariantGraphFeaturizer().featurize([m])[0]
    np.testing.assert_array_equal(g.edge_weights,
                                  [[0, 1, 0, 0, 0], [0, 1, 0, 0, 0]])
    np.testing.assert_allclose(g.edge_features, [[1.43, 0, 0],
                                                 [-1.43, 0, 0]], rtol=1e-6)


@pytest.fixture(scope='module')
def batch():
    """Six conformer graphs padded to 64 atoms and 128 edges (ghost edges
    from the last atom into itself), with the CSR of the edges."""
    graphs = EquivariantGraphFeaturizer().featurize(SMILES[:6])
    d = BatchGraphData(list(graphs)).pad(64, 128, num_graphs=6)
    src, dst = d['edge_index']
    csr = coo_csr(src, dst, 64)
    return d, src, dst, csr


@pytest.mark.parametrize('update_coords', [True, False])
@pytest.mark.parametrize('edge_input', [None, 'edge_weights',
                                        'edge_features'])
def test_layer_matches_flax(batch, update_coords, edge_input):
    """Outputs and every gradient (h, x, the edge inputs, each weight)
    from flax's initial weights within 1e-5 of max(1, |ref|), with and
    without the coordinate update and the edge inputs."""
    d, src, dst, csr_np = batch
    rng = np.random.RandomState(4)
    h = rng.randn(64, 8).astype(np.float32)
    x = d['node_pos_features']
    emask = d['edge_mask']
    ef = None
    if edge_input == 'edge_weights':
        ef = np.zeros((128, 5), np.float32)
        ef[:int(emask.sum())] = np.concatenate([
            g.edge_weights for g in EquivariantGraphFeaturizer().featurize(
                SMILES[:6])])
    elif edge_input == 'edge_features':
        ef = d['edge_features']
    gh = rng.randn(64, 8).astype(np.float32)
    gx = rng.randn(64, 3).astype(np.float32)
    flax_layer = jax_layers.EGNNLayer(16, update_coords=update_coords)
    j_idx = [jnp.asarray(a) for a in (src, dst, emask)]
    j_ef = None if ef is None else jnp.asarray(ef)
    params = flax_layer.init(jax.random.PRNGKey(0), jnp.asarray(h),
                             jnp.asarray(x), *j_idx, ef=j_ef)

    def f(p, hh, xx, ee):
        return flax_layer.apply(p, hh, xx, *j_idx, ef=ee)
    (h_ref, x_ref), vjp = jax.vjp(f, params, jnp.asarray(h), jnp.asarray(x),
                                  j_ef)
    g_p, g_h, g_x, g_e = vjp((jnp.asarray(gh), jnp.asarray(gx)))
    layer = EGNNLayer(8, 16, update_coords=update_coords,
                      edge_features=0 if ef is None else ef.shape[1])
    params_from_flax(_flatten_params(params), layer)
    th, tx = (torch.from_numpy(a.copy()).requires_grad_(True)
              for a in (h, x))
    te = None if ef is None else torch.from_numpy(ef).requires_grad_(True)
    csr = CooCsr(*(torch.from_numpy(a) for a in csr_np))
    out_h, out_x = layer(th, tx, torch.from_numpy(src).long(),
                         torch.from_numpy(dst).long(),
                         torch.from_numpy(emask), csr, ef=te)
    ((out_h * torch.from_numpy(gh)).sum()
     + (out_x * torch.from_numpy(gx)).sum()).backward()
    assert _scaled(out_h.detach().numpy(), h_ref) <= 1e-5
    assert _scaled(out_x.detach().numpy(), x_ref) <= 1e-5
    if not update_coords:
        assert out_x is tx
    assert _scaled(th.grad.numpy(), g_h) <= 1e-5
    assert _scaled(tx.grad.numpy(), g_x) <= 1e-5
    if te is not None:
        assert _scaled(te.grad.numpy(), g_e) <= 1e-5
    grads = dict(layer.named_parameters())
    want = flax_state(_flatten_params(g_p), layer)
    assert set(want) == set(grads)
    for key, v in want.items():
        assert _scaled(grads[key].grad.numpy(), v.numpy()) <= 1e-5, key


def test_layer_is_equivariant(batch):
    """A rotation and a shift of the coordinates rotate and shift the new
    coordinates and leave the new features, within 1e-5."""
    d, src, dst, csr_np = batch
    torch.manual_seed(0)
    layer = EGNNLayer(8, 16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():          # a coordinate step large enough to see
        layer.coord.weight.mul_(100.0)
    csr = CooCsr(*(torch.from_numpy(a) for a in csr_np))
    h = torch.from_numpy(np.random.RandomState(5).randn(64, 8).astype(
        np.float32))
    x = torch.from_numpy(d['node_pos_features'])
    q, _ = torch.linalg.qr(torch.randn(3, 3, generator=torch.Generator(
    ).manual_seed(2)))
    shift = torch.tensor([1.0, -2.0, 0.5])
    args = (torch.from_numpy(src).long(), torch.from_numpy(dst).long(),
            torch.from_numpy(d['edge_mask']), csr)
    with torch.no_grad():
        h1, x1 = layer(h, x, *args)
        h2, x2 = layer(h, x @ q.T + shift, *args)
    real = torch.from_numpy(d['node_mask']) > 0
    assert (x1 - x).abs().max() > 1e-3
    assert _scaled(h2.numpy(), h1.numpy()) <= 1e-5
    assert _scaled(x2[real].numpy(), (x1 @ q.T + shift)[real].numpy()) <= 1e-5


def test_coordinate_weight_is_drawn_as_flax_draws_it():
    """``variance_scaling(1e-3, 'fan_in', 'truncated_normal')``: within
    two standard deviations of sqrt(1e-3 / 64) / 0.8796 and near that
    spread, on both sides."""
    layer = EGNNLayer(8, 64, generator=torch.Generator().manual_seed(0))
    w = layer.coord.weight.detach().numpy().ravel()
    params = jax_layers.EGNNLayer(64).init(
        jax.random.PRNGKey(0), jnp.ones((4, 8)), jnp.ones((4, 3)),
        jnp.zeros(2, jnp.int32), jnp.ones(2, jnp.int32), jnp.ones(2))
    ref = np.asarray(params['params']['Dense_4']['kernel']).ravel()
    std = (1e-3 / 64) ** 0.5 / .87962566103423978
    for v in (w, ref):
        assert np.abs(v).max() <= 2 * std
        assert 0.5 * std <= v.std() <= 1.1 * std
