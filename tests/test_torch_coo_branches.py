"""The COO branches of the port's GraphConv, GCN, GAT, AttentiveFP, MPNN
and DMPNN against the JAX package's, on the CPU, and the segment repairs
under them.

Each model's class is switched to the COO formulation on both sides, as
``tests/test_graph_models.py`` switches the JAX package's
(``uses_neighbor_table``, ``uses_rev_slot`` or ``uses_edge_table`` set to
False), and the same inputs, written inline, go through the JAX model and
the port's from the same flax weights.  On the CPU each kernel wrapper (P1,
P2 both ways, P3, K3 both ways) runs its plain torch version.
Tolerances: outputs and every gradient within 1e-5 of max(1, |ref|)
(matmuls summed in another order), the per-epoch losses of a 2-epoch fit
(dropout 0) within 1e-4 relative, the port's COO path against its own
table path within 1e-5 of max(1, |ref|); the layers and ops within 1e-5
and 1e-6; ``segment_max``'s and ``graph_pool_max``'s special cases (a
NaN, an atom with no neighbour, ties after a ReLU) exact.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepchem_tpu.data import NumpyDataset as JaxNumpyDataset
from deepchem_tpu.feat import ConvMolFeaturizer as JaxConvMolFeaturizer
from deepchem_tpu.feat import DMPNNFeaturizer as JaxDMPNNFeaturizer
from deepchem_tpu.feat import \
    MolGraphConvFeaturizer as JaxMolGraphConvFeaturizer
from deepchem_tpu.models import AttentiveFPModel as JaxAttentiveFPModel
from deepchem_tpu.models import GATModel as JaxGATModel
from deepchem_tpu.models import GCNModel as JaxGCNModel
from deepchem_tpu.models import GraphConvModel as JaxGraphConvModel
from deepchem_tpu.models import MPNNModel as JaxMPNNModel
from deepchem_tpu.models.dmpnn import DMPNNModel as JaxDMPNNModel
from deepchem_tpu.models.graph_layers import \
    graph_pool_max as jax_graph_pool_max
from deepchem_tpu.models.jax_model import _flatten_params
from deepchem_tpu.ops import segment as jax_segment
from deepchem_tpu_torch import (AttentiveFPModel, ConvMolFeaturizer,
                                DMPNNFeaturizer, DMPNNModel, GATModel,
                                GCNModel, GraphConvModel,
                                MolGraphConvFeaturizer, MPNNModel,
                                NumpyDataset)
from deepchem_tpu_torch.models import graph_pool_max, params_from_flax
from deepchem_tpu_torch.models.convert import flax_state
from deepchem_tpu_torch.ops import (N_CSR, CooCsr, coo_csr, coo_degrees,
                                    dst_segment_softmax, gather_dst,
                                    gather_src, node_degrees, segment_max,
                                    segment_softmax)

torch.set_num_threads(1)

SMILES = ['C/C=C/C', 'C[C@H](N)C(=O)O', 'C[C@@H](N)C(=O)O', '[NH4+]',
          'C[N+](C)(C)CC(=O)[O-]', 'C', '[Na+].[Cl-]', 'CCO', 'c1ccccc1O',
          'CC(=O)Oc1ccccc1C(=O)O', 'FC(F)(F)c1ccc(Cl)cc1Br', 'N#Cc1ccncc1',
          'O=S(=O)(N)c1ccc(N)cc1', 'OP(=O)(O)OP(=O)(O)O', 'c1ccsc1',
          'Clc1ccc2c(c1)C(=NCC(=O)N2)c1ccccc1', 'Ic1ccc[nH]1',
          'O=C(O)/C=C/c1ccccc1', 'CC#N', 'O', 'CCCCOC(=O)c1ccccc1']
N_TASKS = 2
BASE = dict(n_tasks=N_TASKS, batch_size=10, log_frequency=3)
# name: (port class, JAX class, featurizer key, small sizes, COO switches)
MODELS = {
    'graphconv': (GraphConvModel, JaxGraphConvModel, 'conv',
                  dict(graph_conv_layers=(16, 12), dense_layer_size=16,
                       mode='regression'),
                  dict(uses_neighbor_table=False)),
    'gcn': (GCNModel, JaxGCNModel, 'graph',
            dict(graph_conv_layers=(16, 12), predictor_hidden_feats=16),
            dict(uses_neighbor_table=False)),
    'gat': (GATModel, JaxGATModel, 'graph',
            dict(graph_attention_layers=(8, 6), n_attention_heads=2,
                 predictor_hidden_feats=16),
            dict(uses_neighbor_table=False, uses_rev_slot=False)),
    'attentivefp': (AttentiveFPModel, JaxAttentiveFPModel, 'graph',
                    dict(num_layers=2, graph_feat_size=12),
                    dict(uses_neighbor_table=False, uses_rev_slot=False)),
    'mpnn': (MPNNModel, JaxMPNNModel, 'edges', dict(node_dim=8, T=2, M=2),
             dict(uses_edge_table=False)),
    'dmpnn': (DMPNNModel, JaxDMPNNModel, 'dmpnn',
              dict(enc_hidden=16, depth=3, ffn_hidden=12, ffn_layers=2),
              dict(uses_edge_table=False)),
}
FEATURIZERS = {
    'conv': (ConvMolFeaturizer, JaxConvMolFeaturizer, {}),
    'graph': (MolGraphConvFeaturizer, JaxMolGraphConvFeaturizer, {}),
    'edges': (MolGraphConvFeaturizer, JaxMolGraphConvFeaturizer,
              dict(use_edges=True)),
    'dmpnn': (DMPNNFeaturizer, JaxDMPNNFeaturizer, {}),
}


@contextlib.contextmanager
def coo(*classes, **flags):
    """Set ``flags`` on each class for the block, as the JAX package's
    tests switch a model to its COO branch, and restore them after."""
    old = [(c, {k: c.__dict__[k] for k in flags if k in c.__dict__})
           for c in classes]
    try:
        for c in classes:
            for k, v in flags.items():
                setattr(c, k, v)
        yield
    finally:
        for c, saved in old:
            for k in flags:
                if k in saved:
                    setattr(c, k, saved[k])
                else:
                    delattr(c, k)


_DATA = {}


def _data(kind):
    """The port's and the JAX dataset of ``SMILES`` with ``kind``'s
    featurizer, labels made from a seed, one label masked."""
    if kind not in _DATA:
        ours, theirs, kw = FEATURIZERS[kind]
        rng = np.random.RandomState(0)
        y = (rng.randn(len(SMILES), N_TASKS) * 3 + 5).astype(np.float32)
        w = np.ones_like(y)
        w[2, 1] = 0.0
        _DATA[kind] = (NumpyDataset(ours(**kw).featurize(SMILES), y, w),
                       JaxNumpyDataset(theirs(**kw).featurize(SMILES), y, w))
    return _DATA[kind]


def _pair(name, **kwargs):
    """A JAX model and a port model with the same initial parameters."""
    model, ref_model, kind, kw, _ = MODELS[name]
    ds, ds_ref = _data(kind)
    kw = {**BASE, **kw, **kwargs}
    ref = ref_model(data_parallel=False, **kw)
    ref.predict(ds_ref)                               # builds the params
    ours = model(device='cpu', **kw)
    params_from_flax(_flatten_params(ref.params), ours.module)
    return ref, ours


def _scaled(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        1.0, np.abs(np.asarray(b)).max())


def _port_step(model, batch):
    """The port's eval outputs and its gradients after one training step
    on ``batch``."""
    t_in, t_lab, t_w = model._prepare_batch(batch)
    model.module.eval()
    with torch.no_grad():
        out = model.module(*t_in)
    loss = model._train_step(t_in, t_lab, t_w)
    grads = {k: p.grad.numpy().copy()
             for k, p in model.module.named_parameters()}
    return out.numpy(), loss.item(), grads


@pytest.mark.parametrize('name', sorted(MODELS))
def test_coo_model_matches_jax_and_the_table_path(name):
    """The first batch through the JAX model's COO branch and the port's,
    from the same weights: outputs, loss and every gradient within 1e-5 of
    max(1, |ref|); the port's batch carries the CSR in the tables' place;
    and the port's table path from the same weights within 1e-5."""
    model, ref_model, kind, _, flags = MODELS[name]
    ds, ds_ref = _data(kind)
    ref, ours = _pair(name)
    table = _port_step(ours, next(ours.default_generator(ds)))
    params_from_flax(_flatten_params(ref.params), ours.module)
    with coo(model, ref_model, **flags):
        batch = next(ours.default_generator(ds))
        j_in, j_lab, j_w = next(ref.default_generator(ds_ref))
        out, loss, grads = _port_step(ours, batch)
    assert len(batch[0]) == 6 + N_CSR + (1 if name in ('mpnn', 'dmpnn')
                                         else 0)
    csr = CooCsr(*batch[0][6:6 + N_CSR])
    assert all(a.dtype == np.int32 for a in csr)
    j_in = [jnp.asarray(a) for a in j_in]
    # GraphConv's neighbour max splits its gradient at exact ties (atoms
    # of one symmetry class); jit may round such rows apart, so its JAX
    # side runs eagerly
    jit = (lambda f: f) if name == 'graphconv' else jax.jit
    ref_out = jit(lambda p: ref._forward(p, j_in, training=False,
                                             rng=None))(ref.params)[0]

    def loss_fn(p):
        outputs = ref._forward(p, j_in, training=True,
                               rng=jax.random.PRNGKey(0))
        return ref._compute_loss(outputs, [jnp.asarray(j_lab[0])],
                                 [jnp.asarray(j_w[0])])
    loss_ref, g_ref = jit(jax.value_and_grad(loss_fn))(ref.params)
    assert out.shape == (10, N_TASKS)
    assert _scaled(out, ref_out) <= 1e-5
    np.testing.assert_allclose(loss, float(loss_ref), rtol=1e-5)
    want = flax_state(_flatten_params(g_ref), ours.module)
    assert set(want) == set(grads)
    for key, g in want.items():
        assert _scaled(grads[key], g.numpy()) <= 1e-5, key
    # the table path from the same weights
    assert _scaled(out, table[0]) <= 1e-5
    np.testing.assert_allclose(loss, table[1], rtol=1e-5)
    for key, g in table[2].items():
        assert _scaled(grads[key], g) <= 1e-5, key


@pytest.mark.parametrize('name', sorted(MODELS))
def test_coo_fit_follows_the_jax_losses(name):
    """2 epochs of fit from the same weights with both classes switched to
    COO (3 batches of 10, the last short and padded), and the switch taking
    effect on a model that was fitted on the table path before."""
    model, ref_model, kind, _, flags = MODELS[name]
    ds, ds_ref = _data(kind)
    ref, ours = _pair(name, learning_rate=0.003)
    ours.predict(ds)
    with coo(model, ref_model, **flags):
        ref_losses, losses = [], []
        ref.fit(ds_ref, nb_epoch=2, checkpoint_interval=0,
                all_losses=ref_losses)
        ours.fit(ds, nb_epoch=2, checkpoint_interval=0, all_losses=losses)
        pred, ref_pred = ours.predict(ds), ref.predict(ds_ref)
        assert len(ours._fit_cache['host'][0][0]) >= 6 + N_CSR
    assert len(losses) == len(ref_losses) == 2
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert _scaled(pred, ref_pred) <= 1e-4
    # back on the table path, the cached batches are packed again
    ours.fit(ds, nb_epoch=1, checkpoint_interval=0)
    assert len(ours._fit_cache['host'][0][0]) < 6 + N_CSR


def _packed(name):
    model, _, kind, kw, flags = MODELS[name]
    with coo(model, **flags):
        return model(device='cpu', **BASE, **kw)._graph_inputs(
            _data(kind)[0].X[:10])


def test_coo_degrees_and_gathers_match_jax():
    """``coo_degrees`` equals ``node_degrees`` with the mask;
    ``gather_src`` and ``gather_dst`` equal ``jnp.take`` forward and in
    the gradient (P2 over the CSR by source or destination), within
    1e-6."""
    b = _packed('gcn')
    esrc, edst, emask = (torch.from_numpy(a) for a in (b[1], b[2], b[5]))
    csr = CooCsr(*(torch.from_numpy(a) for a in b[6:]))
    N = b[0].shape[0]
    assert torch.equal(coo_degrees(csr), node_degrees(edst, N, emask))
    rng = np.random.RandomState(2)
    x = rng.randn(N, 3, 2).astype(np.float32)
    w = rng.randn(len(esrc), 3, 2).astype(np.float32)
    for fn, ends in ((gather_src, esrc), (gather_dst, edst)):
        ref_g = jax.grad(lambda v: jnp.sum(jnp.take(v, ends.numpy(), axis=0)
                                           * w))(x)
        xt = torch.from_numpy(x).requires_grad_()
        out = fn(xt, ends, csr)
        (out * torch.from_numpy(w)).sum().backward()
        np.testing.assert_array_equal(out.detach().numpy(),
                                      x[ends.numpy()])
        np.testing.assert_allclose(xt.grad.numpy(), ref_g, atol=1e-6)


@pytest.mark.parametrize('heads', [None, 3])
def test_dst_segment_softmax_matches_jax(heads):
    """P1 over the destination order against ``segment_softmax`` with the
    edge mask (the ghost edges' weights 0): weights and the gradient of
    ``sum(y * w)`` within 1e-6."""
    b = _packed('gat')
    edst, emask = b[2], b[5]
    csr = CooCsr(*(torch.from_numpy(a) for a in b[6:]))
    rng = np.random.RandomState(3)
    shape = (len(edst),) if heads is None else (len(edst), heads)
    x = (rng.randn(*shape) * 4).astype(np.float32)
    w = rng.randn(*shape).astype(np.float32)

    def jax_fn(v):
        return jax_segment.segment_softmax(v, edst, b[0].shape[0],
                                           mask=emask)
    ref, ref_g = jax_fn(x), jax.grad(lambda v: jnp.sum(jax_fn(v) * w))(x)
    xt = torch.from_numpy(x).requires_grad_()
    y = dst_segment_softmax(xt, torch.from_numpy(emask), csr)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), ref_g, atol=1e-6)
    assert (y.detach().numpy()[emask == 0] == 0).all()


def test_graph_pool_max_coo_gives_jax_empty_segments_and_ties():
    """``graph_pool_max``'s COO branch on ReLU outputs, where a node and
    its neighbours' max are often both 0: an atom with no neighbour gets
    ``max(h, 0)``, and each tie splits the cotangent between ``h`` and the
    neighbour max as ``jnp.maximum`` does (half each), exactly."""
    b = _packed('graphconv')
    nf, esrc, edst, emask = b[0], b[1], b[2], b[5]
    csr = CooCsr(*(torch.from_numpy(a) for a in b[6:]))
    rng = np.random.RandomState(4)
    h = np.maximum(rng.randn(nf.shape[0], 6), 0).astype(np.float32)
    h[:, 0] = 0.0                         # every node ties in column 0
    w = rng.randn(*h.shape).astype(np.float32)
    deg = node_degrees(torch.from_numpy(edst), nf.shape[0],
                       torch.from_numpy(emask)).numpy()
    lone = np.flatnonzero(deg[:-1] == 0)
    assert len(lone) >= 2                 # 'C', 'O' and the ions
    h[lone[0]] = -np.abs(rng.randn(6))    # no neighbour: max(h, 0) = 0

    def jax_fn(v):
        return jax_graph_pool_max(v, esrc, edst, emask)
    ref, ref_g = jax_fn(h), jax.grad(lambda v: jnp.sum(jax_fn(v) * w))(h)
    ht = torch.from_numpy(h).requires_grad_()
    coo_in = (torch.from_numpy(esrc).long(), torch.from_numpy(edst).long(),
              torch.from_numpy(emask), csr)
    out = graph_pool_max(ht, None, None, coo_in)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    assert (out.detach().numpy()[lone[0]] == 0).all()
    np.testing.assert_allclose(ht.grad.numpy(), ref_g, atol=1e-6, rtol=0)
    # no neighbour and h < 0: the 0 side wins, no gradient; no neighbour
    # and h == 0: a tie, half the cotangent, as jnp.maximum gives it
    assert (ht.grad.numpy()[lone[0]] == 0).all()
    assert ht.grad.numpy()[lone[1], 0] == np.float32(0.5) * w[lone[1], 0] \
        == np.asarray(ref_g)[lone[1], 0]


def test_segment_max_gives_empty_value_at_nan():
    """A segment ``[NaN, 1]`` gives ``empty_value``, as the JAX package's
    ``segment_max`` (its max is NaN, not finite); the others their max."""
    x = np.array([np.nan, 1.0, 2.0, -3.0, 5.0], np.float32)
    ids = np.array([0, 0, 1, 1, 3])
    ours = segment_max(torch.from_numpy(x), torch.from_numpy(ids), 4)
    ref = jax_segment.segment_max(jnp.asarray(x), jnp.asarray(ids), 4)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(ours.numpy(), [0.0, 2.0, 0.0, 5.0])


def test_segment_softmax_gradient_matches_jax():
    """The plain ``segment_softmax`` holds no gradient through the segment
    max, as JAX's ``stop_gradient``: weights and the gradient of ``sum(y
    * w)`` (ids in any order, a masked logit, a NaN-free segment of equal
    logits) within 1e-6, and no gradient path through the max."""
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 6, 40)
    x = (rng.randn(40, 2) * 3).astype(np.float32)
    x[ids == 2] = 1.5
    mask = (rng.rand(40) > 0.2).astype(np.float32)
    w = rng.randn(40, 2).astype(np.float32)

    def jax_fn(v):
        return jax_segment.segment_softmax(v, ids, 7, mask=mask)
    ref, ref_g = jax_fn(x), jax.grad(lambda v: jnp.sum(jax_fn(v) * w))(x)
    xt = torch.from_numpy(x).requires_grad_()
    y = segment_softmax(xt, torch.from_numpy(ids), 7,
                        mask=torch.from_numpy(mask))
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), ref_g, atol=1e-6)
    names = set()
    fn = y.grad_fn
    stack = [fn]
    while stack:
        f = stack.pop()
        if f is None or f in names:
            continue
        names.add(f)
        stack += [g for g, _ in f.next_functions]
    assert not any('ScatterReduce' in type(f).__name__ for f in names)


def test_coo_csr_ships_the_source_order():
    """``perm_src``: the edge ids in stable source order, beside the
    destination order."""
    src = np.array([2, 0, 2, 1, 0], np.int32)
    dst = np.array([1, 1, 0, 1, 2], np.int32)
    a = CooCsr(*coo_csr(src, dst, 4))
    np.testing.assert_array_equal(a.perm_src, [1, 4, 3, 0, 2])
    np.testing.assert_array_equal(src[a.perm_src], np.sort(src))
