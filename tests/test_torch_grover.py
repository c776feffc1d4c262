"""The port's GROVER against the JAX package's, on the CPU, in both batch
layouts.

Same molecules go through both packages; the flax parameters of one JAX
build per task are carried into the port (``grover_params_from_flax``),
one tree serving both layouts.  On the CPU K1 runs its plain version
(every slot summed, pad slots at the ghost row 0) and P2 and P3 theirs.
Tolerances: the featurizer's arrays, the vocabularies, the masks and the
packed batches are equal (no arithmetic); outputs and every gradient
within 1e-5 of max(1, |ref|) (matmuls summed in another order); the four
custom VJPs' and the gathers' cotangents within 1e-6 of ``jax.vjp``'s,
ghost row included; three ``fit`` steps' losses within rtol 1e-4 of
three steps of the JAX model's optax Adam.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepchem_tpu.chem import mol_from_smiles as jax_mol_from_smiles
from deepchem_tpu.data import NumpyDataset as JaxNumpyDataset
from deepchem_tpu.feat.graph_data import GraphData as JaxGraphData
from deepchem_tpu.models import grover as JG
from deepchem_tpu.models.jax_model import _flatten_params
from deepchem_tpu_torch.chem import mol_from_smiles
from deepchem_tpu_torch.data import NumpyDataset
from deepchem_tpu_torch.feat.graph_data import GraphData
from deepchem_tpu_torch.models import grover as G
from deepchem_tpu_torch.models.convert import (grover_params_from_flax,
                                               grover_state)

torch.set_num_threads(1)

# a single atom (no bond), rings, a branch, a carboxylic acid, an ester
SMILES = ['CCO', 'c1ccccc1', 'CC(=O)Nc1ccc(O)cc1', 'C',
          'CC(C)CC1=CC=C(C=C1)C(C)C(=O)O', 'OC(=O)c1ccccc1OC(C)=O']
SMALL = dict(hidden_size=16, depth=2, num_mt_block=1, num_heads=2,
             batch_size=len(SMILES))
N_TASKS = 2
# (task, mode) of each JAX build
KINDS = {'pretraining': ('pretraining', 'regression'),
         'regression': ('finetuning', 'regression'),
         'classification': ('finetuning', 'classification')}


@pytest.fixture(scope='module')
def feat():
    mols = [mol_from_smiles(s) for s in SMILES]
    jmols = [jax_mol_from_smiles(s) for s in SMILES]
    av, bv = G.GroverAtomVocabularyBuilder(), G.GroverBondVocabularyBuilder()
    av.build(mols)
    bv.build(mols)
    jav = JG.GroverAtomVocabularyBuilder()
    jbv = JG.GroverBondVocabularyBuilder()
    jav.build(jmols)
    jbv.build(jmols)
    X = G.GroverFeaturizer(atom_vocab=av, bond_vocab=bv).featurize(SMILES)
    jX = JG.GroverFeaturizer(atom_vocab=jav,
                             bond_vocab=jbv).featurize(SMILES)
    y = np.random.RandomState(0).randint(
        0, 2, (len(SMILES), N_TASKS)).astype(np.float32)
    return dict(X=X, jX=jX, av=av, bv=bv, jav=jav, jbv=jbv, y=y)


def test_featurizer_and_vocabularies_match_jax(feat, tmp_path):
    assert feat['av'].stoi == feat['jav'].stoi
    assert feat['bv'].stoi == feat['jbv'].stoi
    keys = ('node_features', 'edge_index', 'edge_features',
            'atom_vocab_label', 'bond_vocab_label', 'fg_label')
    for smi, a, b in zip(SMILES, feat['X'], feat['jX'], strict=True):
        for k in keys:
            x, r = getattr(a, k), getattr(b, k)
            assert x.dtype == r.dtype, (smi, k)
            np.testing.assert_array_equal(x, r, err_msg=f'{smi} {k}')
    methane = feat['X'][3]
    assert methane.num_edges == 0 and methane.edge_features.shape == (0, 6)
    # save and load, and a build from a CSV of SMILES
    path = str(tmp_path / 'vocab.json')
    feat['av'].save(path)
    assert G.GroverAtomVocabularyBuilder.load(path).stoi == feat['av'].stoi
    csv_path = tmp_path / 'mols.csv'
    csv_path.write_text('smiles,y\n' + ''.join(f'{s},1\n' for s in SMILES))
    for cls, jcls in ((G.GroverAtomVocabularyBuilder,
                       JG.GroverAtomVocabularyBuilder),
                      (G.GroverBondVocabularyBuilder,
                       JG.GroverBondVocabularyBuilder)):
        ours, ref = cls(max_size=5), jcls(max_size=5)
        ours.build_from_csv(str(csv_path))
        ref.build_from_csv(str(csv_path))
        assert ours.stoi == ref.stoi and ours.size == 6
    for fn in ('atom_vocab_random_mask', 'bond_vocab_random_mask'):
        vocab = feat['av' if fn.startswith('atom') else 'bv']
        jvocab = feat['jav' if fn.startswith('atom') else 'jbv']
        assert getattr(G.GroverModel, fn)(vocab, SMILES, seed=3) \
            == getattr(JG.GroverModel, fn)(jvocab, SMILES, seed=3)


def _models(feat, kind, packed, **kw):
    task, mode = KINDS[kind]
    common = dict(SMALL, task=task, mode=mode, n_tasks=N_TASKS, **kw)
    ref = JG.GroverModel(atom_vocab=feat['jav'], bond_vocab=feat['jbv'],
                         packed=packed, **common)
    model = G.GroverModel(atom_vocab=feat['av'], bond_vocab=feat['bv'],
                          packed=packed, device='cpu', **common)
    return ref, model


_PARAMS = {}


def _pair(feat, kind, packed, **kw):
    """A JAX model and a port model with one flax tree a task (drawn once,
    from the flat layout's inputs; each model gets a copy)."""
    ref, model = _models(feat, kind, packed, **kw)
    if kind not in _PARAMS:
        flat = _models(feat, kind, False)[0]
        inputs = [jnp.asarray(a) for a in flat._graph_inputs(feat['jX'])]
        init = jax.jit(lambda *a: flat.module.init(jax.random.PRNGKey(7),
                                                    *a, training=False))
        _PARAMS[kind] = jax.tree.map(np.asarray, init(*inputs))
    ref.params = jax.tree.map(jnp.asarray, _PARAMS[kind])
    grover_params_from_flax(_flatten_params(ref.params), model.module)
    return ref, model


@pytest.mark.parametrize('packed', [False, True])
def test_packed_batches_match_jax(feat, packed):
    ref, model = _models(feat, 'pretraining', packed)
    ours = model._graph_inputs(feat['X'])
    want = ref._graph_inputs(feat['jX'])
    assert len(ours) == (10 if packed else 10 + G.N_FLAT_CSR)
    for i, (a, b) in enumerate(zip(ours, want)):
        assert a.dtype == b.dtype, i
        np.testing.assert_array_equal(a, b, err_msg=str(i))
    labels = next(model.default_generator(NumpyDataset(feat['X'])))[1]
    jlabels = next(ref.default_generator(JaxNumpyDataset(feat['jX'])))[1]
    for a, b in zip(labels, jlabels, strict=True):
        np.testing.assert_array_equal(a, b)


def test_flat_packer_drops_incoming_bonds_past_eight():
    """A star of ten bonds: the JAX packer keeps an atom's first eight
    incoming bonds and drops the rest silently; so does the port's (its
    CSRs describe the tables as packed)."""
    n = 11
    ei = np.array([e for k in range(1, n) for e in ((0, k), (k, 0))]).T
    rng = np.random.RandomState(1)
    nf = rng.rand(n, 75).astype(np.float32)
    ef = rng.rand(20, 6).astype(np.float32)
    ours = G.GroverModel(device='cpu', packed=False, batch_size=2,
                         **{k: v for k, v in SMALL.items()
                            if k != 'batch_size'})._graph_inputs(
        [GraphData(nf, ei, ef)])
    want = JG.GroverModel(packed=False, batch_size=2,
                          **{k: v for k, v in SMALL.items()
                             if k != 'batch_size'})._graph_inputs(
        [JaxGraphData(nf, ei, ef)])
    for a, b in zip(ours, want):
        np.testing.assert_array_equal(a, b)
    a2b = ours[2]
    assert (a2b[1] > 0).sum() == 8                  # the hub: 8 of 10 kept
    assert (a2b[2:n + 1] > 0).sum() == 10


def _scaled(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


@pytest.mark.parametrize('packed', [False, True], ids=['flat', 'packed'])
@pytest.mark.parametrize('kind', list(KINDS))
def test_outputs_gradients_and_fit_match_jax(feat, kind, packed):
    """From the same weights: the outputs, the loss and every gradient of
    step 1, and three ``fit`` steps' losses (one batch of six,
    log_frequency 1) against three steps of the JAX model's loss and
    gradient (one jitted function) under Adam's update written in numpy
    (optax's formula, lr 0.003)."""
    ref, model = _pair(feat, kind, packed, learning_rate=0.003,
                       log_frequency=1)
    ds = NumpyDataset(feat['X'], feat['y'])
    inputs, labels, weights = next(model.default_generator(ds))
    j_in = [jnp.asarray(a) for a in inputs[:10]]
    j_lab = [jnp.asarray(a) for a in labels]
    j_w = [jnp.asarray(a) for a in weights]

    def loss_fn(p):
        out = ref._forward(p, j_in, True, jax.random.PRNGKey(0))
        return ref._compute_loss(out, j_lab, j_w), out

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    p = jax.tree.map(np.asarray, ref.params)
    mu = jax.tree.map(np.zeros_like, p)
    nu = jax.tree.map(np.zeros_like, p)
    ref_losses = []
    for t in range(1, 4):
        (loss, o), g = step(p)
        g = jax.tree.map(np.asarray, g)
        ref_losses.append(float(loss))
        if t == 1:
            ref_out, g_ref = o, g
        mu = jax.tree.map(lambda m, d: 0.9 * m + 0.1 * d, mu, g)
        nu = jax.tree.map(lambda v, d: 0.999 * v + 0.001 * d * d, nu, g)
        p = jax.tree.map(
            lambda w, m, v: w - 0.003 * (m / (1 - 0.9 ** t)) / (
                np.sqrt(v / (1 - 0.999 ** t)) + 1e-8), p, mu, nu)
    t_in = model._prepare_batch((inputs, labels, weights))[0]
    with torch.no_grad():
        out = model.module(*t_in)
    assert len(out) == len(ref_out) == {'pretraining': 8, 'regression': 3,
                                        'classification': 4}[kind]
    for i, (a, b) in enumerate(zip(out, ref_out)):
        assert tuple(a.shape) == b.shape, i
        assert _scaled(a.numpy(), b) <= 1e-5, i
    grads, losses = {}, []

    def grab(m, step):
        if step == 1:
            grads.update({n: p.grad for n, p in
                          m.module.named_parameters()})
    model.fit(ds, nb_epoch=3, checkpoint_interval=0, all_losses=losses,
              callbacks=grab)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    np.testing.assert_allclose(losses[0], ref_losses[0], rtol=1e-5)
    want = grover_state(_flatten_params(g_ref))
    assert set(want) == set(grads)
    for key, g in want.items():
        # finetuning leaves the to-bond outputs unread: no gradient here,
        # zeros there
        got = grads[key]
        assert got is not None or not g.abs().max() > 0, key
        got = torch.zeros_like(g) if got is None else got
        assert _scaled(got.numpy(), g.numpy()) <= 1e-5, key


@pytest.mark.parametrize('kind', ['pretraining', 'classification'])
def test_flat_equals_packed(feat, kind):
    """The two layouts from one parameter tree: every output at the same
    atom, bond and molecule."""
    outs = {}
    for packed in (False, True):
        task, mode = KINDS[kind]
        model = G.GroverModel(atom_vocab=feat['av'], bond_vocab=feat['bv'],
                              packed=packed, device='cpu', task=task,
                              mode=mode, n_tasks=N_TASKS, **SMALL)
        inputs = model._prepare_batch(next(model.default_generator(
            NumpyDataset(feat['X'], feat['y']))))[0]
        with torch.no_grad():
            outs[packed] = ([t.shape[0] for t in inputs[:2]],
                            [o.numpy() for o in model.module(*inputs)])
    (_, flat), ((NA, NE), packed) = outs[False], outs[True]
    B = len(SMILES)
    A, E = NA // B, NE // B
    nmap = np.concatenate([np.arange(i * A, i * A + g.num_nodes)
                           for i, g in enumerate(feat['X'])])
    emap = np.concatenate([np.arange(i * E, i * E + g.num_edges)
                           for i, g in enumerate(feat['X'])])
    if kind == 'pretraining':
        for f, p, m in zip(flat[:4], packed[:4], (nmap, nmap, emap, emap)):
            np.testing.assert_allclose(f[1:1 + len(m)], p[m], atol=1e-5)
        pairs = zip(flat[4:], packed[4:])
    else:
        pairs = zip(flat, packed)
    for f, p in pairs:
        np.testing.assert_allclose(f, p, atol=1e-5)


def _flat_tables(feat):
    _, model = _models(feat, 'pretraining', False)
    arrs = [torch.from_numpy(a) for a in model._graph_inputs(feat['X'])]
    a2b, b2a, b2revb, a2a = arrs[2], arrs[3], arrs[4], arrs[5]
    return G.FlatGraph(a2b, b2a, b2revb, a2a, arrs[10:], 3), arrs


def _vjp_case(fn_t, fn_j, x, g):
    """The port's output and input cotangent against ``jax.vjp``'s."""
    xt = torch.from_numpy(x).requires_grad_()
    out = fn_t(xt)
    out.backward(torch.from_numpy(g))
    ref_out, vjp = jax.vjp(fn_j, jnp.asarray(x))
    ref_dx, = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out.detach().numpy(), ref_out, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), ref_dx, atol=1e-6)
    return xt.grad.numpy(), np.asarray(ref_dx)


def test_custom_vjps_match_jax_vjp(feat):
    """The four custom VJPs, each input cotangent against ``jax.vjp`` of
    the JAX function (its custom VJP, not the transpose), ghost row 0
    included; the grouped twins over three groups."""
    graph, arrs = _flat_tables(feat)
    a2b, b2a, b2revb, a2a = (arrs[i].numpy() for i in (2, 3, 4, 5))
    rev_dst = b2a[b2revb]
    N, E, H, Gn = len(a2a), len(b2a), 5, 3
    rng = np.random.RandomState(0)

    def r(*shape):
        return rng.randn(*shape).astype(np.float32)
    ja2a, ja2b, jrd = (jnp.asarray(t) for t in (a2a, a2b, rev_dst))
    dx, ref = _vjp_case(lambda x: G.nei_sum_sym(x, graph.a2a),
                        lambda x: JG._nei_sum_sym(x, ja2a), r(N, H),
                        r(N, H))
    assert np.abs(ref[0]).max() > 0          # the ghost row's cotangent
    dx, ref = _vjp_case(lambda x: G.nei_sum_bonds(x, graph.a2b,
                                                  graph.rev_dst),
                        lambda x: JG._nei_sum_bonds(x, ja2b, jrd), r(E, H),
                        r(N, H))
    assert np.abs(ref[0]).max() > 0
    _vjp_case(lambda x: G.nei_sum_sym_g(x, graph.a2a),
              lambda x: JG._nei_sum_sym_g(x, ja2a), r(Gn, N, H),
              r(Gn, N, H))
    _vjp_case(lambda x: G.nei_sum_bonds_g(x, graph.a2b, graph.rev_dst),
              lambda x: JG._nei_sum_bonds_g(x, ja2b, jrd), r(Gn, E, H),
              r(Gn, N, H))
    # the same through the batch's prebuilt offset tables
    _vjp_case(lambda x: G.nei_sum_bonds_g(x, graph.a2b, graph.rev_dst,
                                          graph.a2b_g),
              lambda x: JG._nei_sum_bonds_g(x, ja2b, jrd), r(3, E, H),
              r(3, N, H))


def test_gathers_and_to_bond_sums_match_jax_transposes(feat):
    """The flat layout's gathers (by b2a, b2revb and the bonds'
    destinations) and to-bond slot sums, whose backward is P2 over the
    batch's CSRs: their cotangents are JAX's scatter-add transposes, row
    0 collecting every pad slot's."""
    graph, arrs = _flat_tables(feat)
    a2b, b2a, b2revb, a2a = (arrs[i].numpy() for i in (2, 3, 4, 5))
    N, E, H = len(a2a), len(b2a), 4
    rng = np.random.RandomState(1)
    alfb = np.concatenate([b2a[:, None], a2a[b2a]], axis=1)
    blfb = a2b[b2a]
    cases = [
        (N, lambda x: G.gather_rows(x, graph.b2a, *graph.b2a_csr),
         lambda x: jnp.take(x, b2a, axis=0)),
        (E, lambda x: G.gather_rows(x, graph.b2revb, *graph.revb_csr),
         lambda x: jnp.take(x, b2revb, axis=0)),
        (N, lambda x: G.gather_rows(x, graph.rev_dst, *graph.dst_csr),
         lambda x: jnp.take(x, b2a[b2revb], axis=0)),
        (N, lambda x: G.slot_sum(x, graph.alfb, *graph.alfb_csr),
         lambda x: JG._nei_sum(x, alfb)),
        (E, lambda x: G.slot_sum(x, graph.blfb, *graph.blfb_csr),
         lambda x: JG._nei_sum(x, blfb))]
    for rows, fn_t, fn_j in cases:
        out_rows = fn_j(jnp.zeros((rows, H))).shape[0]
        dx, ref = _vjp_case(fn_t, fn_j, rng.randn(rows, H).astype(np.float32),
                            rng.randn(out_rows, H).astype(np.float32))
    # b2revb sends the ghost and each pad slot to row 0
    assert (b2revb[arrs[8].numpy() == 0] == 0).all()
    for G3, csr, idx in ((graph.b2a_csr_g, graph.b2a, b2a),
                         (graph.revb_csr_g, graph.b2revb, b2revb)):
        rows = N if idx is b2a else E
        _vjp_case(lambda x: G.gather_rows_g(x, csr, G3),
                  lambda x: jnp.take(x, idx, axis=1),
                  rng.randn(3, rows, H).astype(np.float32),
                  rng.randn(3, E, H).astype(np.float32))


def test_grouped_mpn_and_remat(feat):
    """``_GroverGroupedMPN`` refuses depth 1, as the JAX module does; every
    ``remat`` level gives the same outputs and gradients."""
    with pytest.raises(ValueError, match='depth >= 2'):
        G._GroverGroupedMPN(6, 16, 1, True)
    grads = {}
    for remat in ('none', 'qkv', 'block', 'both'):
        model = G.GroverModel(atom_vocab=feat['av'], bond_vocab=feat['bv'],
                              packed=False, device='cpu', task='pretraining',
                              remat=remat, **SMALL)
        batch = model._prepare_batch(next(model.default_generator(
            NumpyDataset(feat['X']))))
        model._train_step(*batch)
        grads[remat] = {n: p.grad.clone() for n, p in
                        model.module.named_parameters()}
    for remat in ('qkv', 'block', 'both'):
        for n, g in grads['none'].items():
            torch.testing.assert_close(grads[remat][n], g, rtol=0,
                                       atol=1e-7)


@pytest.mark.parametrize('atom_messages', [True, False])
@pytest.mark.parametrize('packed', [False, True], ids=['flat', 'packed'])
def test_per_head_mpn_matches_jax(feat, packed, atom_messages):
    """``_GroverMPN`` (one head's encoder, with its input layer) from the
    same weights: output and input gradient."""
    _, model = _models(feat, 'pretraining', packed)
    arrs = model._graph_inputs(feat['X'])
    msgs = arrs[0] if atom_messages else arrs[1]
    a2nei = arrs[5] if atom_messages else arrs[2]
    mask = arrs[7] if atom_messages else arrs[8]
    jmod = JG._GroverMPN(8, 3, atom_messages, input_layer='fc',
                         packed=packed)
    j_args = [jnp.asarray(a) for a in (msgs, a2nei, arrs[3], arrs[4], mask)]
    params = jax.jit(lambda *a: jmod.init(jax.random.PRNGKey(3), *a))(
        *j_args)
    mod = G._GroverMPN(8, 3, atom_messages, input_layer='fc',
                       packed=packed, in_features=msgs.shape[1])
    flat = _flatten_params(params)
    mod.load_state_dict({k: v for k, v in grover_state(flat).items()})
    graph = None if packed else G.FlatGraph(
        *(torch.from_numpy(arrs[i]) for i in (2, 3, 4, 5)),
        [torch.from_numpy(a) for a in arrs[10:]], 3)
    x = torch.from_numpy(msgs).requires_grad_()
    out = mod(x, torch.from_numpy(a2nei), torch.from_numpy(arrs[3]), graph,
              torch.from_numpy(mask))
    out.pow(2).sum().backward()

    def f(m):
        y = jmod.apply(params, m, *j_args[1:])
        return jnp.sum(y ** 2), y
    ref_dx, ref_out = jax.jit(jax.grad(f, has_aux=True))(j_args[0])
    assert _scaled(out.detach().numpy(), ref_out) <= 1e-5
    assert _scaled(x.grad.numpy(), ref_dx) <= 1e-5


def test_component_transfer_across_layouts(feat, tmp_path):
    """A flat pretraining model's encoder saved by components and loaded
    into a packed finetuning model: the encoder's weights arrive, and its
    answers equal the JAX finetuning model's with the same encoder."""
    ref_pre, pre = _pair(feat, 'pretraining', False)
    ref_ft, ft = _pair(feat, 'classification', True)
    pre.save_components(str(tmp_path))
    ft.load_components(str(tmp_path), components=['encoder'])
    enc = {k: v for k, v in pre.module.state_dict().items()
           if k.startswith('encoder.')}
    for k, v in ft.module.state_dict().items():
        if k.startswith('encoder.'):
            assert torch.equal(v, enc[k]), k
    merged = jax.tree.map(lambda a: a, ref_ft.params)
    merged['params'] = dict(merged['params'])
    merged['params']['encoder'] = ref_pre.params['params']['encoder']
    want = jax.jit(lambda p, *a: ref_ft.module.apply(p, *a, training=False))(
        merged, *[jnp.asarray(a) for a in ref_ft._graph_inputs(feat['jX'])])
    got = ft.predict_on_batch(feat['X'])
    assert _scaled(got, np.asarray(want[0])) <= 1e-5
    # a short request packs a block a molecule, with the same answers
    np.testing.assert_allclose(ft.predict_on_batch(feat['X'][1:3]),
                               got[1:3], rtol=0, atol=1e-6)
    assert 'heads' in ft.components and 'encoder' in ft.components
