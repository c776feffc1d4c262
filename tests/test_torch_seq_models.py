"""The port's sequence models, their SMILES featurizers and the
sequence transformers against the JAX package's, on the CPU.

Same inputs, made with numpy from a seed or written inline, go through
the JAX function and the port's.  Tolerances: the featurizers, the
transformers and the batches equal; each model's outputs, loss and
every gradient from the same flax weights within 1e-5 of max(1, |ref|)
(float32 sums in another order); the per-step losses of a short ``fit``
within rtol 1e-4.  The GRUs run as one ``torch.gru`` call with flax's
cell (no r and z biases on the hidden side): a case counts the
parameters and shows that those halves stay zero through a step, where
torch's ``nn.GRU`` adds them and trains them.  The variational
autoencoder is held with the JAX module's draws replaced by the port's.
Sizes are small: GRU widths 4-8, a few filters, ten-odd SMILES.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepchem_tpu import feat as jax_feat
from deepchem_tpu.data import NumpyDataset as JaxNumpyDataset
from deepchem_tpu.models.bert_encoder import BertEncoderMLM as JaxEncoder
from deepchem_tpu.models.chemnet import Smiles2Vec as JaxSmiles2Vec
from deepchem_tpu.models.jax_model import _flatten_params
from deepchem_tpu.models.seqtoseq import \
    AspuruGuzikAutoEncoder as JaxAutoEncoder
from deepchem_tpu.models.seqtoseq import SeqToSeqModel as JaxSeqToSeq
from deepchem_tpu.models.text_cnn import TextCNNModel as JaxTextCNN
from deepchem_tpu.trans import transformers as jax_trans
from deepchem_tpu_torch import feat
from deepchem_tpu_torch.data import NumpyDataset
from deepchem_tpu_torch.models import (AspuruGuzikAutoEncoder,
                                       BertEncoderMLM, SeqToSeqModel,
                                       Smiles2Vec, TextCNNModel,
                                       encoder_params_from_flax,
                                       params_from_flax)
from deepchem_tpu_torch.models.convert import flax_state
from deepchem_tpu_torch.trans import (FeaturizationTransformer,
                                      RxnSplitTransformer)

torch.set_num_threads(1)

# tests/test_featurizer_goldens.py's and tests/test_feat_parity_methods.py's
# SMILES, then charges, stereo marks, two components and a bad one
SMILES = ['CCO', 'c1ccccc1', 'CC(=O)OC1=CC=CC=C1C(=O)O', 'CC', 'C/C=C/Cl',
          'C[N+](C)(C)CC(=O)[O-]', 'C[C@H](N)C(=O)O', '[Na+].[Cl-]',
          'FC(F)(F)c1ccc(Br)cc1', 'N#Cc1ccncc1', 'O=S(=O)(N)c1ccc(N)cc1',
          'C1CC2CCC1C2']


def _scaled(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


def flax_tree(module, inputs, seed=0):
    """A parameter tree of the flax ``module`` for ``inputs``, its
    structure and shapes from ``jax.eval_shape`` (nothing compiled), its
    values drawn with numpy: kernels normal over the square root of their
    fan-in, biases and other leaves normal at 0.1, LayerNorm scales about
    1, embeddings normal over the square root of their width."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), *[jnp.asarray(a) for a in inputs],
        training=False))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        z = rng.randn(*shape)
        if name == 'kernel':
            z = z / np.sqrt(np.prod(shape[:-1]))
        elif name == 'embedding':
            z = z / np.sqrt(shape[-1])
        elif name == 'scale':
            z = 1 + 0.1 * z
        else:
            z = 0.1 * z
        return z.astype(np.float32)
    return {'params': jax.tree_util.tree_map_with_path(
        draw, shapes['params'])}


def held_to_jax(ref, ours, batch, dataset, steps=3, lr=0.003,
                eps_steps=None):
    """From the flax tree in ``ref.params`` (loaded into ``ours``): the
    JAX module's outputs, loss and every gradient on ``batch`` (arrays of
    ``ref.default_generator``) by one jitted function, and its losses over
    ``steps`` steps on that batch under Adam written in numpy (optax's
    formula), against the port's eval outputs (1e-5 of max(1, |ref|)),
    step-1 loss (rtol 1e-5) and gradients (1e-5 of max(1, |g|)), and its
    ``fit`` of ``steps`` epochs of ``dataset`` (the batch's rows; rtol
    1e-4).  A variational model's draws are ``eps_steps``, one a step:
    the JAX module's ``jax.random.normal`` returns them."""
    j_in, j_lab, j_w = ([jnp.asarray(a) for a in part] for part in batch)

    def loss_fn(p, eps):
        if eps is None:
            out = ref.module.apply(p, *j_in, training=False)
        else:
            normal = jax.random.normal
            jax.random.normal = lambda key, shape: eps
            try:
                out = ref.module.apply(p, *j_in, training=True, rngs={
                    'dropout': jax.random.PRNGKey(0)})
            finally:
                jax.random.normal = normal
        out = _as_list(out)
        return ref._compute_loss(out, j_lab, j_w), out
    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    p = jax.tree.map(np.asarray, ref.params)
    mu = jax.tree.map(np.zeros_like, p)
    nu = jax.tree.map(np.zeros_like, p)
    ref_losses = []
    for t in range(1, steps + 1):
        (loss, o), g = step(p, None if eps_steps is None
                            else jnp.asarray(eps_steps[t - 1]))
        g = jax.tree.map(np.asarray, g)
        ref_losses.append(float(loss))
        if t == 1:
            ref_out, g_ref = o, g
        mu = jax.tree.map(lambda m, d: 0.9 * m + 0.1 * d, mu, g)
        nu = jax.tree.map(lambda v, d: 0.999 * v + 0.001 * d * d, nu, g)
        p = jax.tree.map(
            lambda w, m, v: w - lr * (m / (1 - 0.9 ** t)) / (
                np.sqrt(v / (1 - 0.999 ** t)) + 1e-8), p, mu, nu)
    assert sum(t.numel() for t in ours.module.parameters()) == sum(
        v.size for v in jax.tree_util.tree_leaves(ref.params))
    t_in, t_lab, t_w = ours._prepare_batch(tuple(
        [np.asarray(a) for a in part] for part in batch))
    t_eps = {} if eps_steps is None else {
        'eps': torch.from_numpy(np.asarray(eps_steps[0]))}
    ours.module.eval()
    with torch.no_grad():
        out = _as_list(ours.module(*t_in, **t_eps))
    assert len(out) == len(ref_out)
    for a, b in zip(out, ref_out):
        assert a.shape == b.shape
        assert _scaled(a.numpy(), b) <= 1e-5
    ours.module.train()
    value = ours._compute_loss(_as_list(ours.module(*t_in, **t_eps)),
                               t_lab, t_w)
    value.backward()
    np.testing.assert_allclose(value.item(), ref_losses[0], rtol=1e-5)
    grads = dict(ours.module.named_parameters())
    want = flax_state(_flatten_params(g_ref), ours.module)
    assert set(want) == set(grads)
    for key, g in want.items():
        assert _scaled(grads[key].grad.numpy(), g.numpy()) <= 1e-5, key
    losses = []
    ours.fit(dataset, nb_epoch=steps, checkpoint_interval=0,
             deterministic=True, all_losses=losses)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)


def _as_list(out):
    return out if isinstance(out, (list, tuple)) else [out]


def _as_list(out):
    return out if isinstance(out, (list, tuple)) else [out]


# ------------------------------------------------------- featurizers

@pytest.mark.parametrize('kw', [dict(), dict(max_length=12),
                                dict(charset=list('CcO()='), max_length=30),
                                dict(max_length=None)])
def test_one_hot_featurizer_matches_jax(kw):
    ours, ref = feat.OneHotFeaturizer(**kw), jax_feat.OneHotFeaturizer(**kw)
    smiles = SMILES if kw.get('max_length', 1) else SMILES[:1]
    X, R = ours.featurize(smiles), ref.featurize(smiles)
    assert X.dtype == R.dtype
    np.testing.assert_array_equal(X, R)
    for x, smi in zip(X, smiles):
        assert ours.untransform(x) == ref.untransform(x)
        assert ours.pad_smile(smi) == ref.pad_smile(smi)


@pytest.mark.parametrize('max_len,pad_len', [(250, 10), (20, 2), (8, 0)])
def test_smiles_to_seq_matches_jax(max_len, pad_len):
    vocab = feat.create_char_to_idx(SMILES, max_len)
    assert vocab == jax_feat.create_char_to_idx(SMILES, max_len)
    ours = feat.SmilesToSeq(vocab, max_len, pad_len)
    ref = jax_feat.SmilesToSeq(vocab, max_len, pad_len)
    X = ours.featurize(SMILES + ['CZC'])
    np.testing.assert_array_equal(X, ref.featurize(SMILES + ['CZC']))
    assert X.dtype == np.int32
    for x in X:
        assert ours.smiles_from_seq(x) == ref.smiles_from_seq(x)
    chars = list('CZc')
    np.testing.assert_array_equal(ours.to_seq(chars), ref.to_seq(chars))
    assert ours.remove_pad(list('<<CC>>')) == ref.remove_pad(list('<<CC>>'))


@pytest.mark.parametrize('size', [80, 31])
def test_smiles_to_image_matches_jax(size):
    """The layout over each component (``Molecule.components``) and the
    image; a SMILES that does not parse gives an empty array in both."""
    smiles = SMILES + ['C1CC']
    X = feat.SmilesToImage(img_size=size).featurize(smiles)
    R = jax_feat.SmilesToImage(img_size=size).featurize(smiles)
    assert X.dtype == R.dtype == object
    for a, b in zip(X, R):
        np.testing.assert_array_equal(a, b)
    X = feat.SmilesToImage(img_size=size).featurize(SMILES)
    assert X.shape == (len(SMILES), size, size, 1) and X.dtype == np.float32
    np.testing.assert_array_equal(
        X, jax_feat.SmilesToImage(img_size=size).featurize(SMILES))


def test_sequence_featurizers_and_transformers_match_jax():
    """``PositionFrequencyMatrix``, ``SparseMatrixOneHotFeaturizer``,
    ``FeaturizationTransformer`` and ``RxnSplitTransformer``."""
    seqs = [['ACGT', 'ACGA', 'TTNA'], 'GATTACA', ['AXC']]
    for kw in (dict(), dict(max_length=5, charset='ACGTX')):
        np.testing.assert_array_equal(
            feat.PositionFrequencyMatrix(**kw).featurize(seqs),
            jax_feat.PositionFrequencyMatrix(**kw).featurize(seqs))
    prots = ['MKTAYIAKQR', 'GGXJB']
    ours = feat.SparseMatrixOneHotFeaturizer().featurize(prots)
    ref = jax_feat.SparseMatrixOneHotFeaturizer().featurize(prots)
    for a, b, p in zip(ours, ref, prots):
        np.testing.assert_array_equal(a.toarray(), b.toarray())
        assert feat.SparseMatrixOneHotFeaturizer().untransform(a) == \
            jax_feat.SparseMatrixOneHotFeaturizer().untransform(b)
    X = np.array(SMILES[:5], dtype=object)
    y = np.arange(5.0)
    ours = FeaturizationTransformer(
        featurizer=feat.OneHotFeaturizer(max_length=20)).transform_array(
            X, y, y, X)
    ref = jax_trans.FeaturizationTransformer(
        featurizer=jax_feat.OneHotFeaturizer(max_length=20)).transform_array(
            X, y, y, X)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    rxns = np.array(['CC(=O)O.OCC>[H+]>CC(=O)OCC', 'C=C>>CC', 'CO>O'])
    for sep in (True, False):
        ours = RxnSplitTransformer(sep).transform_array(rxns, None, None,
                                                        rxns)
        ref = jax_trans.RxnSplitTransformer(sep).transform_array(
            rxns, None, None, rxns)
        np.testing.assert_array_equal(ours[0], ref[0])
    with pytest.raises(ValueError):
        FeaturizationTransformer()


# ------------------------------------------------------------- models

def _labels(n, n_tasks, kind, seed=1):
    rng = np.random.RandomState(seed)
    if kind == 'classification':
        return (rng.rand(n, n_tasks) > 0.5).astype(np.float32)
    return rng.randn(n, n_tasks).astype(np.float32)


def _smiles_data(kind, n_tasks=2):
    X = np.array(SMILES, dtype=object)
    return X, _labels(len(X), n_tasks, kind)


VOCAB = feat.create_char_to_idx(SMILES)
TOKENS = feat.SmilesToSeq(VOCAB, max_len=24, pad_len=2).featurize(SMILES)
CHAR_DICT, SEQ_LEN = JaxTextCNN.build_char_dict(
    JaxNumpyDataset(np.zeros(len(SMILES)), ids=np.array(SMILES)))
TEXT = dict(char_dict=CHAR_DICT, seq_length=SEQ_LEN, n_embedding=6,
            kernel_sizes=(1, 2, 3, 5), num_filters=(3, 4, 2, 3),
            dropout=0.0)
S2V = dict(char_to_idx=VOCAB, embedding_dim=6, filters=5, kernel_size=3,
           rnn_sizes=(4, 6), n_tasks=2)
SEQ_TOKENS = sorted(set(''.join(SMILES)))
# a pair of strings a SMILES, the output its reverse
PAIRS = [(s, s[::-1]) for s in SMILES]
S2S = dict(input_tokens=SEQ_TOKENS, output_tokens=SEQ_TOKENS,
           max_output_length=10, embedding_dimension=8, encoder_layers=2,
           decoder_layers=2)
AE = dict(tokens=SEQ_TOKENS, max_output_length=10, embedding_dimension=8,
          encoder_layers=2, decoder_layers=2, annealing_start_step=-10,
          annealing_final_step=-5)


def _pair_batches(model):
    """The JAX model's first batch of ``PAIRS`` and the rows it holds."""
    return next(model._sequence_batches(PAIRS, 4))


# name: (port class, JAX class, arguments of both, X, y, ids)
CASES = {
    'textcnn': (TextCNNModel, JaxTextCNN, dict(TEXT, n_tasks=2),
                *_smiles_data('classification')),
    'textcnn_regression': (TextCNNModel, JaxTextCNN,
                           dict(TEXT, n_tasks=1, mode='regression'),
                           *_smiles_data('regression', 1)),
    'smiles2vec': (Smiles2Vec, JaxSmiles2Vec, S2V, TOKENS,
                   _labels(len(TOKENS), 2, 'regression')),
    'smiles2vec_stride2_cls': (Smiles2Vec, JaxSmiles2Vec,
                               dict(S2V, strides=2, mode='classification'),
                               TOKENS, _labels(len(TOKENS), 2,
                                               'classification')),
    'seqtoseq': (SeqToSeqModel, JaxSeqToSeq, S2S, None, None),
    'autoencoder': (AspuruGuzikAutoEncoder, JaxAutoEncoder, AE, None, None),
}


def _pair(name):
    """A JAX model, a port model with the same flax parameters, the JAX
    model's first batch of 4 and the port's dataset of its rows."""
    model, ref_model, args, X, y = CASES[name]
    args = dict(args, batch_size=4, learning_rate=0.003, log_frequency=1)
    ref = ref_model(**args)
    ours = model(device='cpu', **args)
    if X is None:                           # sequence pairs
        batch = _pair_batches(ref)
        ds = NumpyDataset(batch[0][0], batch[1][0], batch[2][0])
        ours._max_input_length = ref._max_input_length
    else:
        ids = X if X.dtype == object else None
        ds_ref = JaxNumpyDataset(X, y, ids=ids)
        batch = next(ref.default_generator(ds_ref, deterministic=True))
        ds = NumpyDataset(X[:4], y[:4], ids=None if ids is None else X[:4])
    ref.params = flax_tree(ref.module, batch[0])
    params_from_flax(_flatten_params(ref.params), ours.module)
    return ref, ours, batch, ds


@pytest.mark.parametrize('name', sorted(CASES))
def test_sequence_model_matches_jax(name):
    """A batch of 4 from the same flax weights: parameter count and tree,
    outputs, loss, every gradient and 3 Adam steps (:func:`held_to_jax`);
    the autoencoder with the port's draws (its seed's generator) in the
    JAX module too, and its KL term weighted 1 (annealing over)."""
    ref, ours, batch, ds = _pair(name)
    eps = None
    if name == 'autoencoder':
        gen = torch.Generator().manual_seed(0)
        eps = [torch.randn(4, 8, generator=gen).numpy() for _ in range(3)]
    held_to_jax(ref, ours, batch, ds, eps_steps=eps)


def test_sequence_plumbing_matches_jax():
    """SeqToSeq's batches of string pairs (inputs reversed, pads) equal
    the JAX package's, ``fit_sequences`` gives ``fit``'s losses on them,
    and ``predict_from_sequences``, ``predict_embeddings`` and
    ``predict_from_embeddings`` answer as the JAX model's from the same
    weights."""
    ref, ours, _, _ = _pair('seqtoseq')
    for a, b in zip(ours._sequence_batches(PAIRS, 4),
                    ref._sequence_batches(PAIRS, 4)):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u[0], v[0])
    ref._built = True
    words = SMILES[:6]
    assert ours.predict_from_sequences(words) == \
        ref.predict_from_sequences(words)
    emb = ours.predict_embeddings(words)
    assert _scaled(emb, ref.predict_embeddings(words)) <= 1e-5
    assert ours.predict_from_embeddings(emb) == \
        ref.predict_from_embeddings(emb)
    other = SeqToSeqModel(device='cpu', **dict(S2S, batch_size=4,
                                               log_frequency=1,
                                               learning_rate=0.003))
    other.module.load_state_dict(ours.module.state_dict())
    a, b = [], []
    ours.fit_sequences(PAIRS, checkpoint_interval=0, all_losses=a)
    batches = list(other._sequence_batches(PAIRS, 4))
    other.fit_generator(iter(batches), checkpoint_interval=0, all_losses=b)
    assert len(a) == 3 and a == b


def test_gru_keeps_flax_cell_biases():
    """The port's GRU has flax's parameter count (no r and z biases on the
    hidden side); after an Adam step its hidden biases are still ``[0, 0,
    bias_hn]``: torch's ``nn.GRU`` loaded with them gives the port's
    outputs, and the state dict holds flax's leaves only.  Torch's own
    ``nn.GRU`` has the extra halves and moves them."""
    ref, ours, batch, ds = _pair('smiles2vec')
    flat = _flatten_params(ref.params)
    assert sum(p.numel() for p in ours.module.parameters()) == sum(
        v.size for v in flat.values())
    assert set(ours.module.state_dict()) == set(flax_state(flat,
                                                           ours.module))
    ours.fit(ds, nb_epoch=1, checkpoint_interval=0)
    gru = ours.module.grus[0]
    x = torch.randn(3, 7, 5, generator=torch.Generator().manual_seed(0))
    plain = torch.nn.GRU(5, 4, batch_first=True, bidirectional=True)
    H = 4
    with torch.no_grad():
        for suffix, cell in zip(('', '_reverse'), gru.cells):
            getattr(plain, 'weight_ih_l0' + suffix).copy_(cell.weight_ih)
            getattr(plain, 'weight_hh_l0' + suffix).copy_(cell.weight_hh)
            getattr(plain, 'bias_ih_l0' + suffix).copy_(cell.bias_ih)
            getattr(plain, 'bias_hh_l0' + suffix).copy_(
                torch.cat([torch.zeros(2 * H), cell.bias_hn]))
        np.testing.assert_array_equal(gru(x).numpy(), plain(x)[0].numpy())
    extra = sum(p.numel() for p in plain.parameters()) - sum(
        p.numel() for p in gru.parameters())
    assert extra == 2 * 2 * H           # r and z, both directions
    opt = torch.optim.Adam(plain.parameters(), lr=0.01)
    plain(x)[0].square().mean().backward()
    opt.step()
    assert plain.bias_hh_l0[:2 * H].abs().max() > 0


def test_text_cnn_vocabulary_tokens_and_dropout():
    """``build_char_dict`` and ``smiles_to_seq`` equal the JAX package's;
    dropout's masks come from a host generator seeded with the model's
    seed (two models of one seed train alike, eval is deterministic), and
    a request of SMILES strings is answered from its own tokens."""
    ds = NumpyDataset(np.zeros(len(SMILES)), ids=np.array(SMILES))
    assert TextCNNModel.build_char_dict(ds) == (CHAR_DICT, SEQ_LEN)
    args = dict(TEXT, n_tasks=2, dropout=0.5, batch_size=4)
    ref = JaxTextCNN(**args)
    runs = []
    for _ in range(2):
        m = TextCNNModel(device='cpu', **args)
        losses = []
        X, y = _smiles_data('classification')
        m.fit(NumpyDataset(X, y, ids=X), nb_epoch=2, checkpoint_interval=0,
              all_losses=losses)
        runs.append(losses)
    assert runs[0] == runs[1]
    for smi in SMILES:
        np.testing.assert_array_equal(m.smiles_to_seq(smi),
                                      ref.smiles_to_seq(smi))
    a = m.predict_on_batch(np.array(SMILES[:3], dtype=object))
    b = m.predict(NumpyDataset(np.array(SMILES[:3], dtype=object),
                               ids=np.array(SMILES[:3])))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, m.predict_on_batch(
        np.array(SMILES[:3], dtype=object)))


def test_encoder_layer_norm_dtype_matches_jax():
    """The encoder's ``ln_dtype``: LayerNorm input and output rounded to
    bfloat16, statistics in float32, as flax's.  From the same weights
    the logits' median distance to the JAX package's is at most 1e-6 and
    95 % lie within 1e-5; where float32 sums in another order land on the
    other side of a bfloat16 rounding the flip is carried on (at most 2e-3
    of max(1, |ref|) everywhere).  float32 LayerNorms miss: a median
    distance above 1e-3."""
    small = dict(vocab_size=40, hidden=32, layers=2, heads=4,
                 intermediate=64, max_positions=18)
    ids = np.random.RandomState(0).randint(4, 40, (8, 16)).astype(np.int32)
    jm = JaxEncoder(**small, ln_dtype=jnp.bfloat16)
    p = flax_tree(jm, [ids])
    ref = np.asarray(jax.jit(jm.apply)(p, jnp.asarray(ids)))
    dist = []
    for ln_dtype in (torch.bfloat16, torch.float32):
        m = BertEncoderMLM(device='cpu', **small, ln_dtype=ln_dtype)
        encoder_params_from_flax(_flatten_params(p), m)
        with torch.no_grad():
            dist.append(np.abs(m(torch.from_numpy(ids)).numpy() - ref))
    assert np.median(dist[0]) <= 1e-6 and (dist[0] <= 1e-5).mean() >= 0.95
    assert dist[0].max() / max(1.0, np.abs(ref).max()) <= 2e-3
    assert np.median(dist[1]) > 1e-3
