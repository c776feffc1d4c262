"""The port's BertEncoderMLM against the JAX package's, on the CPU.

The model is tests/test_round3_fixes.py's: vocabulary 40, hidden 32, 2
layers, 4 heads, intermediate 64, 18 positions, batch 8 of 16 tokens, in
float32.  Parameters come from the flax model through
``encoder_params_from_flax``, so both sides start from the same weights.
Tolerances: logits and gradients atol 1e-5 (float32 sums in another
order), the loss atol 1e-6 (the same formula), AdamW loss trajectories
rtol 1e-4 (those differences, carried through a few steps).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deepchem_tpu.feat.tokenizers import SmilesTokenizer as JaxTokenizer
from deepchem_tpu.models.bert_encoder import BertEncoderMLM as JaxEncoder
from deepchem_tpu.models.bert_encoder import mlm_loss as jax_mlm_loss
from deepchem_tpu.models.jax_model import _flatten_params
from deepchem_tpu.models.optimizers import AdamW as JaxAdamW
from deepchem_tpu_torch import BertEncoderMLM, SmilesTokenizer
from deepchem_tpu_torch.models import (AdamW, encoder_params_from_flax,
                                       mlm_loss)

torch.set_num_threads(1)

V, B, S = 40, 8, 16
SMALL = dict(vocab_size=V, hidden=32, layers=2, heads=4, intermediate=64,
             max_positions=S + 2)


@pytest.fixture(scope='module')
def flax_model():
    rng = np.random.RandomState(0)
    ids = rng.randint(4, V, (B, S)).astype(np.int32)
    labels = rng.randint(4, V, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[:, 11:] = 0
    mask[2, 5:] = 0
    label_mask = (rng.rand(B, S) < 0.3).astype(np.float32)
    jax_model = JaxEncoder(**SMALL)
    params = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    return dict(jax_model=jax_model, params=params, ids=ids, labels=labels,
                mask=mask, label_mask=label_mask)


def _port(data, **kw):
    model = BertEncoderMLM(device='cpu', **SMALL, **kw)
    encoder_params_from_flax(_flatten_params(data['params']), model)
    return model


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_flax_parameters_load(flax_model):
    model = _port(flax_model)
    flat = _flatten_params(flax_model['params'])
    state = model.state_dict()
    # embeddings, their LayerNorm, 12 a layer, the head and head_bias
    assert len(flat) == len(state) == 2 + 2 + 2 * 12 + 2 + 2 + 1
    np.testing.assert_array_equal(
        state['layers.1.mlp_in.weight'].numpy(),
        flat['params/layer_1/mlp_in/kernel'].T)
    np.testing.assert_array_equal(state['tok_emb.weight'].numpy(),
                                  flat['params/tok_emb/embedding'])
    np.testing.assert_array_equal(state['head_ln.weight'].numpy(),
                                  flat['params/head_ln/scale'])


def test_a_missing_or_foreign_flax_key_raises(flax_model):
    flat = _flatten_params(flax_model['params'])
    model = BertEncoderMLM(device='cpu', **SMALL)
    missing = {k: v for k, v in flat.items() if k != 'params/head_bias'}
    with pytest.raises(KeyError, match='head_bias'):
        encoder_params_from_flax(missing, model)
    with pytest.raises(KeyError, match='not a BertEncoderMLM parameter'):
        encoder_params_from_flax(
            {**flat, 'params/layer_0/qkv/weights': np.zeros(3)}, model)
    wide = BertEncoderMLM(device='cpu', **{**SMALL, 'intermediate': 128})
    with pytest.raises(ValueError, match='mlp_in'):
        encoder_params_from_flax(flat, wide)


@pytest.mark.parametrize('masked', [False, True])
def test_logits_match_jax(flax_model, masked):
    d = flax_model
    mask = d['mask'] if masked else None
    ref = d['jax_model'].apply(
        d['params'], jnp.asarray(d['ids']),
        attention_mask=None if mask is None else jnp.asarray(mask))
    model = _port(d).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(d['ids']),
                    None if mask is None else torch.from_numpy(mask))
    assert out.shape == (B, S, V) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_mlm_loss_matches_jax():
    rng = np.random.RandomState(1)
    logits = rng.randn(3, 7, V).astype(np.float32) * 3
    labels = rng.randint(0, V, (3, 7)).astype(np.int32)
    label_mask = (rng.rand(3, 7) < 0.4).astype(np.float32)
    for lm in (None, label_mask, np.zeros_like(label_mask)):
        ours = mlm_loss(*_t(logits, labels),
                        None if lm is None else torch.from_numpy(lm))
        ref = jax_mlm_loss(jnp.asarray(logits), jnp.asarray(labels),
                           None if lm is None else jnp.asarray(lm))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)


def _jax_loss(d, params):
    logits = d['jax_model'].apply(params, jnp.asarray(d['ids']),
                                  attention_mask=jnp.asarray(d['mask']))
    return jax_mlm_loss(logits, jnp.asarray(d['labels']),
                        jnp.asarray(d['label_mask']))


def _port_loss(d, model):
    ids, mask, labels, label_mask = _t(d['ids'], d['mask'], d['labels'],
                                       d['label_mask'])
    return mlm_loss(model(ids, mask), labels, label_mask)


def _grads(model):
    return {n: p.grad.numpy().copy() for n, p in model.named_parameters()}


def test_one_step_gradients_match_jax(flax_model):
    d = flax_model
    ref_loss, ref = jax.jit(jax.value_and_grad(lambda p: _jax_loss(d, p)))(
        d['params'])
    ref = {k: np.asarray(v) for k, v in _flatten_params(ref).items()}
    model = _port(d)
    loss = _port_loss(d, model)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=1e-6)
    grads = _grads(model)
    moved = _port(d)                 # a module whose state is the gradients
    encoder_params_from_flax(ref, moved)
    for name, g in moved.state_dict().items():
        assert np.abs(grads[name]).max() > 0, name
        np.testing.assert_allclose(grads[name], g.numpy(), atol=1e-5,
                                   err_msg=name)


def test_adamw_steps_match_optax(flax_model):
    """5 steps at lr 1e-3 with the default weight decay 0.01 on every
    parameter."""
    d = flax_model
    tx = JaxAdamW(learning_rate=1e-3)._create_optax_optimizer()
    params = d['params']
    state = tx.init(params)
    step = jax.jit(jax.value_and_grad(lambda p: _jax_loss(d, p)))
    ref = []
    for _ in range(5):
        loss, g = step(params)
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        ref.append(float(loss))
    model = _port(d)
    opt = AdamW(learning_rate=1e-3)._create_torch_optimizer(
        model.parameters())
    ours = []
    for _ in range(5):
        opt.zero_grad()
        loss = _port_loss(d, model)
        loss.backward()
        opt.step()
        ours.append(loss.item())
    assert ours[-1] < ours[0]
    np.testing.assert_allclose(ours, ref, rtol=1e-4)


@pytest.mark.parametrize('dropout', [0.0, 0.2])
def test_remat_gives_the_same_gradients(flax_model, dropout):
    """Recomputing each layer in the backward changes no gradient, with
    dropout too: a layer's masks come from a seed drawn once a call."""
    grads = []
    for remat in (False, True):
        model = _port(flax_model, remat=remat, dropout=dropout).train()
        _port_loss(flax_model, model).backward()
        grads.append(_grads(model))
    for name, g in grads[0].items():
        np.testing.assert_array_equal(grads[1][name], g, err_msg=name)


def test_dropout_in_training_only(flax_model):
    model = _port(flax_model, dropout=0.3)
    ids = torch.from_numpy(flax_model['ids'])
    with torch.no_grad():
        train = [model.train()(ids) for _ in range(2)]
        evals = [model.eval()(ids) for _ in range(2)]
    assert not torch.equal(train[0], train[1])
    assert torch.equal(evals[0], evals[1])
    np.testing.assert_allclose(
        evals[0].numpy(), _port(flax_model).eval()(ids).detach().numpy(),
        atol=1e-6)


def test_no_device_and_no_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        BertEncoderMLM(**SMALL)
    with pytest.raises(ValueError, match='max_positions'):
        BertEncoderMLM(device='cpu', **SMALL)(torch.zeros(1, S + 1).long())


TOKENIZER_SMILES = ['CC(=O)Oc1ccccc1C(=O)O', 'CN1C=NC2=C1C(=O)N(C(=O)N2C)C',
                    'C[N+](C)(C)CC(=O)[O-]', 'FC(F)(F)c1ccc(Cl)cc1Br',
                    'O=S(=O)(N)c1ccc(N)cc1', 'C/C=C/C(=O)O', '[Na+].[Cl-]',
                    'C1CC2(CC1)OCCO2', 'C[C@@H](N)C(=O)O', 'N#Cc1ccncc1']


def test_tokenizer_ids_equal_jax(tmp_path):
    ours = SmilesTokenizer.from_corpus(TOKENIZER_SMILES[:8])
    ref = JaxTokenizer.from_corpus(TOKENIZER_SMILES[:8])
    assert ours.vocab == ref.vocab
    for s in TOKENIZER_SMILES:                 # the last two hold unknowns
        assert ours.tokenize(s) == ref.tokenize(s)
        for kw in ({}, {'max_length': 24}, {'max_length': 5},
                   {'add_special_tokens': False}):
            assert ours.encode(s, **kw) == ref.encode(s, **kw), (s, kw)
        ids = ours.encode(s, max_length=40)
        assert ours.decode(ids) == ref.decode(ids)
    assert ours.decode(ours.encode(TOKENIZER_SMILES[0], max_length=40)) \
        == TOKENIZER_SMILES[0]
    path = ours.save_vocabulary(str(tmp_path))
    assert SmilesTokenizer(path).vocab == ours.vocab == JaxTokenizer(
        path).vocab
