"""Load flax parameters, flattened to ``{'params/<scope>/<name>': array}``
(the JAX package's ``jax_model._flatten_params``), into the port's
modules: the PAGTN, GraphConv, GCN, GAT, AttentiveFP, MPNN, DMPNN,
GNNModular, InfoGraph and PNA modules (their table and COO branches share
one parameter tree), Weave's, DTNN's and DAG's, the materials models'
(CGCNN and LCNN, MEGNet, ElemNet), InfoMax3D's (``encoder2d`` and
``encoder3d`` with their layers' scope paths), and the fingerprint
models' (``_MLPTrunk_0/Dense_i``,
``output_head``, ``uncertainty_head``; the robust models' shared, bypass
and head ``Dense_i``; the progressive columns' ``task{t}_dense{i}``,
``_alpha{i}``, ``_adapter{i}``, ``_lateral{i}``, ``_out``; IRV's ``W``,
``b``, ``b2``; ScScore's net) through :func:`params_from_flax`, each
module naming its scopes in ``flax_scopes`` and any leaf of its own in
``flax_leaves``; and the encoder (:func:`encoder_params_from_flax`)."""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
from torch import nn

# flax scope -> attribute path of the PAGTN module; a module names its own
# in ``flax_scopes``
_SCOPES = {'Dense_0': 'readout', 'Dense_1': 'head'}
# numbered flax scopes -> the port's module lists
_LAYER = r'(?:pagtn|GCNLayer|GATLayer|AttentiveFPLayer)'
_LISTS = [(re.compile(_LAYER + r'_(\d+)$'), 'layers'),
          (re.compile(r'GraphConv_(\d+)$'), 'convs'),
          (re.compile(r'MaskedBatchNorm_(\d+)$'), 'norms')]
# flax leaf -> torch leaf: Dense kernels (transposed) and biases, GraphConv's
# per-degree weights, MaskedBatchNorm's scale, GATLayer's attention vectors
_LEAVES = {'kernel': 'weight', 'bias': 'bias', 'W_self': 'W_self',
           'W_nbr': 'W_nbr', 'b': 'b', 'scale': 'scale', 'a_src': 'a_src',
           'a_dst': 'a_dst'}


def _torch_name(key: str, scopes: Dict[str, str] = _SCOPES,
                leaves: Dict[str, str] = _LEAVES) -> str:
    """The module's name of a flax leaf: each scope becomes the attribute
    ``scopes`` names for its path (``'A_0/Dense_1'``) or, failing that,
    for the scope alone, or a numbered list entry; the leaf the name
    ``leaves`` gives it."""
    parts = key.split('/')
    if len(parts) < 2 or parts[0] != 'params' \
            or parts[-1] not in leaves:
        raise KeyError(f'not a flax model parameter: {key!r}')
    names = []
    for i, scope in enumerate(parts[1:-1]):
        path = '/'.join(parts[1:i + 2])
        for pattern, attr in _LISTS:
            m = pattern.match(scope)
            if m:
                names.append(f'{attr}.{m.group(1)}')
                break
        else:
            names.append(scopes.get(path, scopes.get(scope, scope)))
    return '.'.join(names + [leaves[parts[-1]]])


# flax's recurrent cells: a Dense (kernel [in, out], bias) per gate, under
# the cell's scope (``GRUCell_<i>``, ``OptimizedLSTMCell_<i>``,
# ``LSTMCell_<i>`` or a name of the module's, such as ``support_lstm``),
# told apart by their gates -> the port's cells (graph_layers.GRUCell,
# LSTMCell), which stack the gates' weights [out, in]: torch leaf -> the
# flax gates.  Both flax LSTM cells have the bias on the hidden side only.
_GRU_GATES = ('ir', 'iz', 'in', 'hr', 'hz', 'hn')
_LSTM_GATES = ('ii', 'if', 'ig', 'io', 'hi', 'hf', 'hg', 'ho')
_CELL = re.compile(r'(params/(?:.+/)?[^/]+)/('
                   + '|'.join(_GRU_GATES + _LSTM_GATES)
                   + r')/(kernel|bias)$')
_CELL_LEAVES = {
    'GRUCell': {'weight_ih': ('ir', 'iz', 'in'),
                'bias_ih': ('ir', 'iz', 'in'),
                'weight_hh': ('hr', 'hz', 'hn'), 'bias_hn': ('hn',)},
    'LSTMCell': {'weight_ih': ('ii', 'if', 'ig', 'io'),
                 'weight_hh': ('hi', 'hf', 'hg', 'ho'),
                 'bias_hh': ('hi', 'hf', 'hg', 'ho')}}


def layer_scopes(prefix: str, attr: str, n: int,
                 scopes: Dict[str, str]) -> Dict[str, str]:
    """flax scope paths -> attribute paths of ``n`` numbered layers
    ``<prefix>_<i>`` kept in the module list ``attr``, with each layer's
    own ``scopes`` under it: entries of a module's ``flax_scopes``."""
    return {**{f'{prefix}_{i}': f'{attr}.{i}' for i in range(n)},
            **{f'{prefix}_{i}/{k}': v for i in range(n)
               for k, v in scopes.items()}}


def _cell_state(prefix: str, kind: str, leaves: Dict, scopes: Dict[str, str]
                ) -> Dict[str, torch.Tensor]:
    """The port cell's tensors from one flax cell's ``{(gate, leaf):
    array}``; raises unless the gates are exactly flax's."""
    base = _torch_name(prefix + '/kernel', scopes)[:-len('.weight')]
    want = {(g, 'bias' if name.startswith('bias') else 'kernel')
            for name, gates in _CELL_LEAVES[kind].items() for g in gates}
    if set(leaves) != want:
        raise KeyError(f'{prefix}: flax gates {sorted(leaves)} are not '
                       f'those of a {kind}: {sorted(want)}')
    out = {}
    for name, gates in _CELL_LEAVES[kind].items():
        leaf = 'bias' if name.startswith('bias') else 'kernel'
        parts = [np.asarray(leaves[(g, leaf)], dtype=np.float32)
                 for g in gates]
        out[f'{base}.{name}'] = torch.from_numpy(
            np.concatenate(parts, axis=-1).T.copy() if leaf == 'kernel'
            else np.concatenate(parts))
    return out


def flax_state(flat: Dict[str, np.ndarray],
               module: nn.Module) -> Dict[str, torch.Tensor]:
    """``flat`` (parameters, or gradients of them) as the graph module's
    state: see :func:`params_from_flax`."""
    scopes = getattr(module, 'flax_scopes', _SCOPES)
    leaves = {**_LEAVES, **getattr(module, 'flax_leaves', {})}
    state, cells = {}, {}
    for key, value in flat.items():
        m = _CELL.match(key)
        if m:
            cells.setdefault(m.group(1), {})[(m.group(2), m.group(3))] = value
        else:
            state[_torch_name(key, scopes, leaves)] = _tensor(key, value)
    for prefix, gates in cells.items():
        kind = 'GRUCell' if {g for g, _ in gates} <= set(_GRU_GATES) \
            else 'LSTMCell'
        state.update(_cell_state(prefix, kind, gates, scopes))
    return state


def _tensor(key: str, value) -> torch.Tensor:
    """float32 tensor of ``value``; a Dense kernel ``[in, out]`` becomes
    the ``nn.Linear`` weight ``[out, in]``."""
    t = torch.from_numpy(np.array(value, dtype=np.float32))
    return t.T if key.endswith('/kernel') else t


def params_from_flax(flat: Dict[str, np.ndarray], module: nn.Module) -> None:
    """Copy ``flat`` into a graph model's ``module`` in place:
    ``pagtn_<i>``, ``GCNLayer_<i>``, ``GATLayer_<i>`` and
    ``AttentiveFPLayer_<i>`` become ``layers.<i>``, ``GraphConv_<i>`` and
    ``MaskedBatchNorm_<i>`` ``convs.<i>`` and ``norms.<i>``, each other
    scope the attribute the module's ``flax_scopes`` names for its path or
    its name, and each Dense kernel ``[in, out]`` the ``nn.Linear`` weight
    ``[out, in]``; GraphConv's ``W_self``, ``W_nbr``, ``b``,
    MaskedBatchNorm's ``scale`` and ``bias`` and GATLayer's ``a_src`` and
    ``a_dst`` keep their names and shapes.  A ``GRUCell``'s gates become
    :class:`GRUCell`'s ``weight_ih`` (ir, iz, in), ``bias_ih``,
    ``weight_hh`` (hr, hz, hn) and ``bias_hn``; an ``OptimizedLSTMCell``'s
    or an ``LSTMCell``'s (numbered, or named by the module, as
    ``support_lstm``) :class:`LSTMCell`'s ``weight_ih`` (ii, if, ig, io),
    ``weight_hh`` and ``bias_hh`` (hi, hf, hg, ho).  Raises on a missing
    or extra key and on a shape that differs."""
    _load(flax_state(flat, module), module)


# flax leaf -> torch leaf in the encoder: Dense kernel (transposed), Embed
# table, LayerNorm scale, and every bias
_ENCODER_LEAVES = {'kernel': 'weight', 'embedding': 'weight',
                   'scale': 'weight', 'bias': 'bias'}
_ENCODER_LAYER = re.compile(r'layer_(\d+)$')


def _encoder_name(key: str) -> str:
    parts = key.split('/')
    if parts == ['params', 'head_bias']:
        return 'head_bias'
    if len(parts) < 3 or parts[0] != 'params' \
            or parts[-1] not in _ENCODER_LEAVES:
        raise KeyError(f'not a BertEncoderMLM parameter: {key!r}')
    scopes = []
    for scope in parts[1:-1]:
        m = _ENCODER_LAYER.match(scope)
        scopes.append(f'layers.{m.group(1)}' if m else scope)
    return '.'.join(scopes + [_ENCODER_LEAVES[parts[-1]]])


def encoder_params_from_flax(flat: Dict[str, np.ndarray],
                             module: nn.Module) -> None:
    """Copy the flattened parameters of the JAX package's
    ``BertEncoderMLM`` into the port's, in place: ``layer_<i>`` becomes
    ``layers.<i>``, Dense kernels are transposed, ``nn.Embed``'s
    ``embedding`` and ``nn.LayerNorm``'s ``scale`` become ``weight``, and
    the top-level ``head_bias`` stays.  Raises on a missing or extra key
    and on a shape that differs."""
    _load({_encoder_name(key): _tensor(key, value)
           for key, value in flat.items()}, module)


def _load(state: Dict[str, torch.Tensor], module: nn.Module) -> None:
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f'flax parameters do not match the module: missing '
                       f'{missing}, extra {extra}')
    for name, t in state.items():
        if t.shape != own[name].shape:
            raise ValueError(f'{name}: flax shape {tuple(t.shape)} != '
                             f'module shape {tuple(own[name].shape)}')
    module.load_state_dict(state)
