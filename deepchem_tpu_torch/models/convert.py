"""Load flax parameters, flattened to ``{'params/<scope>/<name>': array}``
(the JAX package's ``jax_model._flatten_params``), into the port's
modules: the PAGTN and GraphConv modules (:func:`params_from_flax`) and
the encoder (:func:`encoder_params_from_flax`)."""

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
_LISTS = [(re.compile(r'pagtn_(\d+)$'), 'layers'),
          (re.compile(r'GraphConv_(\d+)$'), 'convs'),
          (re.compile(r'MaskedBatchNorm_(\d+)$'), 'norms')]
# flax leaf -> torch leaf: Dense kernels (transposed) and biases, GraphConv's
# per-degree weights, MaskedBatchNorm's scale
_LEAVES = {'kernel': 'weight', 'bias': 'bias', 'W_self': 'W_self',
           'W_nbr': 'W_nbr', 'b': 'b', 'scale': 'scale'}


def _torch_name(key: str, scopes: Dict[str, str] = _SCOPES) -> str:
    parts = key.split('/')
    if len(parts) < 3 or parts[0] != 'params' \
            or parts[-1] not in _LEAVES:
        raise KeyError(f'not a flax graph-model parameter: {key!r}')
    names = []
    for scope in parts[1:-1]:
        for pattern, attr in _LISTS:
            m = pattern.match(scope)
            if m:
                names.append(f'{attr}.{m.group(1)}')
                break
        else:
            names.append(scopes.get(scope, scope))
    return '.'.join(names + [_LEAVES[parts[-1]]])


def _tensor(key: str, value) -> torch.Tensor:
    """float32 tensor of ``value``; a Dense kernel ``[in, out]`` becomes
    the ``nn.Linear`` weight ``[out, in]``."""
    t = torch.from_numpy(np.array(value, dtype=np.float32))
    return t.T if key.endswith('/kernel') else t


def params_from_flax(flat: Dict[str, np.ndarray], module: nn.Module) -> None:
    """Copy ``flat`` into a graph model's ``module`` in place:
    ``pagtn_<i>``, ``GraphConv_<i>`` and ``MaskedBatchNorm_<i>`` become
    ``layers.<i>``, ``convs.<i>`` and ``norms.<i>``, each ``Dense_<i>`` the
    attribute the module's ``flax_scopes`` names, and each Dense kernel
    ``[in, out]`` the ``nn.Linear`` weight ``[out, in]``; GraphConv's
    ``W_self``, ``W_nbr``, ``b`` and MaskedBatchNorm's ``scale`` and
    ``bias`` keep their names and shapes.  Raises on a missing or extra key
    and on a shape that differs."""
    scopes = getattr(module, 'flax_scopes', _SCOPES)
    _load({_torch_name(key, scopes): _tensor(key, value)
           for key, value in flat.items()}, module)


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
