"""Load flax parameters, flattened to ``{'params/<scope>/<name>': array}``
(the JAX package's ``jax_model._flatten_params``), into the port's PAGTN
module."""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
from torch import nn

# flax scope -> attribute path of the port's module
_SCOPES = {'Dense_0': 'readout', 'Dense_1': 'head'}
_LAYER = re.compile(r'pagtn_(\d+)$')


def _torch_name(key: str) -> str:
    parts = key.split('/')
    if len(parts) < 3 or parts[0] != 'params' \
            or parts[-1] not in ('kernel', 'bias'):
        raise KeyError(f'not a flax Dense parameter: {key!r}')
    scopes = []
    for scope in parts[1:-1]:
        m = _LAYER.match(scope)
        scopes.append(f'layers.{m.group(1)}' if m
                      else _SCOPES.get(scope, scope))
    leaf = 'weight' if parts[-1] == 'kernel' else 'bias'
    return '.'.join(scopes + [leaf])


def params_from_flax(flat: Dict[str, np.ndarray], module: nn.Module) -> None:
    """Copy ``flat`` into ``module`` in place.  Each Dense kernel ``[in,
    out]`` becomes the ``nn.Linear`` weight ``[out, in]``.  Raises on a
    missing or extra key and on a shape that differs."""
    state = {}
    for key, value in flat.items():
        t = torch.from_numpy(np.array(value, dtype=np.float32))
        state[_torch_name(key)] = t.T if key.endswith('/kernel') else t
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
