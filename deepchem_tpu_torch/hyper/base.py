"""The base of hyperparameter searches, and the name a parameter set is
logged and stored under; the port's copy of ``deepchem_tpu/hyper/base.py``."""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional


def _convert_hyperparam_dict_to_filename(params: Dict) -> str:
    """``_{key}_{value}`` for each parameter in key order: a list joined by
    '-', a callable by its name, another object by its type's name."""
    filename = ''
    for key, value in sorted(params.items()):
        filename += f'_{key}'
        if isinstance(value, (int, float, str, bool)):
            filename += f'_{value}'
        elif isinstance(value, (list, tuple)):
            filename += '_' + '-'.join(str(v) for v in value)
        elif hasattr(value, '__name__'):
            filename += f'_{value.__name__}'
        else:
            filename += f'_{type(value).__name__}'
    return filename


class HyperparamOpt:
    """A search over the parameters of ``model_builder(**params) ->
    model``: each candidate is fitted on the train set and scored on the
    valid set."""

    def __init__(self, model_builder: Callable, max_iter: int = 100):
        self.model_builder = model_builder
        self.max_iter = max_iter

    def hyperparam_search(self, params_dict: Dict, train_dataset,
                          valid_dataset, metric, output_transformers=(),
                          nb_epoch: int = 10, use_max: bool = True,
                          logdir: Optional[str] = None, **kwargs):
        """``(best_model, best_params, {filename: score})``."""
        raise NotImplementedError

    def _trial(self, model_params: Dict, train_dataset, valid_dataset,
               metric, output_transformers, nb_epoch: int,
               logdir: Optional[str]):
        """Build, fit and score one parameter set; returns its filename,
        the model and its score.  With ``logdir`` the model's directory is
        ``logdir/<filename>``."""
        hp_str = _convert_hyperparam_dict_to_filename(model_params)
        if logdir is not None:
            model_dir = os.path.join(logdir, hp_str)
            os.makedirs(model_dir, exist_ok=True)
            model_params = dict(model_params, model_dir=model_dir)
        model = self.model_builder(**model_params)
        model.fit(train_dataset, nb_epoch=nb_epoch)
        score = model.evaluate(valid_dataset, [metric],
                               output_transformers)[metric.name]
        return hp_str, model, score


def _better(score, best, use_max: bool) -> bool:
    return best is None or (score > best if use_max else score < best)
