"""Random search: ``max_iter`` parameter sets drawn from the given
values."""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np

from deepchem_tpu_torch.hyper.base import HyperparamOpt, _better

logger = logging.getLogger(__name__)


class RandomHyperparamOpt(HyperparamOpt):
    """``max_iter`` trials, each value drawn from ``RandomState(seed)``:
    a list or tuple uniformly, a callable ``f(rng)`` called, anything else
    as it is."""

    @classmethod
    def generate_random_hyperparam_values(cls, params_dict: Dict,
                                          n: int) -> List[Dict]:
        """``n`` parameter sets from an unseeded ``RandomState``: lists,
        tuples and arrays drawn uniformly, a callable called with no
        argument (scipy's ``rvs``, say) or else with the generator."""
        rng = np.random.RandomState()
        out = []
        for _ in range(n):
            combo = {}
            for p, v in params_dict.items():
                if callable(v):
                    try:
                        combo[p] = v()
                    except TypeError:
                        combo[p] = v(rng)
                elif isinstance(v, (list, tuple, np.ndarray)):
                    combo[p] = v[rng.randint(len(v))]
                else:
                    combo[p] = v
            out.append(combo)
        return out

    def hyperparam_search(self, params_dict: Dict, train_dataset,
                          valid_dataset, metric, output_transformers=(),
                          nb_epoch: int = 10, use_max: bool = True,
                          logdir: Optional[str] = None,
                          seed: Optional[int] = None, **kwargs):
        rng = np.random.RandomState(seed)
        best_score = best_model = best_params = None
        all_scores = {}
        for trial in range(self.max_iter):
            params = {}
            for p, v in params_dict.items():
                if callable(v):
                    params[p] = v(rng)
                elif isinstance(v, (list, tuple)):
                    params[p] = v[rng.randint(len(v))]
                else:
                    params[p] = v
            logger.info('trial %d: %s', trial, params)
            hp_str, model, score = self._trial(
                params, train_dataset, valid_dataset, metric,
                output_transformers, nb_epoch, logdir)
            all_scores[hp_str] = score
            if _better(score, best_score, use_max):
                best_score, best_model, best_params = score, model, params
        return best_model, best_params, all_scores
