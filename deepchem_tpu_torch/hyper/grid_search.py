"""Grid search over every combination of the given values."""

from __future__ import annotations

import itertools
import logging
from typing import Dict, Optional

from deepchem_tpu_torch.hyper.base import HyperparamOpt, _better

logger = logging.getLogger(__name__)


class GridHyperparamOpt(HyperparamOpt):
    """Every combination of ``params_dict``'s values (a value that is not
    a list or tuple is the only one), keys in sorted order."""

    def hyperparam_search(self, params_dict: Dict, train_dataset,
                          valid_dataset, metric, output_transformers=(),
                          nb_epoch: int = 10, use_max: bool = True,
                          logdir: Optional[str] = None, **kwargs):
        names = sorted(params_dict)
        values = [params_dict[p] if isinstance(params_dict[p], (list, tuple))
                  else [params_dict[p]] for p in names]
        best_score = best_model = best_params = None
        all_scores = {}
        for combo in itertools.product(*values):
            params = dict(zip(names, combo))
            logger.info('Fitting model with %s', params)
            hp_str, model, score = self._trial(
                params, train_dataset, valid_dataset, metric,
                output_transformers, nb_epoch, logdir)
            all_scores[hp_str] = score
            if _better(score, best_score, use_max):
                best_score, best_model, best_params = score, model, params
        return best_model, best_params, all_scores
