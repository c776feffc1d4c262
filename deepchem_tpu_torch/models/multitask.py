"""``SingletaskToMultitask``: one singletask model a task.

Counterpart of ``deepchem_tpu/models/multitask.py``.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Sequence

import numpy as np

from deepchem_tpu_torch.data import NumpyDataset
from deepchem_tpu_torch.models.base import Model

logger = logging.getLogger(__name__)


class SingletaskToMultitask(Model):
    """An independent model for each of ``tasks``, built by
    ``model_builder(task)``.  :meth:`fit` trains task ``t``'s model on the
    samples whose weight for ``t`` is not 0, with that task's labels and
    weights; :meth:`predict_on_batch` stacks the models' predictions, ``[n,
    tasks, classes]`` for classifiers' probabilities, else ``[n,
    tasks]``."""

    def __init__(self, tasks: Sequence, model_builder: Callable,
                 model_dir=None, **kwargs):
        super().__init__(model=None, model_dir=model_dir, **kwargs)
        self.tasks = list(tasks)
        self.models: List[Model] = [model_builder(t) for t in self.tasks]

    def fit(self, dataset: NumpyDataset, **kwargs) -> None:
        X = np.asarray(dataset.X, dtype=float)
        y, w = dataset.y, dataset.w
        for t, model in enumerate(self.models):
            keep = w[:, t] != 0
            logger.info('fitting task %s on %d samples', self.tasks[t],
                        keep.sum())
            model.fit(NumpyDataset(X[keep], y[keep, t], w[keep, t]), **kwargs)

    def predict_on_batch(self, X) -> np.ndarray:
        preds = [np.asarray(m.predict_on_batch(X)) for m in self.models]
        if preds[0].ndim == 2 and preds[0].shape[1] > 1:
            return np.stack(preds, axis=1)
        return np.stack([p.reshape(len(p)) for p in preds], axis=1)

    def predict(self, dataset: NumpyDataset, transformers=()) -> np.ndarray:
        from deepchem_tpu_torch.trans import undo_transforms
        out = self.predict_on_batch(np.asarray(dataset.X, dtype=float))
        return undo_transforms(out, transformers)

    def save(self) -> None:
        """Each model's checkpoint in its own ``model_dir``."""
        for model in self.models:
            model.save_checkpoint()

    def reload(self) -> None:
        """Each model from its newest checkpoint."""
        for model in self.models:
            model.restore()

    def get_num_tasks(self) -> int:
        return len(self.tasks)
