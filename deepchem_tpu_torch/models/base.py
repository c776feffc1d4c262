"""The abstract model: counterpart of ``deepchem_tpu/models/base.py``'s
``Model``, the model directory and ``evaluate`` through
:class:`~deepchem_tpu_torch.utils.evaluate.Evaluator`."""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Optional, Sequence, Union

import numpy as np


class Model:
    """Base of every model: ``model_dir`` (a new temporary directory,
    removed with the model, when none is given), and the fit, predict and
    evaluate contract."""

    def __init__(self, model=None, model_dir: Optional[str] = None,
                 **kwargs) -> None:
        if model_dir is not None:
            os.makedirs(model_dir, exist_ok=True)
            self.model_dir_is_temp = False
        else:
            model_dir = tempfile.mkdtemp()
            self.model_dir_is_temp = True
        self.model_dir = model_dir
        self.model = model
        self.model_class = model.__class__ if model is not None else None

    def __del__(self):
        if getattr(self, 'model_dir_is_temp', False):
            shutil.rmtree(self.model_dir, ignore_errors=True)

    def fit_on_batch(self, X, y, w):
        raise NotImplementedError

    def predict_on_batch(self, X, **kwargs):
        raise NotImplementedError

    def reload(self) -> None:
        raise NotImplementedError

    def save(self) -> None:
        raise NotImplementedError

    def fit(self, dataset, nb_epoch: int = 10, **kwargs):
        raise NotImplementedError

    def predict(self, dataset, transformers: Sequence = ()) -> np.ndarray:
        """``predict_on_batch`` over the dataset's batches in order, with
        the transformers of the labels undone."""
        from deepchem_tpu_torch.trans import undo_transforms
        y_pred = np.concatenate([
            self.predict_on_batch(X_b)
            for X_b, _, _, _ in dataset.iterbatches(deterministic=True)])
        return undo_transforms(y_pred, transformers)

    def evaluate(self, dataset, metrics: Union[Any, Sequence],
                 transformers: Sequence = (),
                 per_task_metrics: bool = False,
                 use_sample_weights: bool = False, n_classes: int = 2):
        """Each metric's score of :meth:`predict` on ``dataset``
        (:class:`Evaluator`)."""
        from deepchem_tpu_torch.utils.evaluate import Evaluator
        return Evaluator(self, dataset, transformers
                         ).compute_model_performance(
            metrics, per_task_metrics=per_task_metrics,
            use_sample_weights=use_sample_weights, n_classes=n_classes)

    def get_task_type(self) -> str:
        raise NotImplementedError

    def get_num_tasks(self) -> int:
        raise NotImplementedError
