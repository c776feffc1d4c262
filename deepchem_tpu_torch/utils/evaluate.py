"""Model evaluation: counterpart of ``deepchem_tpu/utils/evaluate.py``'s
``Evaluator``, ``GeneratorEvaluator``, ``relative_difference``,
``output_statistics`` and ``output_predictions``."""

from __future__ import annotations

import csv
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from deepchem_tpu_torch.metrics import Metric
from deepchem_tpu_torch.trans import undo_transforms


def relative_difference(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """``|x - y|`` over the largest magnitude in either (at least
    1e-12)."""
    return np.abs(x - y) / np.abs(max(np.max(np.abs(x)),
                                      np.max(np.abs(y)), 1e-12))


def _process_metric_input(metrics) -> List[Metric]:
    """A :class:`Metric`, a scoring function, or a list of either, as a
    list of metrics."""
    if not isinstance(metrics, (list, tuple)):
        metrics = [metrics]
    out = []
    for m in metrics:
        if isinstance(m, Metric):
            out.append(m)
        elif callable(m):
            out.append(Metric(m))
        else:
            raise ValueError(f'not a metric: {m}')
    return out


def _score(metrics, y, y_pred, w, per_task_metrics, **kwargs):
    n_tasks = y.shape[1] if y.ndim > 1 else 1
    scores, task_scores = {}, {}
    for metric in _process_metric_input(metrics):
        res = metric.compute_metric(y, y_pred, w,
                                    per_task_metrics=per_task_metrics,
                                    n_tasks=n_tasks, **kwargs)
        if per_task_metrics:
            scores[metric.name], task_scores[metric.name] = res
        else:
            scores[metric.name] = res
    return (scores, task_scores) if per_task_metrics else scores


class Evaluator:
    """A model's scores on a dataset: the predictions and the labels with
    the transformers of the labels undone, scored by each metric.  With
    ``use_device_path`` the predictions come from ``predict_on_device``
    (the batches uploaded once)."""

    def __init__(self, model, dataset, transformers: Sequence = (),
                 use_device_path: bool = False):
        self.model = model
        self.dataset = dataset
        self.output_transformers = [t for t in transformers
                                    if t.transform_y]
        self.use_device_path = (use_device_path and
                                hasattr(model, 'predict_on_device'))

    def output_statistics(self, scores: Dict, stats_out: str) -> None:
        with open(stats_out, 'w') as f:
            f.write(str(scores) + '\n')

    def output_predictions(self, y_preds: np.ndarray, csv_out: str) -> None:
        """A CSV of each compound's prediction per task (a classifier's
        probability of its last class)."""
        tasks = list(self.dataset.get_task_names())
        y_preds = np.asarray(y_preds)
        if y_preds.ndim == 3:
            y_preds = y_preds[:, :, -1]
        y_preds = np.reshape(y_preds, (len(y_preds), len(tasks)))
        with open(csv_out, 'w') as f:
            writer = csv.writer(f)
            writer.writerow(['Compound'] + tasks)
            for mol_id, y_pred in zip(self.dataset.ids, y_preds):
                writer.writerow([mol_id] + list(y_pred))

    def compute_model_performance(
            self, metrics, csv_out: Optional[str] = None,
            stats_out: Optional[str] = None, per_task_metrics: bool = False,
            use_sample_weights: bool = False,
            n_classes: int = 2) -> Union[Dict, Tuple[Dict, Dict]]:
        if self.use_device_path:
            y_pred = self.model.predict_on_device(self.dataset,
                                                  self.output_transformers)
        else:
            y_pred = self.model.predict(self.dataset,
                                        self.output_transformers)
        if csv_out is not None:
            self.output_predictions(y_pred, csv_out)
        y = undo_transforms(self.dataset.y, self.output_transformers)
        result = _score(metrics, y, y_pred, self.dataset.w, per_task_metrics,
                        n_classes=n_classes,
                        use_sample_weights=use_sample_weights)
        if stats_out is not None:
            self.output_statistics(
                result[0] if per_task_metrics else result, stats_out)
        return result


class GeneratorEvaluator:
    """A model's scores over the ``(inputs, labels, weights)`` batches of
    a generator."""

    def __init__(self, model, generator, transformers: Sequence = (),
                 labels: Optional[Sequence] = None,
                 weights: Optional[Sequence] = None):
        self.model = model
        self.generator = generator
        self.output_transformers = [t for t in transformers
                                    if t.transform_y]
        self.label_keys = labels
        self.weights = weights

    def compute_model_performance(self, metrics,
                                  per_task_metrics: bool = False):
        y_labels, w_all, inputs = [], [], []
        for batch_inputs, labels, weights in self.generator:
            inputs.append(batch_inputs)
            y_labels.append(labels[0] if isinstance(labels, (list, tuple))
                            else labels)
            if weights:
                w_all.append(weights[0]
                             if isinstance(weights, (list, tuple))
                             else weights)
        y_pred = self.model.predict_on_generator(
            (x, [], []) for x in inputs)
        y = undo_transforms(np.concatenate(y_labels, axis=0),
                            self.output_transformers)
        y_pred = undo_transforms(y_pred, self.output_transformers)[:len(y)]
        w = np.concatenate(w_all, axis=0) if w_all else None
        return _score(metrics, y, y_pred, w, per_task_metrics)


def output_statistics(scores: Dict, stats_out: str) -> None:
    """Write a dict of scores to a file."""
    with open(stats_out, 'w') as f:
        f.write(str(scores))


def output_predictions(dataset, y_preds: np.ndarray, csv_out: str) -> None:
    """A CSV of each id's prediction per task."""
    tasks = list(dataset.get_task_names())
    y_preds = np.reshape(y_preds, (len(y_preds), len(tasks)))
    with open(csv_out, 'w', newline='') as f:
        writer = csv.writer(f)
        writer.writerow(['ID'] + tasks)
        for mol_id, y_pred in zip(dataset.ids, y_preds):
            writer.writerow([mol_id] + list(y_pred))
