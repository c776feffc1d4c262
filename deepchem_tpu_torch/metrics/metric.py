"""The port's copy of ``deepchem_tpu/metrics/metric.py``: ``Metric``,
the shape helpers it uses, ``to_one_hot``, ``from_one_hot``,
``handle_classification_mode`` and ``threshold_predictions``, numpy
only."""

from __future__ import annotations

import logging
from typing import Callable, Optional, Union

import numpy as np

logger = logging.getLogger(__name__)


def to_one_hot(y: np.ndarray, n_classes: int = 2) -> np.ndarray:
    """``(N,)`` or ``(N, 1)`` labels -> ``(N, n_classes)`` one-hot float64;
    labels are rounded to the nearest class."""
    y = np.asarray(y)
    if y.ndim == 2 and y.shape[1] == 1:
        y = y[:, 0]
    if y.ndim != 1:
        raise ValueError('y must be 1-D or (N,1)')
    n = len(y)
    out = np.zeros((n, n_classes))
    out[np.arange(n), np.round(y).astype(int)] = 1
    return out


def from_one_hot(y: np.ndarray, axis: int = 1) -> np.ndarray:
    return np.argmax(y, axis=axis)


def normalize_weight_shape(w: Optional[np.ndarray], n_samples: int,
                           n_tasks: int) -> np.ndarray:
    """-> ``(n_samples, n_tasks)`` weights."""
    if w is None:
        return np.ones((n_samples, n_tasks))
    w = np.asarray(w)
    if w.ndim == 0:
        return np.full((n_samples, n_tasks), float(w))
    if w.ndim == 1:
        if len(w) != n_samples:
            raise ValueError('1-D w must have length n_samples')
        return np.tile(w[:, None], (1, n_tasks))
    if w.ndim == 2:
        if w.shape == (n_samples, 1):
            return np.tile(w, (1, n_tasks))
        if w.shape == (n_samples, n_tasks):
            return w
        raise ValueError(f'bad w shape {w.shape}')
    raise ValueError('w must be of dimension 0..2')


def normalize_labels_shape(y: np.ndarray, mode: str, n_tasks: int = 1,
                           n_classes: int = 2) -> np.ndarray:
    """-> ``(n_samples, n_tasks)`` for regression, ``(n_samples, n_tasks,
    n_classes)`` one-hot for classification."""
    y = np.asarray(y)
    if mode not in ('classification', 'regression'):
        raise ValueError('mode must be classification or regression')
    if y.ndim == 1:
        y = y[:, None]
    if y.ndim == 2:
        if n_tasks == 1 and y.shape[1] > 1:
            if mode == 'classification' and y.shape[1] == n_classes:
                y = y[:, None, :]
            else:
                raise ValueError(f'bad y shape {y.shape}')
        elif y.shape[1] != n_tasks:
            raise ValueError(f'bad y shape {y.shape} for n_tasks={n_tasks}')
    if mode == 'classification':
        if y.ndim == 2:
            out = np.zeros((y.shape[0], y.shape[1], n_classes))
            for t in range(y.shape[1]):
                out[:, t, :] = to_one_hot(y[:, t], n_classes)
            y = out
        elif y.ndim != 3:
            raise ValueError('classification y must be <=3-D')
    else:
        if y.ndim == 3 and y.shape[2] == 1:
            y = y[:, :, 0]
        elif y.ndim != 2:
            raise ValueError('regression y must be 2-D')
    return y


def normalize_prediction_shape(y: np.ndarray, mode: str, n_tasks: int = 1,
                               n_classes: int = 2) -> np.ndarray:
    """As :func:`normalize_labels_shape`, keeping class probabilities."""
    y = np.asarray(y)
    if mode == 'classification':
        if y.ndim == 1:
            return to_one_hot(y, n_classes)[:, None, :]
        if y.ndim == 2:
            if n_tasks == 1:
                if y.shape[1] == n_classes:
                    return y[:, None, :]
                if y.shape[1] == 1:
                    return np.stack([1 - y[:, 0], y[:, 0]],
                                    axis=1)[:, None, :]
                raise ValueError(f'bad prediction shape {y.shape}')
            if y.shape[1] == n_tasks:
                if np.issubdtype(y.dtype, np.integer) or \
                        np.all(np.isin(np.unique(np.round(y) - y), [0.0])):
                    out = np.zeros((y.shape[0], n_tasks, n_classes))
                    for t in range(n_tasks):
                        out[:, t, :] = to_one_hot(y[:, t], n_classes)
                    return out
                if n_classes == 2:
                    out = np.zeros((y.shape[0], n_tasks, 2))
                    out[:, :, 1] = y
                    out[:, :, 0] = 1 - y
                    return out
            raise ValueError(f'bad prediction shape {y.shape}')
        if y.ndim == 3:
            return y
        raise ValueError('classification predictions must be <=3-D')
    if mode == 'regression':
        if y.ndim == 1:
            return y[:, None]
        if y.ndim == 2:
            return y
        if y.ndim == 3 and y.shape[2] == 1:
            return y[:, :, 0]
        raise ValueError('regression predictions must be <=2-D')
    raise ValueError('mode must be classification or regression')


def handle_classification_mode(
        y: np.ndarray, classification_handling_mode: Optional[str],
        threshold_value: Optional[float] = None) -> np.ndarray:
    """``(N, T, C)`` probabilities as ``classification_handling_mode``
    asks: None keeps them, 'threshold' gives class indices ``(N, T)``,
    'threshold-one-hot' those indices one-hot."""
    if classification_handling_mode is None:
        return y
    if y.ndim != 3:
        raise ValueError('expected (N, T, C) probabilities')
    N, T, C = y.shape
    if classification_handling_mode == 'threshold':
        out = np.zeros((N, T))
        for t in range(T):
            out[:, t] = threshold_predictions(y[:, t, :], threshold_value)
        return out
    if classification_handling_mode == 'threshold-one-hot':
        out = np.zeros_like(y)
        for t in range(T):
            idx = threshold_predictions(y[:, t, :], threshold_value)
            out[:, t, :] = to_one_hot(idx, C)
        return out
    raise ValueError(f'bad classification_handling_mode '
                     f'{classification_handling_mode}')


def threshold_predictions(y: np.ndarray,
                          threshold: Optional[float] = None) -> np.ndarray:
    """``(N, C)`` probabilities -> ``(N,)`` class indices."""
    y = np.asarray(y)
    if threshold is not None and y.shape[1] == 2:
        return (y[:, 1] >= threshold).astype(int)
    return np.argmax(y, axis=1)


_CLASSIFICATION_FN_NAMES = {
    'roc_auc_score', 'accuracy_score', 'balanced_accuracy_score',
    'f1_score', 'recall_score', 'precision_score', 'matthews_corrcoef',
    'cohen_kappa_score', 'prc_auc_score', 'jaccard_score', 'bedroc_score',
    'jaccard_index', 'pixel_error', 'kappa_score',
}
_REGRESSION_FN_NAMES = {
    'mean_squared_error', 'mean_absolute_error', 'r2_score', 'rms_score',
    'mae_score', 'pearson_r2_score', 'median_absolute_error',
    'pearsonr', 'concordance_index', 'rmse', 'mean_squared_log_error',
}
# scored on thresholded class labels rather than probabilities
_THRESHOLD_METRICS = {
    'accuracy_score', 'balanced_accuracy_score', 'f1_score', 'recall_score',
    'precision_score', 'matthews_corrcoef', 'cohen_kappa_score',
    'jaccard_score', 'jaccard_index', 'pixel_error', 'kappa_score',
}


class Metric:
    """A scoring function with shape canonicalisation and a mean over
    tasks.  Per task, rows of weight 0 are dropped; a task the function
    cannot score (one class only) gives NaN, and the mean skips it."""

    def __init__(self, metric: Callable,
                 task_averager: Optional[Callable] = None,
                 name: Optional[str] = None,
                 threshold: Optional[float] = None,
                 mode: Optional[str] = None, n_tasks: Optional[int] = None,
                 classification_handling_mode: Optional[str] = None,
                 threshold_value: Optional[float] = None):
        self.metric = metric
        self.task_averager = task_averager or np.mean
        self.name = name or getattr(metric, '__name__', 'unknown_metric')
        self.n_tasks = n_tasks
        fn_name = getattr(metric, '__name__', '')
        if mode is None:
            if fn_name in _CLASSIFICATION_FN_NAMES:
                mode = 'classification'
            elif fn_name in _REGRESSION_FN_NAMES:
                mode = 'regression'
            else:
                raise ValueError(
                    f'cannot infer mode for metric {fn_name}; pass mode=')
        self.mode = mode
        if classification_handling_mode is None \
                and mode == 'classification' \
                and fn_name in _THRESHOLD_METRICS:
            classification_handling_mode = 'threshold'
        self.classification_handling_mode = classification_handling_mode
        self.threshold_value = threshold_value

    def compute_metric(self, y_true: np.ndarray, y_pred: np.ndarray,
                       w: Optional[np.ndarray] = None,
                       n_tasks: Optional[int] = None, n_classes: int = 2,
                       per_task_metrics: bool = False,
                       use_sample_weights: bool = False,
                       **kwargs) -> Union[float, tuple]:
        """The mean over tasks of the task scores (and with
        ``per_task_metrics`` the task scores too); extra keywords go to
        the scoring function."""
        y_true = np.asarray(y_true)
        if n_tasks is None:
            if self.n_tasks is not None:
                n_tasks = self.n_tasks
            else:
                n_tasks = y_true.shape[1] if y_true.ndim > 1 else 1
        y_true = normalize_labels_shape(y_true, self.mode, n_tasks,
                                        n_classes)
        y_pred = normalize_prediction_shape(np.asarray(y_pred), self.mode,
                                            n_tasks, n_classes)
        n_samples = y_true.shape[0]
        w = normalize_weight_shape(w, n_samples, n_tasks)
        scores = []
        for t in range(n_tasks):
            try:
                score = self.compute_singletask_metric(
                    y_true[:, t], y_pred[:, t], w[:, t],
                    n_samples=n_samples,
                    use_sample_weights=use_sample_weights, **kwargs)
            except Exception as e:   # e.g. a task with one class only
                logger.warning('error computing %s for task %d: %s',
                               self.name, t, e)
                score = np.nan
            scores.append(score)
        if n_tasks == 1:
            overall = scores[0]
        else:
            valid = [v for v in scores if not np.isnan(v)]
            overall = self.task_averager(valid) if valid else float('nan')
        return (overall, scores) if per_task_metrics else overall

    def compute_singletask_metric(self, y_true, y_pred, w=None,
                                  n_samples: Optional[int] = None,
                                  use_sample_weights: bool = False,
                                  **kwargs) -> float:
        y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
        if w is not None:
            w = np.asarray(w)
            keep = w != 0
            if keep.ndim > 1:
                keep = keep.any(axis=tuple(range(1, keep.ndim)))
            y_true, y_pred, w = y_true[keep], y_pred[keep], w[keep]
        if self.mode == 'classification':
            y_pred = handle_classification_mode(
                y_pred[:, None, :], self.classification_handling_mode,
                self.threshold_value)[:, 0]
            y_true_idx = from_one_hot(y_true) if y_true.ndim == 2 \
                else y_true
            fn_name = getattr(self.metric, '__name__', '')
            if self.classification_handling_mode == 'threshold':
                y_in = y_pred if y_pred.ndim == 1 else from_one_hot(y_pred)
                args = (y_true_idx, y_in)
            elif fn_name in ('roc_auc_score', 'prc_auc_score',
                             'bedroc_score') \
                    and y_pred.ndim == 2 and y_pred.shape[1] == 2:
                args = (y_true_idx, y_pred[:, 1])   # P(positive)
            else:
                args = (y_true, y_pred)
        else:
            args = (y_true, y_pred)
        if use_sample_weights and w is not None:
            return float(self.metric(*args, sample_weight=w, **kwargs))
        return float(self.metric(*args, **kwargs))
