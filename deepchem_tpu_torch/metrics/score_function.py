"""Scoring functions: the port's copy of
``deepchem_tpu/metrics/score_function.py``, numpy only.  The
scikit-learn functions that module re-exports come from
:mod:`deepchem_tpu_torch.metrics._sklearn`, a numpy copy of them."""

from __future__ import annotations

from typing import Optional

import numpy as np

from deepchem_tpu_torch.metrics._sklearn import (  # noqa: F401 re-exports
    accuracy_score, auc, balanced_accuracy_score, cohen_kappa_score,
    f1_score, jaccard_score, matthews_corrcoef, mean_absolute_error,
    mean_squared_error, median_absolute_error, precision_recall_curve,
    precision_score, r2_score, recall_score, roc_auc_score, roc_curve,
    top_k_accuracy_score)


def pearson_r2_score(y: np.ndarray, y_pred: np.ndarray) -> float:
    """The squared Pearson correlation of labels and predictions; 0 where
    either is constant."""
    r = pearsonr(y, y_pred)
    return float(r ** 2) if r else 0.0


def pearsonr(y: np.ndarray, y_pred: np.ndarray) -> float:
    """The Pearson correlation of labels and predictions; 0 where either
    is constant."""
    y = np.asarray(y, dtype=float).reshape(-1)
    y_pred = np.asarray(y_pred, dtype=float).reshape(-1)
    if y.std() == 0 or y_pred.std() == 0:
        return 0.0
    return float(np.corrcoef(y, y_pred)[0, 1])


def jaccard_index(y: np.ndarray, y_pred: np.ndarray) -> float:
    """:func:`jaccard_score` under its older name."""
    return float(jaccard_score(y, y_pred))


def pixel_error(y: np.ndarray, y_pred: np.ndarray) -> float:
    """1 - F1 over every pixel."""
    return 1.0 - float(f1_score(np.asarray(y).ravel(),
                                np.asarray(y_pred).ravel()))


def prc_auc_score(y: np.ndarray, y_pred: np.ndarray) -> float:
    """Area under the precision-recall curve."""
    precision, recall, _ = precision_recall_curve(y, y_pred)
    return float(auc(recall, precision))


def rms_score(y_true: np.ndarray, y_pred: np.ndarray,
              sample_weight: Optional[np.ndarray] = None) -> float:
    """The root of the (weighted) mean squared error."""
    return float(np.sqrt(mean_squared_error(y_true, y_pred,
                                            sample_weight=sample_weight)))


def mae_score(y_true: np.ndarray, y_pred: np.ndarray,
              sample_weight: Optional[np.ndarray] = None) -> float:
    """The (weighted) mean absolute error."""
    return float(mean_absolute_error(y_true, y_pred,
                                     sample_weight=sample_weight))


def kappa_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Cohen's kappa."""
    return float(cohen_kappa_score(y_true, y_pred))


def bedroc_score(y_true: np.ndarray, y_pred: np.ndarray,
                 alpha: float = 20.0) -> float:
    """BEDROC early-recognition score (Truchon and Bayly 2007) of binary
    labels (or their one-hot) against scores; 0 where every label is
    alike."""
    y_true = np.asarray(y_true)
    if y_true.ndim == 2:
        y_true = y_true[:, 1] if y_true.shape[1] == 2 else y_true.ravel()
    scores = np.asarray(y_pred, dtype=float)
    if scores.ndim == 2:
        scores = scores[:, 1] if scores.shape[1] == 2 else scores.ravel()
    N = len(y_true)
    n = int(np.sum(y_true))
    if n == 0 or n == N:
        return 0.0
    order = np.argsort(-scores, kind='stable')
    ranks = np.nonzero(y_true[order])[0] + 1       # 1-indexed ranks
    ra = n / N
    s = np.sum(np.exp(-alpha * ranks / N))
    rie = s / (n / N * (1 - np.exp(-alpha)) /
               (np.exp(alpha / N) - 1))
    bedroc = (rie * ra * np.sinh(alpha / 2) /
              (np.cosh(alpha / 2) - np.cosh(alpha / 2 - alpha * ra))
              + 1 / (1 - np.exp(alpha * (1 - ra))))
    return float(bedroc)


def concordance_index(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """The share of comparable pairs (different labels) that the
    predictions order alike, a tie counting half."""
    y_true = np.asarray(y_true, dtype=float).ravel()
    y_pred = np.asarray(y_pred, dtype=float).ravel()
    order = np.argsort(y_true, kind='stable')
    y_true, y_pred = y_true[order], y_pred[order]
    total = 0.0
    matches = 0.0
    for i in range(len(y_true)):
        gt = y_true[i + 1:] > y_true[i]
        total += gt.sum()
        matches += (y_pred[i + 1:][gt] > y_pred[i]).sum()
        matches += 0.5 * (y_pred[i + 1:][gt] == y_pred[i]).sum()
    return float(matches / total) if total > 0 else 0.0


def rmse(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """:func:`rms_score`."""
    return rms_score(y_true, y_pred)
