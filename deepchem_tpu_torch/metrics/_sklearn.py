"""The scikit-learn scoring functions that ``deepchem_tpu/metrics``
re-exports, in numpy (the card's machine has no scikit-learn).

Each computes what scikit-learn 1.9's function of the same name computes,
in the same order of operations, for the inputs DeepChem's metrics give
it: 1-D labels and scores, or ``(n_samples, n_outputs)`` regression
targets, with optional ``sample_weight``.  Their edge cases follow
scikit-learn's: ``roc_curve`` drops collinear points,
``precision_recall_curve`` ends at recall 0 and precision 1, a division by
zero in precision, recall, F1 or Jaccard gives 0, ``matthews_corrcoef``
gives 0 and ``cohen_kappa_score`` NaN where they are undefined.
"""

from __future__ import annotations

import warnings

import numpy as np

_trapezoid = getattr(np, 'trapezoid', None) or np.trapz


def _column(a) -> np.ndarray:
    a = np.asarray(a)
    if a.ndim == 2 and a.shape[1] == 1:
        return a[:, 0]
    if a.ndim != 1:
        raise ValueError(f'y should be a 1d array, got shape {a.shape}')
    return a


def _labels(*arrays) -> np.ndarray:
    return np.unique(np.concatenate([np.asarray(a).ravel() for a in arrays]))


# -- ranking ------------------------------------------------------------------

def auc(x, y) -> float:
    """Area under the curve through ``(x, y)`` by the trapezoidal rule;
    ``x`` must be monotonic (either way)."""
    x, y = _column(x), _column(y)
    if x.shape[0] < 2:
        raise ValueError('At least 2 points are needed to compute area under '
                         f'curve, but x.shape = {x.shape}')
    direction = 1
    dx = np.diff(x)
    if np.any(dx < 0):
        if np.all(dx <= 0):
            direction = -1
        else:
            raise ValueError(f'x is neither increasing nor decreasing : {x}.')
    return float(direction * _trapezoid(y, x))


def _pos_label(y_true: np.ndarray, pos_label) -> object:
    classes = np.unique(y_true)
    if pos_label is None:
        if len(classes) > 2:
            raise ValueError('multiclass format is not supported')
        if not any(np.array_equal(classes, c) for c in
                   ([0, 1], [-1, 1], [0], [-1], [1])):
            raise ValueError(f'y_true takes value in {classes} and pos_label '
                             'is not specified: either make y_true take '
                             'value in {0, 1} or {-1, 1} or pass pos_label '
                             'explicitly.')
        pos_label = 1
    return pos_label


def _clf_curve(y_true, y_score, pos_label=None, sample_weight=None):
    """Counts of false and true positives at each distinct score, the
    scores descending: ``(fps, tps, thresholds)``."""
    y_true, y_score = _column(y_true), _column(y_score)
    pos_label = _pos_label(y_true, pos_label)
    y_true = (y_true == pos_label).astype(np.int32)
    if not (np.all(np.isfinite(y_score))):
        raise ValueError('Input contains NaN or infinity.')
    if sample_weight is not None:
        sample_weight = _column(sample_weight).astype(np.float64)
        keep = sample_weight != 0
        y_true, y_score = y_true[keep], y_score[keep]
        sample_weight = sample_weight[keep]
    order = np.argsort(-y_score, kind='stable')
    y_score, y_true = y_score[order], y_true[order]
    weight = 1.0 if sample_weight is None else sample_weight[order]
    idx = np.r_[np.nonzero(np.diff(y_score))[0], y_true.size - 1]
    y_true = y_true.astype(np.float64)
    tps = np.cumsum(y_true * weight, dtype=np.float64)[idx]
    if sample_weight is not None:
        fps = np.cumsum((1 - y_true) * weight, dtype=np.float64)[idx]
    else:
        fps = 1 + idx.astype(np.float64) - tps
    return fps, tps, y_score[idx]


def roc_curve(y_true, y_score, *, pos_label=None, sample_weight=None,
              drop_intermediate: bool = True):
    """``(fpr, tpr, thresholds)``: the first point is (0, 0) at threshold
    ``inf``; with ``drop_intermediate`` the points where neither rate
    bends are dropped."""
    fps, tps, thresholds = _clf_curve(y_true, y_score, pos_label,
                                      sample_weight)
    if drop_intermediate and fps.shape[0] > 2:
        keep = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
                     True]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps, fps = np.r_[0.0, tps], np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds.astype(np.float64)]
    if fps[-1] <= 0:
        warnings.warn('No negative samples in y_true, false positive value '
                      'should be meaningless')
        fpr = np.full(fps.shape, np.nan)
    else:
        fpr = fps / fps[-1]
    if tps[-1] <= 0:
        warnings.warn('No positive samples in y_true, true positive value '
                      'should be meaningless')
        tpr = np.full(tps.shape, np.nan)
    else:
        tpr = tps / tps[-1]
    return fpr, tpr, thresholds


def precision_recall_curve(y_true, y_score, *, pos_label=None,
                           sample_weight=None,
                           drop_intermediate: bool = False):
    """``(precision, recall, thresholds)``, thresholds ascending, with a
    last point of precision 1 and recall 0 that has no threshold."""
    fps, tps, thresholds = _clf_curve(y_true, y_score, pos_label,
                                      sample_weight)
    if drop_intermediate and fps.shape[0] > 2:
        keep = np.r_[True, np.logical_or(np.diff(tps[:-1]),
                                         np.diff(tps[1:])), True]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    ps = tps + fps
    with np.errstate(divide='ignore', invalid='ignore'):
        precision = np.where(ps != 0, np.divide(tps, ps), 0.0)
    if tps[-1] == 0:
        warnings.warn('No positive class found in y_true, recall is set to '
                      'one for all thresholds.')
        recall = np.full(tps.shape, 1.0)
    else:
        recall = tps / tps[-1]
    return (np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0],
            thresholds[::-1])


def roc_auc_score(y_true, y_score, sample_weight=None) -> float:
    """Area under the ROC curve of binary labels against scores, the
    larger label positive.  Raises ``ValueError`` unless both classes
    occur."""
    y_true = _column(y_true)
    labels = np.unique(y_true)
    if len(labels) != 2:
        raise ValueError('Only one class present in y_true. ROC AUC score '
                         'is not defined in that case.')
    y_true = (y_true == labels[1]).astype(np.int64)
    fpr, tpr, _ = roc_curve(y_true, y_score, sample_weight=sample_weight)
    return auc(fpr, tpr)


def top_k_accuracy_score(y_true, y_score, *, k: int = 2,
                         normalize: bool = True, sample_weight=None,
                         labels=None) -> float:
    """The (weighted) share of samples whose true class is among the ``k``
    highest scores; ties go to the class of higher index, as a stable
    ascending sort read backwards ranks them."""
    y_true = _column(y_true)
    y_score = np.asarray(y_score)
    classes = np.unique(y_true) if labels is None \
        else np.asarray(labels)
    binary = len(np.unique(y_true)) <= 2 \
        and (labels is None or len(labels) <= 2)
    if binary:
        if y_score.ndim == 2 and y_score.shape[1] != 1:
            raise ValueError('`y_true` is binary while y_score is 2d with '
                             f'{y_score.shape[1]} classes.')
        y_score = _column(y_score)
    elif y_score.ndim != 2:
        raise ValueError('`y_score` needs to be of shape (n_samples, '
                         'n_classes)')
    n_score = y_score.shape[1] if y_score.ndim == 2 else 2
    if len(classes) != n_score:
        raise ValueError(f'Number of classes in y_true ({len(classes)}) not '
                         f'equal to the number of classes in y_score '
                         f'({n_score}).')
    encoded = np.searchsorted(classes, y_true)
    if binary:
        if k == 1:
            threshold = 0.5 if y_score.min() >= 0 and y_score.max() <= 1 \
                else 0
            hits = (y_score > threshold).astype(np.int64) == encoded
        else:
            hits = np.ones_like(y_score, dtype=np.bool_)
    else:
        ranked = np.argsort(y_score, axis=1, kind='mergesort')[:, ::-1]
        hits = (encoded == ranked[:, :k].T).any(axis=0)
    if normalize:
        return float(np.average(hits, weights=sample_weight))
    if sample_weight is None:
        return float(np.sum(hits))
    return float(np.dot(hits, sample_weight))


# -- classification -----------------------------------------------------------

def confusion_matrix(y_true, y_pred, *, labels=None,
                     sample_weight=None) -> np.ndarray:
    """``C[i, j]``: the (weighted) count of samples of class ``labels[i]``
    predicted as ``labels[j]``; labels default to both arrays' sorted
    union."""
    y_true, y_pred = _column(y_true), _column(y_pred)
    labels = _labels(y_true, y_pred) if labels is None \
        else np.asarray(labels)
    n = len(labels)
    if sample_weight is None:
        sample_weight = np.ones(y_true.shape[0], dtype=np.int64)
    else:
        sample_weight = np.asarray(sample_weight)
    ti = np.searchsorted(labels, y_true)
    pi = np.searchsorted(labels, y_pred)
    ok = (ti < n) & (pi < n)
    ok[ok] = (labels[ti[ok]] == y_true[ok]) & (labels[pi[ok]] == y_pred[ok])
    dtype = np.int64 if sample_weight.dtype.kind in 'biu' else np.float64
    cm = np.zeros((n, n), dtype=dtype)
    np.add.at(cm, (ti[ok], pi[ok]), sample_weight[ok])
    return cm


def accuracy_score(y_true, y_pred, *, normalize: bool = True,
                   sample_weight=None) -> float:
    """The (weighted) share of samples predicted right; a multilabel
    sample counts when every label is right."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    if y_true.ndim == 2 and y_true.shape[1] > 1:
        score = np.count_nonzero(y_true - y_pred, axis=1) == 0
    else:
        score = _column(y_true) == _column(y_pred)
    if normalize:
        return float(np.average(score, weights=sample_weight))
    if sample_weight is None:
        return float(np.sum(score))
    return float(np.dot(score, sample_weight))


def balanced_accuracy_score(y_true, y_pred, *, sample_weight=None,
                            adjusted: bool = False) -> float:
    """The mean recall over the classes that occur in ``y_true``; with
    ``adjusted``, rescaled so chance scores 0."""
    C = confusion_matrix(y_true, y_pred, sample_weight=sample_weight)
    with np.errstate(divide='ignore', invalid='ignore'):
        per_class = np.diag(C) / C.sum(axis=1)
    if np.any(np.isnan(per_class)):
        warnings.warn('y_pred contains classes not in y_true')
        per_class = per_class[~np.isnan(per_class)]
    score = np.mean(per_class)
    if adjusted:
        chance = 1 / per_class.shape[0]
        score -= chance
        score /= 1 - chance
    return float(score)


def _multilabel_counts(y_true, y_pred, labels, sample_weight):
    """Per label of ``labels``: (tp, fp, fn), summed as scikit-learn's
    ``multilabel_confusion_matrix`` sums them."""
    y_true, y_pred = _column(y_true), _column(y_pred)
    known = np.unique(np.r_[labels, _labels(y_true, y_pred)])
    ti, pi = np.searchsorted(known, y_true), np.searchsorted(known, y_pred)
    w = None if sample_weight is None else np.asarray(sample_weight)
    tp = ti == pi
    n = len(known)
    tp_sum = np.bincount(ti[tp], weights=None if w is None else w[tp],
                         minlength=n)
    pred_sum = np.bincount(pi, weights=w, minlength=n)
    true_sum = np.bincount(ti, weights=w, minlength=n)
    pick = np.searchsorted(known, labels)
    tp_sum, pred_sum, true_sum = tp_sum[pick], pred_sum[pick], true_sum[pick]
    return tp_sum, pred_sum - tp_sum, true_sum - tp_sum


def _set_wise_labels(y_true, y_pred, average, labels, pos_label):
    present = _labels(y_true, y_pred)
    if average == 'binary':
        if len(present) > 2:
            raise ValueError("Target is multiclass but average='binary'. "
                             'Please choose another average setting.')
        if pos_label not in present and len(present) >= 2:
            raise ValueError(f'pos_label={pos_label} is not a valid label. '
                             f'It should be one of {present}')
        return np.asarray([pos_label])
    return present if labels is None else np.asarray(labels)


def _prf_divide(num, den, zero_division=0.0) -> np.ndarray:
    num = np.asarray(num, dtype=np.float64)
    den = np.asarray(den, dtype=np.float64).copy()
    mask = den == 0
    den[mask] = 1
    out = num / den
    out[mask] = np.nan if zero_division is np.nan else float(
        0.0 if zero_division == 'warn' else zero_division)
    return out


def _average(values, average, weights):
    if average is None:
        return values
    if average == 'weighted':
        if not np.any(weights):
            weights = None
    else:
        weights = None
    if weights is None:
        return float(np.mean(values)) if values.size else 0.0
    return float(np.average(values, weights=weights))


def precision_recall_fscore_support(y_true, y_pred, *, beta: float = 1.0,
                                    labels=None, pos_label=1,
                                    average=None, sample_weight=None,
                                    zero_division='warn'):
    labels = _set_wise_labels(y_true, y_pred, average, labels, pos_label)
    tp, fp, fn = _multilabel_counts(y_true, y_pred, labels, sample_weight)
    pred_sum, true_sum = tp + fp, tp + fn
    if average == 'micro':
        tp, pred_sum, true_sum = (np.reshape(np.sum(a), (1,))
                                  for a in (tp, pred_sum, true_sum))
    beta2 = beta ** 2
    precision = _prf_divide(tp, pred_sum, zero_division)
    recall = _prf_divide(tp, true_sum, zero_division)
    if np.isposinf(beta):
        f_score = recall
    elif beta == 0:
        f_score = precision
    else:
        f_score = _prf_divide((1 + beta2) * tp.astype(np.float64),
                              beta2 * true_sum.astype(np.float64)
                              + pred_sum.astype(np.float64), zero_division)
    weights = true_sum if average == 'weighted' else None
    if average is not None:
        return (_average(precision, average, weights),
                _average(recall, average, weights),
                _average(f_score, average, weights), None)
    return precision, recall, f_score, true_sum


def precision_score(y_true, y_pred, *, labels=None, pos_label=1,
                    average='binary', sample_weight=None,
                    zero_division='warn'):
    """tp / (tp + fp) of ``pos_label`` (or averaged over labels)."""
    return precision_recall_fscore_support(
        y_true, y_pred, labels=labels, pos_label=pos_label, average=average,
        sample_weight=sample_weight, zero_division=zero_division)[0]


def recall_score(y_true, y_pred, *, labels=None, pos_label=1,
                 average='binary', sample_weight=None, zero_division='warn'):
    """tp / (tp + fn) of ``pos_label`` (or averaged over labels)."""
    return precision_recall_fscore_support(
        y_true, y_pred, labels=labels, pos_label=pos_label, average=average,
        sample_weight=sample_weight, zero_division=zero_division)[1]


def f1_score(y_true, y_pred, *, labels=None, pos_label=1, average='binary',
             sample_weight=None, zero_division='warn'):
    """2 tp / (2 tp + fp + fn) of ``pos_label`` (or averaged over
    labels)."""
    return precision_recall_fscore_support(
        y_true, y_pred, labels=labels, pos_label=pos_label, average=average,
        sample_weight=sample_weight, zero_division=zero_division)[2]


def jaccard_score(y_true, y_pred, *, labels=None, pos_label=1,
                  average='binary', sample_weight=None,
                  zero_division='warn'):
    """tp / (tp + fp + fn) of ``pos_label`` (or averaged over labels)."""
    labels = _set_wise_labels(y_true, y_pred, average, labels, pos_label)
    tp, fp, fn = _multilabel_counts(y_true, y_pred, labels, sample_weight)
    num, den = tp, tp + fp + fn
    if average == 'micro':
        num, den = np.sum(num, keepdims=True), np.sum(den, keepdims=True)
    jac = _prf_divide(num, den, zero_division)
    return _average(jac, average, tp + fn)


def matthews_corrcoef(y_true, y_pred, *, sample_weight=None) -> float:
    """Matthews correlation coefficient over every class; 0 where either
    side is constant."""
    C = confusion_matrix(y_true, y_pred, sample_weight=sample_weight)
    t_sum = C.sum(axis=1, dtype=np.float64)
    p_sum = C.sum(axis=0, dtype=np.float64)
    n_correct = np.trace(C, dtype=np.float64)
    n_samples = p_sum.sum()
    cov_ytyp = n_correct * n_samples - np.dot(t_sum, p_sum)
    cov_ypyp = n_samples ** 2 - np.dot(p_sum, p_sum)
    cov_ytyt = n_samples ** 2 - np.dot(t_sum, t_sum)
    if cov_ypyp * cov_ytyt == 0:
        return 0.0
    return float(cov_ytyp / np.sqrt(cov_ypyp * cov_ytyt))


def cohen_kappa_score(y1, y2, *, labels=None, weights=None,
                      sample_weight=None,
                      replace_undefined_by=np.nan) -> float:
    """Cohen's kappa of two labelings, unweighted or with 'linear' or
    'quadratic' weights; ``replace_undefined_by`` where it is 0/0."""
    confusion = confusion_matrix(y1, y2, labels=labels,
                                 sample_weight=sample_weight
                                 ).astype(np.float64)
    n_classes = confusion.shape[0]
    sum0, sum1 = confusion.sum(axis=0), confusion.sum(axis=1)
    total = np.sum(sum0)
    if total == 0:
        return replace_undefined_by
    expected = np.outer(sum0, sum1) / total
    if weights is None:
        w_mat = np.ones((n_classes, n_classes))
        np.fill_diagonal(w_mat, 0)
    else:
        w_mat = np.zeros((n_classes, n_classes)) + np.arange(n_classes)
        w_mat = np.abs(w_mat - w_mat.T) if weights == 'linear' \
            else (w_mat - w_mat.T) ** 2
    den = np.sum(w_mat * expected)
    if den == 0:
        return replace_undefined_by
    return float(1 - np.sum(w_mat * confusion) / den)


# -- regression ---------------------------------------------------------------

def _reg_targets(y_true, y_pred):
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    if y_true.ndim == 1:
        y_true = y_true[:, None]
    if y_pred.ndim == 1:
        y_pred = y_pred[:, None]
    if y_true.shape != y_pred.shape:
        raise ValueError(f'y_true and y_pred have different shapes '
                         f'{y_true.shape}, {y_pred.shape}')
    return y_true, y_pred


def _outputs(errors, multioutput):
    if isinstance(multioutput, str):
        if multioutput == 'raw_values':
            return errors
        multioutput = None
    return float(np.average(errors, weights=multioutput))


def mean_absolute_error(y_true, y_pred, *, sample_weight=None,
                        multioutput='uniform_average'):
    y_true, y_pred = _reg_targets(y_true, y_pred)
    return _outputs(np.average(np.abs(y_pred - y_true), weights=sample_weight,
                               axis=0), multioutput)


def mean_squared_error(y_true, y_pred, *, sample_weight=None,
                       multioutput='uniform_average'):
    y_true, y_pred = _reg_targets(y_true, y_pred)
    return _outputs(np.average((y_true - y_pred) ** 2, axis=0,
                               weights=sample_weight), multioutput)


def _weighted_median(array: np.ndarray, sample_weight) -> np.ndarray:
    """scikit-learn's averaged inverted-CDF median of each column."""
    w = np.asarray(sample_weight, dtype=np.float64)
    if np.all(w == 0):
        return np.nan
    if w.shape != array.shape:
        w = np.tile(w, (array.shape[1], 1)).T
    order = np.argsort(array, axis=0)
    cdf = np.cumsum(np.take_along_axis(w, order, axis=0).T, axis=1)
    rank = 0.5 * cdf[:, -1]
    rank = np.where(rank == 0, np.nextafter(rank, rank + 1), rank)
    cols = np.arange(array.shape[1])
    idx = np.clip([np.searchsorted(cdf[c], rank[c]) for c in cols], 0,
                  len(array) - 1)
    at = order[idx, cols]
    above = cdf[cols, idx] - rank > np.finfo(np.float64).eps
    nxt = order[np.clip(idx + 1, 0, len(array) - 1), cols]
    for c in cols[w[nxt, cols] == 0]:
        j = np.searchsorted(cdf[c], cdf[c, idx[c]], side='right')
        nxt[c] = order[idx[c] if j > len(array) - 1 else j, c]
    return np.where(above, array[at, cols],
                    (array[at, cols] + array[nxt, cols]) / 2)


def median_absolute_error(y_true, y_pred, *, multioutput='uniform_average',
                          sample_weight=None):
    y_true, y_pred = _reg_targets(y_true, y_pred)
    err = np.abs(y_pred - y_true)
    errors = np.median(err, axis=0) if sample_weight is None \
        else _weighted_median(err, _column(sample_weight))
    return _outputs(errors, multioutput)


def r2_score(y_true, y_pred, *, sample_weight=None,
             multioutput='uniform_average', force_finite: bool = True):
    """Coefficient of determination; with ``force_finite`` a constant
    target scores 1 when predicted exactly, else 0."""
    y_true, y_pred = _reg_targets(y_true, y_pred)
    if y_pred.shape[0] < 2:
        warnings.warn('R^2 score is not well-defined with less than two '
                      'samples.')
        return float('nan')
    weight = 1.0 if sample_weight is None \
        else _column(sample_weight)[:, None]
    num = np.sum(weight * (y_true - y_pred) ** 2, axis=0)
    den = np.sum(weight * (y_true - np.average(y_true, axis=0,
                                               weights=sample_weight)) ** 2,
                 axis=0)
    if not force_finite:
        scores = 1 - num / den
    else:
        scores = np.ones(y_true.shape[1])
        valid = (den != 0) & (num != 0)
        scores[valid] = 1 - num[valid] / den[valid]
        scores[(num != 0) & (den == 0)] = 0.0
    if isinstance(multioutput, str):
        if multioutput == 'raw_values':
            return scores
        weights = None
        if multioutput == 'variance_weighted' and np.any(den != 0):
            weights = den
    else:
        weights = multioutput
    return float(np.average(scores, weights=weights))


__all__ = [
    'accuracy_score', 'auc', 'balanced_accuracy_score', 'cohen_kappa_score',
    'confusion_matrix', 'f1_score', 'jaccard_score', 'matthews_corrcoef',
    'mean_absolute_error', 'mean_squared_error', 'median_absolute_error',
    'precision_recall_curve', 'precision_recall_fscore_support',
    'precision_score', 'r2_score', 'recall_score', 'roc_auc_score',
    'roc_curve', 'top_k_accuracy_score']
