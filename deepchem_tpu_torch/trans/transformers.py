"""Dataset transformers, numpy only.

Counterparts of ``deepchem_tpu/trans/transformers.py``'s
``undo_transforms``, ``undo_grad_transforms``, ``Transformer`` and the
transformers that models use: ``MinMaxTransformer``,
``NormalizationTransformer``, ``ClippingTransformer``, ``LogTransformer``,
``BalancingTransformer``, ``DuplicateBalancingTransformer``,
``CDFTransformer``, ``PowerTransformer``, ``FlatteningTransformer``,
``IRVTransformer`` and ``CoulombFitTransformer``.
A transformer maps a dataset's arrays (``transform``) and undoes its map
of the labels on a model's outputs (``untransform``), which
``TorchModel.predict`` and ``evaluate`` apply in reverse order.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from deepchem_tpu_torch.data import NumpyDataset


def undo_transforms(y: np.ndarray,
                    transformers: Sequence['Transformer']) -> np.ndarray:
    """``y`` with every transformer of the labels undone, the last
    first."""
    for transformer in reversed(list(transformers)):
        if transformer.transform_y:
            y = transformer.untransform(y)
    return y


def undo_grad_transforms(grad, tasks, transformers):
    """``grad`` with every transformer of the labels undone, the last
    first (``untransform_grad``)."""
    for transformer in reversed(list(transformers)):
        if transformer.transform_y:
            grad = transformer.untransform_grad(grad, tasks)
    return grad


class Transformer:
    """A map of some of a dataset's arrays: X, y, w and ids."""

    def __init__(self, transform_X: bool = False, transform_y: bool = False,
                 transform_w: bool = False, transform_ids: bool = False,
                 dataset: Optional[NumpyDataset] = None):
        self.transform_X = transform_X
        self.transform_y = transform_y
        self.transform_w = transform_w
        self.transform_ids = transform_ids
        if not (transform_X or transform_y or transform_w or transform_ids):
            raise ValueError('Transformer must transform at least one array')

    def transform_array(self, X, y, w, ids) -> Tuple:
        raise NotImplementedError

    def untransform(self, z):
        raise NotImplementedError('Cannot untransform')

    def untransform_grad(self, grad, tasks):
        raise NotImplementedError('Cannot untransform gradients')

    def transform(self, dataset: NumpyDataset) -> NumpyDataset:
        return dataset.transform(self)

    def transform_on_array(self, X, y, w, ids):
        return self.transform_array(X, y, w, ids)

    def __repr__(self):
        return type(self).__name__


class NormalizationTransformer(Transformer):
    """Z-scores of X or y from ``dataset``'s means and standard deviations
    (population, over samples; a deviation of 0 counts as 1).  With
    ``move_mean=False`` only the scale is changed."""

    def __init__(self, transform_X: bool = False, transform_y: bool = False,
                 transform_w: bool = False,
                 dataset: Optional[NumpyDataset] = None,
                 move_mean: bool = True):
        super().__init__(transform_X=transform_X, transform_y=transform_y,
                         transform_w=transform_w, dataset=dataset)
        if dataset is None:
            raise ValueError('dataset required')
        self.move_mean = move_mean
        if transform_X:
            self.X_means, X_stds = dataset.get_statistics(True, False)
            self.X_stds = np.where(np.asarray(X_stds) != 0, X_stds, 1.0)
        if transform_y:
            self.y_means, y_stds = dataset.get_statistics(False, True)
            self.y_stds = np.where(np.asarray(y_stds) != 0, y_stds, 1.0)

    def transform_array(self, X, y, w, ids):
        if self.transform_X:
            X = (X - self.X_means) / self.X_stds if self.move_mean \
                else X / self.X_stds
        if self.transform_y:
            y = (y - self.y_means) / self.y_stds if self.move_mean \
                else y / self.y_stds
        return X, y, w, ids

    def untransform(self, z):
        means, stds = (self.y_means, self.y_stds) if self.transform_y \
            else (self.X_means, self.X_stds)
        return z * stds + means if self.move_mean else z * stds

    def untransform_grad(self, grad, tasks):
        return grad * self.y_stds if self.transform_y else grad


class MinMaxTransformer(Transformer):
    """Scale X or y to [0, 1] by ``dataset``'s per-column minimum and
    maximum (a constant column is only shifted)."""

    def __init__(self, transform_X: bool = False, transform_y: bool = False,
                 dataset: Optional[NumpyDataset] = None):
        super().__init__(transform_X=transform_X, transform_y=transform_y,
                         dataset=dataset)
        if dataset is None:
            raise ValueError('dataset required')
        if transform_X:
            self.X_min = np.min(dataset.X, axis=0)
            self.X_max = np.max(dataset.X, axis=0)
        if transform_y:
            self.y_min = np.min(dataset.y, axis=0)
            self.y_max = np.max(dataset.y, axis=0)

    def transform_array(self, X, y, w, ids):
        if self.transform_X:
            X = (X - self.X_min) / np.where(self.X_max > self.X_min,
                                            self.X_max - self.X_min, 1)
        if self.transform_y:
            y = (y - self.y_min) / np.where(self.y_max > self.y_min,
                                            self.y_max - self.y_min, 1)
        return X, y, w, ids

    def untransform(self, z):
        if self.transform_y:
            return z * (self.y_max - self.y_min) + self.y_min
        return z * (self.X_max - self.X_min) + self.X_min


class ClippingTransformer(Transformer):
    """Clip X to ``[-x_max, x_max]`` and y to ``[-y_max, y_max]``."""

    def __init__(self, transform_X: bool = False, transform_y: bool = False,
                 dataset: Optional[NumpyDataset] = None,
                 x_max: float = 5.0, y_max: float = 500.0):
        super().__init__(transform_X=transform_X, transform_y=transform_y,
                         dataset=dataset)
        self.x_max = x_max
        self.y_max = y_max

    def transform_array(self, X, y, w, ids):
        if self.transform_X:
            X = np.clip(X, -self.x_max, self.x_max)
        if self.transform_y:
            y = np.clip(y, -self.y_max, self.y_max)
        return X, y, w, ids


class LogTransformer(Transformer):
    """``log(1 + v)`` of X (the columns ``features``) or y (the columns
    ``tasks``, indices or task names of ``dataset``)."""

    def __init__(self, transform_X: bool = False, transform_y: bool = False,
                 features: Optional[Sequence[int]] = None,
                 tasks: Optional[Sequence] = None,
                 dataset: Optional[NumpyDataset] = None):
        super().__init__(transform_X=transform_X, transform_y=transform_y,
                         dataset=dataset)
        self.features = features
        self.tasks = tasks
        if dataset is not None and tasks is not None \
                and not isinstance(tasks[0], (int, np.integer)):
            names = list(dataset.get_task_names())
            self.tasks = [names.index(t) for t in tasks]

    def transform_array(self, X, y, w, ids):
        if self.transform_X:
            X = _apply_columns(np.log1p, X, self.features)
        if self.transform_y:
            y = _apply_columns(np.log1p, y, self.tasks)
        return X, y, w, ids

    def untransform(self, z):
        return _apply_columns(np.expm1, z, self.tasks if self.transform_y
                              else self.features)


def _apply_columns(fn, a, columns):
    a = np.asarray(a, dtype=float)
    if columns is None:
        return fn(a)
    out = a.copy()
    out[:, columns] = fn(a[:, columns])
    return out


class BalancingTransformer(Transformer):
    """Reweight the samples so each class carries the same total weight
    in each task: a class's weights are scaled by ``total / (n_classes *
    count)`` over the samples of nonzero weight."""

    def __init__(self, dataset: NumpyDataset):
        super().__init__(transform_w=True, dataset=dataset)
        y, w = np.asarray(dataset.y), np.asarray(dataset.w)
        if y.ndim == 1:
            y, w = y[:, None], w[:, None]
        y_int = np.round(y).astype(int)
        classes = np.unique(y_int[w != 0]) if w.size else np.unique(y_int)
        self.classes = classes
        self.weights = []
        for t in range(y.shape[1]):
            valid = w[:, t] != 0
            total = valid.sum()
            cw = {}
            for c in classes:
                cnt = np.logical_and(y_int[:, t] == c, valid).sum()
                cw[int(c)] = (total / (len(classes) * cnt)) if cnt else 1.0
            self.weights.append(cw)

    def transform_array(self, X, y, w, ids):
        w_out = np.asarray(w, dtype=float).copy()
        y2 = y[:, None] if np.asarray(y).ndim == 1 else y
        w2 = w_out[:, None] if w_out.ndim == 1 else w_out
        y_int = np.round(np.asarray(y2)).astype(int)
        for t in range(y2.shape[1]):
            for c, cw in self.weights[t].items():
                mask = np.logical_and(y_int[:, t] == c, w2[:, t] != 0)
                w2[mask, t] = w2[mask, t] * cw
        return X, y, w2.reshape(np.asarray(w).shape), ids


class DuplicateBalancingTransformer(Transformer):
    """Repeat each sample of a single task ``round(max_count / count)``
    times, ``count`` its class's number of samples of nonzero weight."""

    def __init__(self, dataset: NumpyDataset):
        super().__init__(transform_X=True, transform_y=True,
                         transform_w=True, transform_ids=True,
                         dataset=dataset)
        y = np.round(dataset.y).astype(int)
        if y.shape[1] != 1:
            raise ValueError('only singletask supported')
        classes, counts = np.unique(y[dataset.w != 0], return_counts=True)
        m = counts.max()
        self.duplication = {int(c): int(np.round(m / cnt))
                            for c, cnt in zip(classes, counts)}

    def transform_array(self, X, y, w, ids):
        y_int = np.round(np.asarray(y)).astype(int).reshape(len(y))
        w_flat = np.asarray(w).reshape(len(w))
        reps = [self.duplication.get(int(y_int[i]), 1) if w_flat[i] != 0
                else 1 for i in range(len(y))]
        idx = np.repeat(np.arange(len(y)), reps)
        return (np.asarray(X)[idx], np.asarray(y)[idx],
                np.asarray(w)[idx], np.asarray(ids)[idx])


class CDFTransformer(Transformer):
    """Each column's ranks over its samples divided by their number; y's
    untransform maps a rank back to ``dataset``'s value of that
    quantile."""

    def __init__(self, transform_X: bool = False, transform_y: bool = False,
                 dataset: Optional[NumpyDataset] = None, bins: int = 2):
        super().__init__(transform_X=transform_X, transform_y=transform_y,
                         dataset=dataset)
        self.bins = bins
        if transform_y:
            self.y = dataset.y
            self._y_orig_sorted = np.sort(np.asarray(dataset.y, dtype=float),
                                          axis=0)

    def transform_array(self, X, y, w, ids):
        if self.transform_X:
            X = _cdf_values(np.asarray(X, dtype=float))
        if self.transform_y:
            y = _cdf_values(np.asarray(y, dtype=float))
        return X, y, w, ids

    def untransform(self, z):
        z = np.asarray(z)
        ys = self._y_orig_sorted
        ranks = np.clip((z * len(ys)).astype(int), 0, len(ys) - 1)
        if z.ndim == 1:
            return (ys[:, 0] if ys.ndim > 1 else ys)[ranks].astype(float)
        out = np.zeros_like(z, dtype=float)
        for t in range(z.shape[1]):
            out[:, t] = (ys[:, t] if ys.ndim > 1 else ys)[ranks[:, t]]
        return out


def _cdf_values(arr: np.ndarray) -> np.ndarray:
    cols = arr if arr.ndim > 1 else arr[:, None]
    n = cols.shape[0]
    res = np.zeros_like(cols, dtype=float)
    for t in range(cols.shape[1]):
        ranks = np.empty(n)
        ranks[np.argsort(cols[:, t], kind='stable')] = np.arange(n)
        res[:, t] = ranks / n
    return res if arr.ndim > 1 else res[:, 0]


class PowerTransformer(Transformer):
    """The columns of X or y raised to each of ``powers``, side by side;
    the untransform keeps the first block."""

    def __init__(self, transform_X: bool = False, transform_y: bool = False,
                 dataset: Optional[NumpyDataset] = None,
                 powers: Sequence[int] = (1,)):
        super().__init__(transform_X=transform_X, transform_y=transform_y,
                         dataset=dataset)
        self.powers = list(powers)

    def transform_array(self, X, y, w, ids):
        if self.transform_X:
            X = np.concatenate([np.power(np.asarray(X, dtype=float), p)
                                for p in self.powers], axis=1)
        if self.transform_y:
            y = np.concatenate([np.power(np.asarray(y, dtype=float), p)
                                for p in self.powers], axis=1)
        return X, y, w, ids

    def untransform(self, z):
        return z[:, :z.shape[1] // len(self.powers)]


class FlatteningTransformer(Transformer):
    """Each sample's ragged features laid end to end, its y, w and id
    repeated once a feature."""

    def __init__(self, dataset: Optional[NumpyDataset] = None):
        super().__init__(transform_X=True, transform_y=True,
                         transform_w=True, transform_ids=True,
                         dataset=dataset)

    def transform_array(self, X, y, w, ids):
        lens = [len(np.atleast_1d(x)) for x in X]
        X_out = np.concatenate([np.atleast_1d(x) for x in X])
        y_out = np.repeat(y, lens, axis=0) if y is not None else None
        w_out = np.repeat(w, lens, axis=0) if w is not None else None
        return X_out, y_out, w_out, np.repeat(ids, lens, axis=0)


class IRVTransformer(Transformer):
    """Influence-relevance-voting features: for each sample and task, the
    Tanimoto similarities of its ``K`` most similar samples of ``dataset``
    that carry that task's label (weight not 0), then those samples'
    labels, ``[n, n_tasks * 2K]`` float32.  A sample of ``dataset`` itself
    (similarity 1 and the same bit count) is skipped; a sample with fewer
    than ``K`` candidates repeats its most similar one."""

    def __init__(self, K: int, n_tasks: int, dataset: NumpyDataset):
        super().__init__(transform_X=True, dataset=dataset)
        self.K = K
        self.n_tasks = n_tasks
        self.X_ref = np.asarray(dataset.X, dtype=np.float32)
        self.y_ref = np.asarray(dataset.y)
        self.w_ref = np.asarray(dataset.w)

    @staticmethod
    def matrix_mul(X1: np.ndarray, X2: np.ndarray,
                   shard_size: int = 5000) -> np.ndarray:
        """``X1 @ X2`` in float32, ``shard_size`` rows of ``X1`` at a
        time."""
        X1 = np.asarray(X1, dtype=np.float32)
        X2 = np.asarray(X2, dtype=np.float32)
        out = [X1[i:i + shard_size] @ X2
               for i in range(0, len(X1), shard_size)]
        return np.concatenate(out) if out else X1 @ X2

    def transform_array(self, X, y, w, ids):
        X = np.asarray(X, dtype=np.float32)
        ref = self.X_ref
        counts_ref = ref.sum(axis=1)
        counts = X.sum(axis=1)
        inter = self.matrix_mul(X, ref.T)
        union = counts[:, None] + counts_ref[None, :] - inter
        sim = np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)
        n, K = len(X), self.K
        feats = np.zeros((n, self.n_tasks * 2 * K), dtype=np.float32)
        same = np.isclose(sim, 1.0) & (counts[:, None] == counts_ref[None, :])
        for t in range(self.n_tasks):
            s = sim.copy()
            s[:, self.w_ref[:, t] == 0] = -1
            order = np.argsort(-s, axis=1)[:, :K + 1]
            base = t * 2 * K
            for i in range(n):
                picks = [j for j in order[i] if not same[i, j]][:K]
                picks += [order[i][0]] * (K - len(picks))
                feats[i, base:base + K] = sim[i, picks]
                feats[i, base + K:base + 2 * K] = self.y_ref[picks, t]
        return feats, y, w, ids


class CoulombFitTransformer(Transformer):
    """Coulomb matrices for a dense regressor: :meth:`realize` orders each
    matrix's rows and columns by its row norms plus unit normal noise from
    ``RandomState(random_seed)``, drawn on in turn (largest first), and
    flattens it; :meth:`expand` binarizes every entry into ``tanh((x -
    t) / step)`` for the thresholds ``t`` in ``arange(-1, 2, step)``
    (step 1: three), the thresholds' blocks side by side; :meth:`normalize`
    takes z-scores by the means and deviations of ``dataset``'s expanded
    matrices (population; a deviation of 0 counts as 1).  ``X_transform``
    is the three in turn; a 2-D ``X`` (already flat) skips
    :meth:`realize`."""

    def __init__(self, dataset: NumpyDataset, random_seed: int = 0):
        super().__init__(transform_X=True, dataset=dataset)
        self.rng = np.random.RandomState(random_seed)
        X = np.asarray(dataset.X, dtype=float)
        if X.ndim == 3:
            X = X.reshape(len(X), -1)
        self.step = 1.0
        self.noise = 1.0
        Xb = self._expand(X)
        self.mean = Xb.mean(axis=0)
        self.std = Xb.std(axis=0)
        self.std = np.where(self.std != 0, self.std, 1.0)

    def _expand(self, X: np.ndarray) -> np.ndarray:
        return np.concatenate([np.tanh((X - t) / self.step)
                               for t in np.arange(-1, 2, self.step)], axis=1)

    def realize(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=float)
        if X.ndim != 3:
            return X
        n = X.shape[1]
        out = []
        for m in X:
            row_norms = np.linalg.norm(m, axis=1)
            e = self.rng.normal(size=n) * self.noise
            p = np.argsort(-(row_norms + e))
            out.append(m[p][:, p].reshape(-1))
        return np.stack(out)

    def normalize(self, X: np.ndarray) -> np.ndarray:
        return (X - self.mean) / self.std

    def expand(self, X: np.ndarray) -> np.ndarray:
        return self._expand(np.asarray(X, dtype=float))

    def X_transform(self, X: np.ndarray) -> np.ndarray:
        return self.normalize(self._expand(self.realize(X)))

    def transform_array(self, X, y, w, ids):
        return self.X_transform(X), y, w, ids
