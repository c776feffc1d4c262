"""Dataset transformers, numpy only.

Counterparts of ``deepchem_tpu/trans/transformers.py``'s
``undo_transforms``, ``undo_grad_transforms``, ``Transformer`` and the
transformers that models use: ``MinMaxTransformer``,
``NormalizationTransformer``, ``ClippingTransformer``, ``LogTransformer``,
``BalancingTransformer``, ``DuplicateBalancingTransformer``,
``CDFTransformer``, ``PowerTransformer``, ``FlatteningTransformer``,
``IRVTransformer`` and ``CoulombFitTransformer``; and
``FeaturizationTransformer``, ``RxnSplitTransformer``,
``ImageTransformer`` and ``DataTransforms`` for the sequence and image
models, whose resize reproduces Pillow's in numpy (:func:`pil_resize`).
A transformer maps a dataset's arrays (``transform``) and undoes its map
of the labels on a model's outputs (``untransform``), which
``TorchModel.predict`` and ``evaluate`` apply in reverse order.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

from deepchem_tpu_torch.data import Dataset, DiskDataset


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
                 dataset: Optional[Dataset] = None):
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

    def transform(self, dataset: Dataset, parallel: bool = False,
                  out_dir: Optional[str] = None, **kwargs) -> Dataset:
        """``dataset`` through :meth:`transform_array`: a ``DiskDataset``
        shard by shard into ``out_dir`` (default a new temporary folder),
        any other dataset in memory."""
        if isinstance(dataset, DiskDataset):
            return dataset.transform(self, out_dir=out_dir)
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
                 dataset: Optional[Dataset] = None,
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
                 dataset: Optional[Dataset] = None):
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
                 dataset: Optional[Dataset] = None,
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
                 dataset: Optional[Dataset] = None):
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

    def __init__(self, dataset: Dataset):
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

    def __init__(self, dataset: Dataset):
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
                 dataset: Optional[Dataset] = None, bins: int = 2):
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
                 dataset: Optional[Dataset] = None,
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

    def __init__(self, dataset: Optional[Dataset] = None):
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

    def __init__(self, K: int, n_tasks: int, dataset: Dataset):
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

    def __init__(self, dataset: Dataset, random_seed: int = 0):
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


class FeaturizationTransformer(Transformer):
    """X (raw datapoints, such as SMILES) featurized by ``featurizer``."""

    def __init__(self, dataset: Optional[Dataset] = None,
                 featurizer=None):
        super().__init__(transform_X=True, dataset=dataset)
        if featurizer is None:
            raise ValueError('featurizer required')
        self.featurizer = featurizer

    def transform_array(self, X, y, w, ids):
        return self.featurizer.featurize(list(X)), y, w, ids


class RxnSplitTransformer(Transformer):
    """Reaction SMILES ``reactants>reagents>products`` split into rows of
    ``[source, product]``: the source ``reactants>reagents`` with
    ``sep_reagent``, else ``reactants.reagents>`` (``reactants>`` with no
    reagents)."""

    def __init__(self, sep_reagent: bool = True,
                 dataset: Optional[Dataset] = None):
        super().__init__(transform_X=True, dataset=dataset)
        self.sep_reagent = sep_reagent

    def transform_array(self, X, y, w, ids):
        out = []
        for rxn in X:
            reactant, reagent, product = (str(rxn).split('>')
                                          + ['', '', ''])[:3]
            if self.sep_reagent:
                source = f'{reactant}>{reagent}'
            else:
                source = (f'{reactant}.{reagent}' if reagent
                          else reactant) + '>'
            out.append([source, product])
        return np.asarray(out), y, w, ids


# Pillow's resampling of 8-bit images: coefficients in fixed point of 22
# fraction bits (32 - 8 - 2), rounding from half of the last one
_PRECISION_BITS = 22


def _bicubic(x: float) -> float:
    """Pillow's bicubic filter (Keys, a = -0.5), support 2."""
    x = abs(x)
    if x < 1.0:
        return (1.5 * x - 2.5) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * -0.5
    return 0.0


def _resample_coefficients(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` for the whole input: each output
    pixel's first input pixel and its filter weights, normalised to sum
    to 1, in float64 ``[out_size, taps]`` (zero past a pixel's own
    count)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    taps = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, dtype=np.int64)
    kk = np.zeros((out_size, taps))
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in k:
            ww += v
        first[xx] = xmin
        kk[xx, :xmax] = [v / ww if ww != 0.0 else v for v in k]
    return first, kk


def _resample_axis(a: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's two-pass resample along ``axis``: uint8 in
    fixed point (each weight rounded away from 0 to 22 fraction bits, the
    sum started at half of the last bit, clipped to 0..255), float32 in
    float64 sums stored as float32; each output the taps summed in
    order."""
    first, kk = _resample_coefficients(a.shape[axis], out_size)
    a = np.moveaxis(a, axis, 0)
    eight_bit = a.dtype == np.uint8
    if eight_bit:
        scaled = kk * (1 << _PRECISION_BITS)
        kk = np.where(scaled < 0, np.trunc(scaled - 0.5),
                      np.trunc(scaled + 0.5)).astype(np.int64)
        src = a.astype(np.int64)
        acc = np.full((out_size,) + a.shape[1:], 1 << (_PRECISION_BITS - 1),
                      dtype=np.int64)
    else:
        src = a.astype(np.float64)
        acc = np.zeros((out_size,) + a.shape[1:])
    shape = (out_size,) + (1,) * (a.ndim - 1)
    for t in range(kk.shape[1]):
        rows = np.minimum(first + t, len(a) - 1)    # weight 0 past the end
        acc = acc + src[rows] * kk[:, t].reshape(shape)
    if eight_bit:
        out = np.where(acc >= (1 << _PRECISION_BITS << 8), 255,
                       np.where(acc <= 0, 0, acc >> _PRECISION_BITS)
                       ).astype(np.uint8)
    else:
        out = acc.astype(np.float32)
    return np.moveaxis(out, 0, axis)


def pil_resize(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``np.asarray(PIL.Image.fromarray(image).resize(size))`` without
    Pillow: its default bicubic filter, antialiased on a downscale (the
    filter widened by the scale), horizontal pass first, for uint8 ``L``
    (``[H, W]``) and ``RGB`` (``[H, W, 3]``) images and float ``F`` ones
    (``[H, W]``, computed in float32 as Pillow stores them).  ``size`` is
    ``(width, height)``."""
    a = np.asarray(image)
    if a.dtype == np.uint8 and (a.ndim == 2 or (a.ndim == 3
                                                and a.shape[2] == 3)):
        pass
    elif a.ndim == 2 and a.dtype.kind == 'f':
        a = a.astype(np.float32)
    else:
        raise NotImplementedError(
            f'images of {a.dtype} {a.shape}: resized for uint8 L and RGB '
            'and float L images only')
    width, height = size
    if width != a.shape[1]:
        a = _resample_axis(a, width, 1)
    if height != a.shape[0]:
        a = _resample_axis(a, height, 0)
    return np.array(a)


class ImageTransformer(Transformer):
    """Each image of X resized to ``size`` ``(width, height)`` as Pillow's
    ``Image.resize`` does (:func:`pil_resize`)."""

    def __init__(self, size: Tuple[int, int],
                 dataset: Optional[Dataset] = None):
        super().__init__(transform_X=True, dataset=dataset)
        self.size = size

    def transform_array(self, X, y, w, ids):
        return np.stack([pil_resize(x, self.size) for x in X]), y, w, ids


class DataTransforms:
    """Augmentations of one image ``[H, W]`` or ``[H, W, C]``."""

    def __init__(self, Image: np.ndarray):
        self.Image = np.asarray(Image)

    def scale(self, h: int, w: int) -> np.ndarray:
        """The image resized to ``h x w`` (:func:`pil_resize`)."""
        return pil_resize(self.Image, (w, h))

    def center_crop(self, x_crop: int, y_crop: int) -> np.ndarray:
        """The ``y_crop x x_crop`` region around the image's centre."""
        y, x = self.Image.shape[0], self.Image.shape[1]
        x_start = x // 2 - (x_crop // 2)
        y_start = y // 2 - (y_crop // 2)
        return self.Image[y_start:y_start + y_crop,
                          x_start:x_start + x_crop]

    def flip(self, direction: str = 'lr') -> np.ndarray:
        if direction == 'lr':
            return np.fliplr(self.Image)
        if direction == 'ud':
            return np.flipud(self.Image)
        raise ValueError('direction must be "lr" or "ud"')

    def rotate(self, angle: float = 0) -> np.ndarray:
        """Rotated by the whole quarter turns in ``angle`` degrees."""
        return np.rot90(self.Image, int(angle // 90) % 4)

    def crop(self, left: int, top: int, x_crop_size: int,
             y_crop_size: int) -> np.ndarray:
        return self.Image[top:top + y_crop_size, left:left + x_crop_size]

    def convert2gray(self) -> np.ndarray:
        return np.dot(self.Image[..., :3], [0.2989, 0.5870, 0.1140])

    def shift(self, width: int, height: int, mode='constant') -> np.ndarray:
        """Moved ``width`` right and ``height`` down, zeros shifted in."""
        out = np.zeros_like(self.Image)
        h, w = self.Image.shape[:2]
        ws, hs = int(width), int(height)
        out[max(0, hs):min(h, h + hs), max(0, ws):min(w, w + ws)] = \
            self.Image[max(0, -hs):min(h, h - hs),
                       max(0, -ws):min(w, w - ws)]
        return out

    def gaussian_blur(self, sigma: float = 1.0) -> np.ndarray:
        from scipy.ndimage import gaussian_filter
        return gaussian_filter(self.Image, sigma)

    def salt_pepper_noise(self, prob: float = 0.05, salt: float = 255,
                          pepper: float = 0):
        """Pixels set to ``pepper`` or ``salt`` with probability ``prob /
        2`` each (``RandomState(0)``)."""
        rng = np.random.RandomState(0)
        out = self.Image.copy()
        mask = rng.rand(*self.Image.shape[:2])
        out[mask < prob / 2] = pepper
        out[mask > 1 - prob / 2] = salt
        return out

    def gaussian_noise(self, mean: float = 0, std: float = 25.5):
        rng = np.random.RandomState(0)
        return self.Image + rng.normal(mean, std, self.Image.shape)

    def median_filter(self, size: int):
        from scipy.ndimage import median_filter
        return median_filter(self.Image, size)
