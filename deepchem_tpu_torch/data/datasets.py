"""In-memory dataset of (X, y, w, ids) samples and batch padding."""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def pad_batch(batch_size: int, X_b: np.ndarray, y_b: Optional[np.ndarray],
              w_b: Optional[np.ndarray],
              ids_b: Optional[np.ndarray]) -> Batch:
    """Pad a batch up to ``batch_size`` by wrapping samples; padded rows get
    weight zero so losses and metrics ignore them."""
    num = len(X_b)
    if num == batch_size:
        return X_b, y_b, w_b, ids_b

    def _pad(arr):
        if arr is None:
            return None
        out = np.zeros((batch_size,) + arr.shape[1:], dtype=arr.dtype)
        out[:num] = arr
        for i in range(num, batch_size):
            out[i] = arr[i % num]
        return out

    w_out = None
    if w_b is not None:
        w_out = np.zeros((batch_size,) + w_b.shape[1:], dtype=w_b.dtype)
        w_out[:num] = w_b
    return _pad(X_b), _pad(y_b), w_out, _pad(ids_b)


class NumpyDataset:
    """In-memory dataset.  With no labels, ``y`` is zeros of shape
    ``(n, n_tasks)`` and ``w`` zeros of the same shape."""

    def __init__(self, X, y=None, w=None, ids=None, n_tasks: int = 1) -> None:
        n = len(X)
        X = X if isinstance(X, np.ndarray) else np.asarray(X)
        if y is None:
            y = np.zeros((n, n_tasks), dtype=np.float32)
            w = np.zeros_like(y) if w is None else w
        y = np.asarray(y)
        if y.ndim == 1:
            y = y[:, None]
        if w is None:
            w = np.ones(y.shape if y.ndim <= 2 else y.shape[:2],
                        dtype=np.float32)
        w = np.asarray(w)
        if w.ndim == 1 and len(w) == n:
            w = w[:, None]
        if w.ndim == 0:
            w = np.full(y.shape, float(w), dtype=np.float32)
        elif w.shape != y.shape and y.ndim == 2:
            try:
                w = np.broadcast_to(w, y.shape).copy()
            except ValueError:
                pass      # as the JAX package: left to the metrics
        self._X = X
        self._y = y
        self._w = w
        self._ids = np.asarray(np.arange(n) if ids is None else ids,
                               dtype=object)

    def __len__(self) -> int:
        return len(self._X)

    @property
    def X(self) -> np.ndarray:
        return self._X

    @property
    def y(self) -> np.ndarray:
        return self._y

    @property
    def w(self) -> np.ndarray:
        return self._w

    @property
    def ids(self) -> np.ndarray:
        return self._ids

    def get_task_names(self) -> np.ndarray:
        """The tasks' indices, ``0 .. n_tasks - 1``."""
        return np.arange(self._y.shape[1]) if self._y.ndim > 1 \
            else np.array([0])

    def iterbatches(self, batch_size: Optional[int] = None, epochs: int = 1,
                    deterministic: bool = False,
                    pad_batches: bool = False) -> Iterator[Batch]:
        n = len(self)
        if batch_size is None:
            batch_size = n
        for _ in range(epochs):
            perm = np.arange(n) if deterministic else np.random.permutation(n)
            for start in range(0, n, batch_size):
                idx = perm[start:start + batch_size]
                X_b, y_b = self._X[idx], self._y[idx]
                w_b, ids_b = self._w[idx], self._ids[idx]
                if pad_batches and len(idx) < batch_size:
                    X_b, y_b, w_b, ids_b = pad_batch(batch_size, X_b, y_b,
                                                     w_b, ids_b)
                yield X_b, y_b, w_b, ids_b

    def transform(self, transformer) -> 'NumpyDataset':
        """A new dataset of ``transformer.transform_array``'s arrays."""
        return NumpyDataset(*transformer.transform_array(
            self._X, self._y, self._w, self._ids))

    def get_statistics(self, X_stats: bool = True,
                       y_stats: bool = True) -> Tuple:
        """Means and population standard deviations over the samples, in
        float64: ``(X_means, X_stds)`` then ``(y_means, y_stds)``, each
        pair where it is asked for."""
        out = []
        for wanted, arr in ((X_stats, self._X), (y_stats, self._y)):
            if not wanted:
                continue
            total = sumsq = None
            for a in arr:             # sample by sample, as the JAX package
                a = np.asarray(a, dtype=np.float64)
                total = a if total is None else total + a
                sumsq = a * a if sumsq is None else sumsq + a * a
            means = total / len(arr)
            out += [means, np.sqrt(np.maximum(sumsq / len(arr) - means ** 2,
                                              0))]
        return tuple(out)


class ImageDataset(NumpyDataset):
    """A dataset whose X (and perhaps y) are images, given as arrays.
    With no labels, ``y`` is zeros ``(n, 1)``; ``w`` is ones of ``y``'s
    shape; the ids default to ``0 .. n - 1``.  Image files (a list of
    paths) need an image decoder, which the port does not carry: they
    raise ``NotImplementedError`` (``ROADMAP.md`` §1 item 2)."""

    def __init__(self, X, y, w=None, ids=None) -> None:
        for arr in (X, y):
            if arr is not None and not (isinstance(arr, np.ndarray)
                                        and arr.dtype != object):
                raise NotImplementedError(
                    'ImageDataset from image files needs an image decoder, '
                    'which the port does not carry (ROADMAP.md section 1 '
                    'item 2); give the images as arrays')
        n = len(X)
        self._X = X
        self._y = np.zeros((n, 1), dtype=np.float32) if y is None \
            else np.asarray(y)
        self._w = np.ones(self._y.shape, dtype=np.float32) if w is None \
            else np.asarray(w)
        self._ids = np.asarray(np.arange(n) if ids is None else ids,
                               dtype=object)

    def get_shape(self):
        return self._X.shape, self._y.shape, self._w.shape, self._ids.shape

    def select(self, indices) -> 'ImageDataset':
        indices = np.asarray(indices)
        return ImageDataset(self._X[indices], self._y[indices],
                            self._w[indices], self._ids[indices])
