"""Datasets of (X, y, w, ids) samples: in memory and sharded on disk.

The port's own copy of ``deepchem_tpu/data/datasets.py``: the
``Dataset`` base, ``NumpyDataset``, ``DiskDataset``, ``ImageDataset`` (on
arrays), ``Databag`` and the feature helpers.  ``DiskDataset`` keeps the
JAX package's layout of a manifest and one file set a shard, in a format
of its own that needs neither joblib nor pandas::

    data_dir/
      manifest.json   {"format": "deepchem_tpu_torch.shards/1",
                       "tasks": [...],
                       "shards": [{"rows": n, "file": "shard-0",
                                   "arrays": {"X": "pkl", "y": "npy",
                                              "w": "npy", "ids": "pkl"}}]}
      shard-0.X.pkl   object arrays pickled
      shard-0.y.npy   numeric arrays as .npy
      ...

A folder written by the JAX package (joblib shards, a manifest without
the format) is refused with its path named: neither package reads the
other's shards.  Shuffles draw from numpy's and Python's global streams
as the JAX package's do, or from generators the caller passes.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import queue as queue_mod
import random
import shutil
import tempfile
import threading
from typing import (Dict, Iterable, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np

from deepchem_tpu_torch.utils.data_utils import Table, move_or_copy

logger = logging.getLogger(__name__)

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]
SHARD_FORMAT = 'deepchem_tpu_torch.shards/1'


def sparsify_features(X: np.ndarray) -> np.ndarray:
    """Dense binary features as an object array of each row's nonzero
    indices."""
    out = np.empty(len(X), dtype=object)
    for i in range(len(X)):
        out[i] = np.nonzero(X[i])[0]
    return out


def densify_features(X_sparse: np.ndarray, num_features: int) -> np.ndarray:
    """The inverse of :func:`sparsify_features`, in float64."""
    out = np.zeros((len(X_sparse), num_features))
    for i in range(len(X_sparse)):
        out[i][X_sparse[i]] = 1.0
    return out


def pad_features(batch_size: int, X_b: np.ndarray) -> np.ndarray:
    """``X_b`` padded up to ``batch_size`` rows by repeating its rows."""
    num = len(X_b)
    if num == batch_size:
        return X_b
    if num > batch_size:
        raise ValueError(f'{num} rows exceed the batch size {batch_size}')
    out = np.zeros((batch_size,) + X_b.shape[1:], dtype=X_b.dtype)
    out[:num] = X_b
    for i in range(num, batch_size):
        out[i] = X_b[i % num]
    return out


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


class Dataset:
    """A collection of (X, y, w, ids) samples.  Subclasses give the
    arrays, ``iterbatches``, ``itersamples``, ``select`` and
    ``transform``."""

    #: raised by in-place changes (``DiskDataset.set_shard``, ``reshard``)
    #: so that batches a model keeps for the dataset are packed again
    _version: int = 0

    def __len__(self) -> int:
        raise NotImplementedError

    def get_shape(self) -> Tuple:
        raise NotImplementedError

    def get_task_names(self) -> np.ndarray:
        raise NotImplementedError

    @property
    def X(self) -> np.ndarray:
        raise NotImplementedError

    @property
    def y(self) -> np.ndarray:
        raise NotImplementedError

    @property
    def w(self) -> np.ndarray:
        raise NotImplementedError

    @property
    def ids(self) -> np.ndarray:
        raise NotImplementedError

    def iterbatches(self, batch_size: Optional[int] = None, epochs: int = 1,
                    deterministic: bool = False, pad_batches: bool = False,
                    rng: Optional[np.random.RandomState] = None
                    ) -> Iterator[Batch]:
        raise NotImplementedError

    def itersamples(self) -> Iterator[Batch]:
        raise NotImplementedError

    def transform(self, transformer, **kwargs) -> 'Dataset':
        raise NotImplementedError

    def select(self, indices: Sequence[int],
               select_dir: Optional[str] = None) -> 'Dataset':
        raise NotImplementedError

    def get_statistics(self, X_stats: bool = True,
                       y_stats: bool = True) -> Tuple:
        """Means and population standard deviations over the samples, in
        float64, summed sample by sample: ``(X_means, X_stds)`` then
        ``(y_means, y_stds)``, each pair where it is asked for."""
        X_sum = X_sumsq = y_sum = y_sumsq = None
        n = 0
        for X, y, _, _ in self.itersamples():
            n += 1
            if X_stats:
                X = np.asarray(X, dtype=np.float64)
                X_sum = X if X_sum is None else X_sum + X
                X_sumsq = X * X if X_sumsq is None else X_sumsq + X * X
            if y_stats:
                y = np.asarray(y, dtype=np.float64)
                y_sum = y if y_sum is None else y_sum + y
                y_sumsq = y * y if y_sumsq is None else y_sumsq + y * y
        out = []
        for wanted, total, sumsq in ((X_stats, X_sum, X_sumsq),
                                     (y_stats, y_sum, y_sumsq)):
            if wanted:
                means = total / n
                out += [means, np.sqrt(np.maximum(sumsq / n - means ** 2,
                                                  0))]
        return tuple(out)

    @staticmethod
    def from_dataframe(df, X=None, y=None, w=None,
                       ids=None) -> 'NumpyDataset':
        """A dataset of a DataFrame's columns (the caller's; the port
        imports no pandas): ``X`` (or ``X1`` ...), ``y`` (or ``y1`` ...),
        ``w`` (or ``w1`` ...) and ``ids``, as the JAX package's
        ``to_dataframe`` writes them, or the columns ``X``, ``y``, ``w``
        and ``ids`` name."""
        def columns(given, key, numbered):
            if given is not None:
                return given if isinstance(given, list) else [given]
            return [c for c in df.columns if c == key or (
                str(c).startswith(key) and (not numbered
                                            or str(c)[1:].isdigit()))]
        x_cols = columns(X, 'X', False)
        y_cols, w_cols = columns(y, 'y', True), columns(w, 'w', True)
        id_col = ids if ids is not None else \
            ('ids' if 'ids' in df.columns else None)
        X_arr = df[x_cols].to_numpy()
        if len(x_cols) == 1:
            X_arr = X_arr[:, 0]
            if X_arr.dtype == object:
                try:
                    X_arr = np.stack(X_arr)
                except ValueError:
                    pass
        return NumpyDataset(X_arr,
                            df[y_cols].to_numpy() if y_cols else None,
                            df[w_cols].to_numpy() if w_cols else None,
                            df[id_col].to_numpy() if id_col else None)

    def make_pytorch_dataset(self, epochs: int = 1,
                             deterministic: bool = False,
                             batch_size: Optional[int] = None):
        """A ``torch.utils.data.IterableDataset`` of the samples (or
        batches), split among a loader's workers and a process group's
        ranks (:func:`make_pytorch_dataset`)."""
        from deepchem_tpu_torch.data.pytorch_datasets import \
            make_pytorch_dataset
        return make_pytorch_dataset(self, epochs, deterministic, batch_size)

    def __repr__(self) -> str:
        x_shape, y_shape, w_shape, _ = self.get_shape()
        return (f'<{type(self).__name__} X.shape: {x_shape}, y.shape: '
                f'{y_shape}, w.shape: {w_shape}, task_names: '
                f'{list(self.get_task_names())}>')

    def __iter__(self):
        return self.itersamples()


class NumpyDataset(Dataset):
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

    def get_shape(self):
        return self._X.shape, self._y.shape, self._w.shape, self._ids.shape

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
                    deterministic: bool = False, pad_batches: bool = False,
                    rng: Optional[np.random.RandomState] = None
                    ) -> Iterator[Batch]:
        """Batches in dataset order, or (not ``deterministic``) in the
        order of a permutation an epoch from ``rng`` (default numpy's
        global stream, as the JAX package)."""
        n = len(self)
        if batch_size is None:
            batch_size = n
        rng = np.random if rng is None else rng
        for _ in range(epochs):
            perm = np.arange(n) if deterministic else rng.permutation(n)
            for start in range(0, n, batch_size):
                idx = perm[start:start + batch_size]
                X_b, y_b = self._X[idx], self._y[idx]
                w_b, ids_b = self._w[idx], self._ids[idx]
                if pad_batches and len(idx) < batch_size:
                    X_b, y_b, w_b, ids_b = pad_batch(batch_size, X_b, y_b,
                                                     w_b, ids_b)
                yield X_b, y_b, w_b, ids_b

    def itersamples(self) -> Iterator[Batch]:
        for i in range(len(self)):
            yield self._X[i], self._y[i], self._w[i], self._ids[i]

    def transform(self, transformer, **kwargs) -> 'NumpyDataset':
        """A new dataset of ``transformer.transform_array``'s arrays."""
        return NumpyDataset(*transformer.transform_array(
            self._X, self._y, self._w, self._ids))

    def select(self, indices, select_dir: Optional[str] = None
               ) -> 'NumpyDataset':
        """The samples at ``indices``, in their order."""
        indices = np.asarray(indices, dtype=np.int64)
        return NumpyDataset(self._X[indices], self._y[indices],
                            self._w[indices], self._ids[indices])

    @staticmethod
    def from_DiskDataset(ds: 'DiskDataset') -> 'NumpyDataset':
        return NumpyDataset(ds.X, ds.y, ds.w, ds.ids)

    @staticmethod
    def merge(datasets: Sequence[Dataset]) -> 'NumpyDataset':
        """The samples of ``datasets``, one after another."""
        return NumpyDataset(*(np.concatenate([getattr(ds, k)
                                              for ds in datasets])
                              for k in ('X', 'y', 'w', 'ids')))

    def to_json(self, fname: str) -> None:
        """Write X, y, w (as lists) and the ids (as strings) to
        ``fname``."""
        d = {'X': np.asarray(self._X).tolist(),
             'y': np.asarray(self._y).tolist(),
             'w': np.asarray(self._w).tolist(),
             'ids': np.asarray(self._ids, dtype=str).tolist()}
        with open(fname, 'w') as f:
            json.dump(d, f)

    @staticmethod
    def from_json(fname: str) -> 'NumpyDataset':
        with open(fname) as f:
            d = json.load(f)
        return NumpyDataset(np.array(d['X']), np.array(d['y']),
                            np.array(d['w']), np.array(d['ids']))


def _write_array(path_base: str, key: str, arr) -> Optional[str]:
    """Write one array of a shard; returns its kind ('npy', 'pkl') or None
    for no array."""
    if arr is None:
        return None
    arr = np.asarray(arr)
    if arr.dtype.kind in 'biufc':
        np.save(f'{path_base}.{key}.npy', arr, allow_pickle=False)
        return 'npy'
    with open(f'{path_base}.{key}.pkl', 'wb') as f:
        pickle.dump(arr, f, protocol=pickle.HIGHEST_PROTOCOL)
    return 'pkl'


def _read_array(path_base: str, key: str, kind: Optional[str]):
    if kind is None:
        return None
    if kind == 'npy':
        return np.load(f'{path_base}.{key}.npy', allow_pickle=False)
    with open(f'{path_base}.{key}.pkl', 'rb') as f:
        return pickle.load(f)


class DiskDataset(Dataset):
    """A dataset kept on disk in shards (layout in the module's
    docstring), read through a byte-budgeted LRU cache of shards.

    ``memory_cache_size`` is the cache's budget in bytes (100 MiB; an
    object array counts 64 bytes an entry).  ``iterbatches`` reads the
    next shard in a thread while the caller takes batches of the one
    before, and stops that thread when the caller abandons it.
    """

    MANIFEST = 'manifest.json'

    def __init__(self, data_dir: str) -> None:
        self.data_dir = data_dir
        path = os.path.join(data_dir, self.MANIFEST)
        if not os.path.exists(path):
            raise ValueError(f'no dataset manifest at {path}')
        with open(path) as f:
            self._manifest = json.load(f)
        if self._manifest.get('format') != SHARD_FORMAT:
            raise ValueError(
                f'{data_dir} holds shards in another format than '
                f'{SHARD_FORMAT} (the JAX package writes joblib shards); '
                'the port reads only its own: remove the folder or load '
                'into another')
        self._cache: Dict[int, Batch] = {}
        self._cache_order: List[int] = []
        self._cache_bytes: Dict[int, int] = {}
        self._memory_cache_size = 100 * 1024 * 1024
        self._cache_used = 0
        self._lock = threading.Lock()

    # -- the memory cache ----------------------------------------------------
    @property
    def memory_cache_size(self) -> int:
        """Byte budget of the shard cache."""
        return self._memory_cache_size

    @memory_cache_size.setter
    def memory_cache_size(self, size: int) -> None:
        self._memory_cache_size = size
        with self._lock:
            self._evict_locked()

    @staticmethod
    def _shard_nbytes(shard: Batch) -> int:
        total = 0
        for arr in shard:
            if arr is not None:
                arr = np.asarray(arr)
                total += arr.size * 64 if arr.dtype == object \
                    else arr.nbytes
        return total

    def _evict_locked(self) -> None:
        while self._cache_used > self._memory_cache_size \
                and self._cache_order:
            old = self._cache_order.pop(0)
            self._cache.pop(old)
            self._cache_used -= self._cache_bytes.pop(old)

    def _drop_cache_locked(self) -> None:
        self._cache.clear()
        self._cache_order.clear()
        self._cache_bytes.clear()
        self._cache_used = 0

    # -- construction --------------------------------------------------------
    @staticmethod
    def create_dataset(shard_generator: Iterable,
                       data_dir: Optional[str] = None,
                       tasks: Optional[Sequence] = None) -> 'DiskDataset':
        """A dataset of the ``(X, y, w, ids)`` shards ``shard_generator``
        yields, written to ``data_dir`` (default a new temporary
        folder)."""
        if data_dir is None:
            data_dir = tempfile.mkdtemp(prefix='dctorch-')
        os.makedirs(data_dir, exist_ok=True)
        shards = [DiskDataset.write_data_to_disk(data_dir, f'shard-{i}',
                                                 X, y, w, ids)
                  for i, (X, y, w, ids) in enumerate(shard_generator)]
        _write_manifest(data_dir, {
            'format': SHARD_FORMAT,
            'tasks': list(tasks) if tasks is not None else [],
            'shards': shards})
        return DiskDataset(data_dir)

    @staticmethod
    def from_numpy(X, y=None, w=None, ids=None,
                   tasks: Optional[Sequence] = None,
                   data_dir: Optional[str] = None) -> 'DiskDataset':
        """One shard of ``NumpyDataset(X, y, w, ids)``'s arrays; its task
        names by default."""
        ds = NumpyDataset(X, y, w, ids)
        if tasks is None:
            tasks = ds.get_task_names()
        return DiskDataset.create_dataset([(ds.X, ds.y, ds.w, ds.ids)],
                                          data_dir=data_dir, tasks=tasks)

    @staticmethod
    def write_data_to_disk(data_dir: str, basename: str, X, y=None, w=None,
                           ids=None) -> dict:
        """Write one shard's files under ``basename``; returns its manifest
        row.  With y and no w, w is ones; with no ids, ``0 .. n - 1``."""
        y = None if y is None else np.asarray(y)
        w = None if w is None else np.asarray(w)
        if y is not None and w is None:
            w = np.ones_like(y, dtype=np.float32)
        if ids is None:
            ids = np.arange(len(X))
        X = X if isinstance(X, np.ndarray) else np.asarray(X)
        base = os.path.join(data_dir, basename)
        arrays = {k: _write_array(base, k, a) for k, a in (
            ('X', X), ('y', y), ('w', w),
            ('ids', np.asarray(ids, dtype=object)))}
        return {'rows': len(X), 'file': basename, 'arrays': arrays}

    @staticmethod
    def write_shard(data_dir: str, i: int, X, y, w, ids) -> int:
        return DiskDataset.write_data_to_disk(data_dir, f'shard-{i}', X, y,
                                              w, ids)['rows']

    def save_to_disk(self) -> None:
        """Write the manifest."""
        _write_manifest(self.data_dir, self._manifest)

    # -- shards --------------------------------------------------------------
    @property
    def tasks(self) -> np.ndarray:
        return np.asarray(self._manifest['tasks'])

    def get_task_names(self) -> np.ndarray:
        return self.tasks

    def get_number_shards(self) -> int:
        return len(self._manifest['shards'])

    def get_shard_size(self) -> int:
        shards = self._manifest['shards']
        return shards[0]['rows'] if shards else 0

    def get_shard(self, i: int) -> Batch:
        """Shard ``i``'s (X, y, w, ids), through the cache."""
        with self._lock:
            if i in self._cache:
                self._cache_order.remove(i)
                self._cache_order.append(i)
                return self._cache[i]
            entry = self._manifest['shards'][i]
        base = os.path.join(self.data_dir, entry['file'])
        shard = tuple(_read_array(base, k, entry['arrays'][k])
                      for k in ('X', 'y', 'w', 'ids'))
        with self._lock:
            if i not in self._cache:
                nbytes = self._shard_nbytes(shard)
                self._cache[i] = shard
                self._cache_order.append(i)
                self._cache_bytes[i] = nbytes
                self._cache_used += nbytes
                self._evict_locked()
        return shard

    def set_shard(self, i: int, X, y, w, ids) -> None:
        """Write new arrays for shard ``i`` in place."""
        self._version += 1
        entry = self._manifest['shards'][i]
        for key, kind in entry['arrays'].items():
            if kind is not None:
                os.remove(os.path.join(self.data_dir,
                                       f"{entry['file']}.{key}.{kind}"))
        row = DiskDataset.write_data_to_disk(self.data_dir, entry['file'],
                                             X, y, w, ids)
        with self._lock:
            if i in self._cache:
                self._cache.pop(i)
                self._cache_order.remove(i)
                self._cache_used -= self._cache_bytes.pop(i)
            self._manifest['shards'][i] = row
        self.save_to_disk()

    def add_shard(self, X, y=None, w=None, ids=None) -> None:
        """Append a shard."""
        self._version += 1
        basename = f'shard-{self.get_number_shards()}-added'
        self._manifest['shards'].append(DiskDataset.write_data_to_disk(
            self.data_dir, basename, X, y, w, ids))
        self.save_to_disk()

    def itershards(self) -> Iterator[Batch]:
        for i in range(self.get_number_shards()):
            yield self.get_shard(i)

    def get_shard_ids(self, i: int) -> np.ndarray:
        return self.get_shard(i)[3]

    def get_shard_y(self, i: int) -> np.ndarray:
        return self.get_shard(i)[1]

    def get_shard_w(self, i: int) -> np.ndarray:
        return self.get_shard(i)[2]

    def get_data_shape(self) -> Tuple:
        """The shape of one sample's features."""
        if not self.get_number_shards():
            return tuple()
        return np.asarray(self.get_shard(0)[0]).shape[1:]

    def load_metadata(self):
        """``(tasks, table)``: a row a shard, columns ``file`` and
        ``rows`` (a :class:`Table`, where the JAX package gives a
        DataFrame)."""
        shards = self._manifest['shards']
        files = np.empty(len(shards), dtype=object)
        files[:] = [e['file'] for e in shards]
        return list(self._manifest['tasks']), Table({
            'file': files,
            'rows': np.array([e['rows'] for e in shards], dtype=np.int64)})

    def _per_shard_labels(self, stat) -> np.ndarray:
        out = np.empty(self.get_number_shards(), dtype=object)
        out[:] = [stat(np.asarray(y, dtype=np.float64), axis=0)
                  if y is not None else None
                  for _, y, _, _ in self.itershards()]
        return out

    def get_label_means(self) -> np.ndarray:
        """Each shard's label means (the values of the JAX package's
        ``y_means`` Series)."""
        return self._per_shard_labels(np.mean)

    def get_label_stds(self) -> np.ndarray:
        """Each shard's label standard deviations (the values of the JAX
        package's ``y_stds`` Series)."""
        return self._per_shard_labels(np.std)

    # -- the Dataset API -----------------------------------------------------
    def __len__(self) -> int:
        return sum(s['rows'] for s in self._manifest['shards'])

    def get_shape(self):
        n = len(self)
        x_shape = y_shape = w_shape = None
        if self.get_number_shards():
            X, y, w, _ = self.get_shard(0)
            x_shape = (n,) + np.asarray(X).shape[1:]
            y_shape = (n,) + (np.asarray(y).shape[1:] if y is not None
                              else ())
            w_shape = (n,) + (np.asarray(w).shape[1:] if w is not None
                              else ())
        return x_shape, y_shape, w_shape, (n,)

    def _concat(self, k: int):
        parts = [s[k] for s in self.itershards() if s[k] is not None]
        if not parts:
            return None
        if any(np.asarray(p).dtype == object for p in parts):
            return np.concatenate([np.asarray(p, dtype=object)
                                   for p in parts])
        return np.concatenate(parts)

    @property
    def X(self) -> np.ndarray:
        return self._concat(0)

    @property
    def y(self) -> np.ndarray:
        return self._concat(1)

    @property
    def w(self) -> np.ndarray:
        return self._concat(2)

    @property
    def ids(self) -> np.ndarray:
        return self._concat(3)

    def iterbatches(self, batch_size: Optional[int] = None, epochs: int = 1,
                    deterministic: bool = False, pad_batches: bool = False,
                    rng: Optional[np.random.RandomState] = None,
                    shard_rng: Optional[random.Random] = None
                    ) -> Iterator[Batch]:
        """Batches of ``batch_size`` across shard boundaries (the rows left
        at a shard's end go first into the next batch), the last perhaps
        short (padded with ``pad_batches``).  Not ``deterministic``: an
        epoch takes the shards in an order shuffled by ``shard_rng``
        (default Python's global ``random``) and each shard's rows in a
        permutation from ``rng`` (default numpy's global stream), as the
        JAX package does.  A thread reads the next shard ahead."""
        n_shards = self.get_number_shards()
        shuffle = (shard_rng or random).shuffle
        rng = np.random if rng is None else rng
        for _ in range(epochs):
            order = list(range(n_shards))
            if not deterministic:
                shuffle(order)
            yield from self._epoch_batches(order, batch_size, deterministic,
                                           pad_batches, rng)

    def _epoch_batches(self, order, batch_size, deterministic, pad_batches,
                       rng) -> Iterator[Batch]:
        q: queue_mod.Queue = queue_mod.Queue(maxsize=2)
        stop = threading.Event()

        def put(item) -> bool:
            # gives up once the consumer has gone, so an abandoned
            # iteration leaves no thread behind holding shards
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def producer():
            try:
                for si in order:
                    if not put(self.get_shard(si)):
                        return
                put(None)
            except BaseException as e:          # handed to the consumer
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            carry = None        # the rows a shard left for the next batch
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                X, y, w, ids = item
                X = X if isinstance(X, np.ndarray) else np.asarray(X)
                perm = np.arange(len(X)) if deterministic \
                    else rng.permutation(len(X))
                parts = [None if a is None else a[perm]
                         for a in (X, y, w, ids)]
                if carry is not None:
                    parts = [None if a is None else np.concatenate([c, a])
                             for c, a in zip(carry, parts)]
                    carry = None
                X = parts[0]
                bs = batch_size if batch_size is not None else len(X)
                pos = 0
                while len(X) - pos >= bs:
                    yield tuple(None if a is None else a[pos:pos + bs]
                                for a in parts)
                    pos += bs
                if pos < len(X):
                    carry = [None if a is None else a[pos:] for a in parts]
            if carry is not None:
                if pad_batches and batch_size is not None:
                    carry = pad_batch(batch_size, *carry)
                yield tuple(carry)
        finally:
            stop.set()
            t.join()

    def itersamples(self) -> Iterator[Batch]:
        for X, y, w, ids in self.itershards():
            for i in range(len(X)):
                yield (X[i], y[i] if y is not None else None,
                       w[i] if w is not None else None, ids[i])

    def transform(self, transformer, parallel: bool = False,
                  out_dir: Optional[str] = None, **kwargs) -> 'DiskDataset':
        """Each shard through ``transformer.transform_array``, into a new
        dataset in ``out_dir`` (default a new temporary folder)."""
        def gen():
            for X, y, w, ids in self.itershards():
                yield transformer.transform_array(X, y, w, ids)
        return DiskDataset.create_dataset(gen(), data_dir=out_dir,
                                          tasks=self.tasks)

    def select(self, indices, select_dir: Optional[str] = None,
               select_shard_size: Optional[int] = None) -> 'DiskDataset':
        """A new dataset of the samples at ``indices``, in their order, in
        shards of ``select_shard_size`` (default this dataset's first
        shard's size)."""
        indices = np.asarray(indices, dtype=np.int64)
        offsets = np.cumsum([0] + [s['rows']
                                   for s in self._manifest['shards']])
        shard_of = np.searchsorted(offsets, indices, side='right') - 1
        bs = select_shard_size or max(1, self.get_shard_size())

        def gen():
            for start in range(0, len(indices), bs):
                chunk = indices[start:start + bs]
                chunk_shards = shard_of[start:start + bs]
                shards = np.unique(chunk_shards)
                pieces = []
                for si in shards:
                    local = chunk[chunk_shards == si] - offsets[si]
                    pieces.append([None if a is None else np.asarray(a)[local]
                                   for a in self.get_shard(int(si))])
                # back to the caller's order within the chunk
                taken = np.concatenate([chunk[chunk_shards == si]
                                        for si in shards])
                pos = {v: i for i, v in enumerate(taken)}
                perm = np.array([pos[v] for v in chunk], dtype=np.int64)
                yield tuple(
                    None if pieces[0][k] is None else
                    np.concatenate([p[k] for p in pieces])[perm]
                    for k in range(4))
        return DiskDataset.create_dataset(gen(), data_dir=select_dir,
                                          tasks=self.tasks)

    @staticmethod
    def merge(datasets: Sequence[Dataset],
              merge_dir: Optional[str] = None) -> 'DiskDataset':
        """One dataset of ``datasets``' samples: each DiskDataset's shards,
        each other dataset as one shard; the first's tasks."""
        datasets = list(datasets)
        if not datasets:
            raise ValueError('need at least one dataset')

        def gen():
            for ds in datasets:
                if isinstance(ds, DiskDataset):
                    yield from ds.itershards()
                else:
                    yield ds.X, ds.y, ds.w, ds.ids
        return DiskDataset.create_dataset(
            gen(), data_dir=merge_dir,
            tasks=getattr(datasets[0], 'tasks', None))

    def reshard(self, shard_size: int) -> None:
        """Rewrite the dataset in place in shards of ``shard_size``."""
        tmp = tempfile.mkdtemp(prefix='dctorch-reshard-')

        def gen():
            buf: List[list] = []
            count = 0
            for shard in self.itershards():
                buf.append(list(shard))
                count += len(shard[0])
                while count >= shard_size:
                    cat = [None if buf[0][k] is None else
                           np.concatenate([np.asarray(b[k]) for b in buf])
                           for k in range(4)]
                    yield tuple(None if a is None else a[:shard_size]
                                for a in cat)
                    buf = [[None if a is None else a[shard_size:]
                            for a in cat]]
                    count -= shard_size
            if count > 0:
                yield tuple(None if buf[0][k] is None else
                            np.concatenate([np.asarray(b[k]) for b in buf])
                            for k in range(4))
        new = DiskDataset.create_dataset(gen(), data_dir=tmp,
                                         tasks=self.tasks)
        for f in os.listdir(self.data_dir):
            if f.startswith('shard-') or f == self.MANIFEST:
                os.remove(os.path.join(self.data_dir, f))
        for f in os.listdir(tmp):
            shutil.move(os.path.join(tmp, f), os.path.join(self.data_dir, f))
        shutil.rmtree(tmp, ignore_errors=True)
        self._version += 1
        with self._lock:
            self._manifest = new._manifest
            self._drop_cache_locked()

    def shuffle_shards(self, rng: Optional[random.Random] = None) -> None:
        """Shuffle the order of the shards in place (``rng``, default
        Python's global ``random``)."""
        self._version += 1
        entries = list(self._manifest['shards'])
        (rng or random).shuffle(entries)
        with self._lock:
            self._manifest['shards'] = entries
            self._drop_cache_locked()
        self.save_to_disk()

    def shuffle_each_shard(self, shard_basenames: Optional[List] = None,
                           rng: Optional[np.random.RandomState] = None
                           ) -> None:
        """Permute the rows within each shard in place (``rng``, default
        numpy's global stream)."""
        rng = np.random if rng is None else rng
        for i in range(self.get_number_shards()):
            X, y, w, ids = self.get_shard(i)
            perm = rng.permutation(len(X))
            self.set_shard(i, np.asarray(X)[perm],
                           y[perm] if y is not None else None,
                           w[perm] if w is not None else None, ids[perm])

    def complete_shuffle(self, data_dir: Optional[str] = None,
                         rng: Optional[np.random.RandomState] = None
                         ) -> 'DiskDataset':
        """A new dataset of the samples in one permutation of all of them
        (``rng``, default numpy's global stream)."""
        rng = np.random if rng is None else rng
        return self.select(rng.permutation(len(self)), select_dir=data_dir)

    def sparse_shuffle(self, rng: Optional[np.random.RandomState] = None
                       ) -> None:
        """The rows shuffled within each shard, in place (as the JAX
        package: :meth:`shuffle_each_shard`)."""
        self.shuffle_each_shard(rng=rng)

    def move(self, new_dir: str, delete_if_exists: bool = True) -> None:
        """Put the dataset at ``new_dir`` (replacing what is there):
        renamed from a temporary folder, else copied."""
        if os.path.abspath(new_dir) == os.path.abspath(self.data_dir):
            return
        if not delete_if_exists and os.path.isdir(new_dir):
            raise ValueError(f'{new_dir} exists')
        move_or_copy(self.data_dir, new_dir)
        self.data_dir = new_dir

    def copy(self, new_dir: str) -> 'DiskDataset':
        """A copy of the dataset at ``new_dir`` (replacing what is
        there)."""
        if os.path.isdir(new_dir):
            shutil.rmtree(new_dir)
        shutil.copytree(self.data_dir, new_dir)
        return DiskDataset(new_dir)

    def subset(self, shard_nums: Sequence[int],
               subset_dir: Optional[str] = None) -> 'DiskDataset':
        """A new dataset of the shards ``shard_nums``."""
        return DiskDataset.create_dataset(
            (self.get_shard(i) for i in shard_nums), data_dir=subset_dir,
            tasks=self.get_task_names())


def _write_manifest(data_dir: str, manifest: dict) -> None:
    # default=str: task names may be numpy scalars, written as the JAX
    # package writes them
    with open(os.path.join(data_dir, DiskDataset.MANIFEST), 'w') as f:
        json.dump(manifest, f, default=str)


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

    def select(self, indices, select_dir: Optional[str] = None
               ) -> 'ImageDataset':
        indices = np.asarray(indices)
        return ImageDataset(self._X[indices], self._y[indices],
                            self._w[indices], self._ids[indices])


class Databag:
    """Several datasets zipped for a model of several inputs: its batches
    are dicts of each dataset's X, in dataset order."""

    def __init__(self, datasets: Optional[dict] = None) -> None:
        self.datasets = dict(datasets) if datasets else {}

    def add_dataset(self, key, dataset: Dataset) -> None:
        self.datasets[key] = dataset

    def iterbatches(self, **kwargs) -> Iterator[dict]:
        kwargs['deterministic'] = True
        keys = list(self.datasets)
        for batches in zip(*(self.datasets[k].iterbatches(**kwargs)
                             for k in keys)):
            yield {k: b[0] for k, b in zip(keys, batches)}
