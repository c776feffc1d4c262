"""Episode and support sampling for low-data learning.

Counterparts of ``deepchem_tpu/data/supports.py``: ``remove_dead_examples``,
``get_task_dataset``, ``get_single_task_test``, ``get_task_support``,
``SupportGenerator`` and ``EpisodeGenerator``.  The JAX package draws from
numpy's global stream; here every draw comes from an explicit
``np.random.RandomState`` (``rng``; a fresh ``RandomState(0)`` where none
is given), in the same order, so a stream seeded as the JAX side's global
one gives the same episodes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from deepchem_tpu_torch.data.datasets import NumpyDataset


def _rng(rng: Optional[np.random.RandomState]) -> np.random.RandomState:
    return np.random.RandomState(0) if rng is None else rng


def remove_dead_examples(dataset: NumpyDataset) -> NumpyDataset:
    """The datapoints with a non-zero weight for some task."""
    w = np.asarray(dataset.w)
    alive = np.nonzero(np.any(w != 0, axis=tuple(range(1, w.ndim))))[0]
    return NumpyDataset(dataset.X[alive], dataset.y[alive], w[alive],
                        dataset.ids[alive])


def get_task_dataset(dataset: NumpyDataset, task: int) -> NumpyDataset:
    """One task's labelled rows (weight not 0): its labels and weights."""
    w = np.asarray(dataset.w)
    keep = np.nonzero(w[:, task] != 0)[0]
    return NumpyDataset(dataset.X[keep], dataset.y[keep, task],
                        w[keep, task], dataset.ids[keep])


def get_single_task_test(dataset: NumpyDataset, batch_size: int, task: int,
                         replace: bool = True,
                         rng: Optional[np.random.RandomState] = None
                         ) -> NumpyDataset:
    """A test batch of ``min(batch_size, n)`` of one task's rows, drawn
    with replacement by default."""
    task_ds = get_task_dataset(dataset, task)
    n = len(task_ds)
    idx = _rng(rng).choice(n, size=min(batch_size, n), replace=replace)
    return NumpyDataset(task_ds.X[idx], task_ds.y[idx], task_ds.w[idx],
                        task_ds.ids[idx])


def get_task_support(dataset: NumpyDataset, n_episodes: int, n_pos: int,
                     n_neg: int, task: int,
                     rng: Optional[np.random.RandomState] = None):
    """``n_episodes`` support sets of one task: ``n_pos`` positives then
    ``n_neg`` negatives each (with replacement only where a class has
    fewer rows), weights 1."""
    rng = _rng(rng)
    task_ds = get_task_dataset(dataset, task)
    y = np.asarray(task_ds.y).reshape(len(task_ds))
    pos_idx = np.nonzero(y != 0)[0]
    neg_idx = np.nonzero(y == 0)[0]
    supports = []
    for _ in range(n_episodes):
        pos = rng.choice(pos_idx, size=min(n_pos, len(pos_idx)),
                         replace=len(pos_idx) < n_pos)
        neg = rng.choice(neg_idx, size=min(n_neg, len(neg_idx)),
                         replace=len(neg_idx) < n_neg)
        idx = np.concatenate([pos, neg])
        supports.append(NumpyDataset(task_ds.X[idx], y[idx],
                                     np.ones(len(idx)), task_ds.ids[idx]))
    return supports


class SupportGenerator:
    """``(task, support)`` pairs, ``n_trials`` of them, each task drawn at
    random."""

    def __init__(self, dataset: NumpyDataset, n_pos: int, n_neg: int,
                 n_trials: int, rng: Optional[np.random.RandomState] = None):
        self.dataset = dataset
        self.n_pos, self.n_neg, self.n_trials = n_pos, n_neg, n_trials
        self.n_tasks = dataset.y.shape[1] if dataset.y.ndim > 1 else 1
        self.rng = _rng(rng)
        self._trial = 0

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[int, NumpyDataset]:
        if self._trial >= self.n_trials:
            raise StopIteration
        self._trial += 1
        task = self.rng.randint(self.n_tasks)
        support = get_task_support(self.dataset, 1, self.n_pos, self.n_neg,
                                   task, self.rng)[0]
        return task, support

    def next(self):
        """DeepChem's Python 2 name of ``__next__``."""
        return self.__next__()


class EpisodeGenerator:
    """``(task, support, batch)`` episodes: the tasks in a random order,
    repeated ``n_episodes_per_task`` times, each with a support set and a
    test batch of ``n_test``."""

    def __init__(self, dataset: NumpyDataset, n_pos: int, n_neg: int,
                 n_test: int, n_episodes_per_task: int,
                 rng: Optional[np.random.RandomState] = None):
        self.dataset = dataset
        self.n_pos, self.n_neg, self.n_test = n_pos, n_neg, n_test
        self.n_tasks = dataset.y.shape[1] if dataset.y.ndim > 1 else 1
        self.n_episodes_per_task = n_episodes_per_task
        self.rng = _rng(rng)
        self.task_order = list(self.rng.permutation(self.n_tasks)) \
            * n_episodes_per_task
        self._pos = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._pos >= len(self.task_order):
            raise StopIteration
        task = int(self.task_order[self._pos])
        self._pos += 1
        support = get_task_support(self.dataset, 1, self.n_pos, self.n_neg,
                                   task, self.rng)[0]
        batch = get_single_task_test(self.dataset, self.n_test, task,
                                     rng=self.rng)
        return task, support, batch

    def next(self):
        """DeepChem's Python 2 name of ``__next__``."""
        return self.__next__()
