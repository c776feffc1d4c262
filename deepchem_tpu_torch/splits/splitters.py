"""Dataset splitters: index selection in numpy, then ``Dataset.select``.

The port's own copy of ``deepchem_tpu/splits/splitters.py``; every
splitter gives the JAX package's indices.  Where the JAX package seeds
numpy's global stream (``np.random.seed(seed)``), the port draws from
``np.random.RandomState(seed)``: the same permutations, and the global
state left alone.  With no seed it draws from a fresh ``RandomState()``.
The scaffold splitter fills train with the largest scaffold sets first,
ties broken by their first index.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepchem_tpu_torch.data import Dataset, DiskDataset, NumpyDataset

logger = logging.getLogger(__name__)


class Splitter:
    """Splits a dataset's indices into train, valid and test."""

    def split(self, dataset: Dataset, frac_train: float = 0.8,
              frac_valid: float = 0.1, frac_test: float = 0.1,
              seed: Optional[int] = None, log_every_n: Optional[int] = None
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        raise NotImplementedError

    def train_valid_test_split(self, dataset: Dataset,
                               train_dir: Optional[str] = None,
                               valid_dir: Optional[str] = None,
                               test_dir: Optional[str] = None,
                               frac_train: float = 0.8,
                               frac_valid: float = 0.1,
                               frac_test: float = 0.1,
                               seed: Optional[int] = None,
                               log_every_n: int = 1000,
                               **kwargs) -> Tuple[Dataset, Dataset, Dataset]:
        """The three splits, each selected into its folder where given."""
        train_idx, valid_idx, test_idx = self.split(
            dataset, frac_train=frac_train, frac_valid=frac_valid,
            frac_test=frac_test, seed=seed, log_every_n=log_every_n)
        return (dataset.select(train_idx, train_dir),
                dataset.select(valid_idx, valid_dir),
                dataset.select(test_idx, test_dir))

    def train_test_split(self, dataset: Dataset,
                         train_dir: Optional[str] = None,
                         test_dir: Optional[str] = None,
                         frac_train: float = 0.8,
                         seed: Optional[int] = None,
                         **kwargs) -> Tuple[Dataset, Dataset]:
        train, _, test = self.train_valid_test_split(
            dataset, train_dir=train_dir, test_dir=test_dir,
            frac_train=frac_train, frac_valid=0.0,
            frac_test=1 - frac_train, seed=seed)
        return train, test

    def k_fold_split(self, dataset: Dataset, k: int,
                     directories: Optional[Sequence[str]] = None,
                     seed: Optional[int] = None,
                     **kwargs) -> List[Tuple[Dataset, Dataset]]:
        """``k`` pairs (train, cv): fold ``i`` is split off what the folds
        before left, at ``1 / (k - i)`` of it; train is the other folds
        merged."""
        if directories is None:
            directories = [None] * 2 * k
        cv_datasets: List[Dataset] = []
        rem = dataset
        for fold in range(k):
            frac_fold = 1.0 / (k - fold)
            fold_inds, rem_inds, _ = self.split(
                rem, frac_train=frac_fold, frac_valid=1 - frac_fold,
                frac_test=0, seed=seed)
            cv_datasets.append(rem.select(fold_inds, directories[2 * fold]))
            rem = rem.select(rem_inds)
        out = []
        for fold in range(k):
            parts = [cv_datasets[i] for i in range(k) if i != fold]
            train = DiskDataset.merge(parts,
                                      merge_dir=directories[2 * fold + 1]) \
                if isinstance(parts[0], DiskDataset) \
                else NumpyDataset.merge(parts)
            out.append((train, cv_datasets[fold]))
        return out

    def __repr__(self) -> str:
        return type(self).__name__


def _validate_fracs(frac_train, frac_valid, frac_test) -> None:
    if abs(frac_train + frac_valid + frac_test - 1.0) >= 1.5e-5:
        raise ValueError(f'fractions {frac_train}, {frac_valid}, '
                         f'{frac_test} do not sum to 1')


def _cuts(n: int, frac_train: float, frac_valid: float) -> Tuple[int, int]:
    return int(frac_train * n), int((frac_train + frac_valid) * n)


class RandomSplitter(Splitter):
    """A random permutation cut at the fractions."""

    def split(self, dataset, frac_train=0.8, frac_valid=0.1, frac_test=0.1,
              seed=None, log_every_n=None):
        _validate_fracs(frac_train, frac_valid, frac_test)
        perm = np.random.RandomState(seed).permutation(len(dataset))
        a, b = _cuts(len(dataset), frac_train, frac_valid)
        return perm[:a], perm[a:b], perm[b:]


class IndexSplitter(Splitter):
    """The first, middle and last blocks of the dataset's order."""

    def split(self, dataset, frac_train=0.8, frac_valid=0.1, frac_test=0.1,
              seed=None, log_every_n=None):
        _validate_fracs(frac_train, frac_valid, frac_test)
        idx = np.arange(len(dataset))
        a, b = _cuts(len(dataset), frac_train, frac_valid)
        return idx[:a], idx[a:b], idx[b:]


class SpecifiedSplitter(Splitter):
    """Valid and test are the given indices (sorted); train the rest."""

    def __init__(self, valid_indices: Optional[Sequence[int]] = None,
                 test_indices: Optional[Sequence[int]] = None):
        self.valid_indices = [] if valid_indices is None \
            else [int(i) for i in valid_indices]
        self.test_indices = [] if test_indices is None \
            else [int(i) for i in test_indices]

    def split(self, dataset, frac_train=0.8, frac_valid=0.1, frac_test=0.1,
              seed=None, log_every_n=None):
        valid, test = set(self.valid_indices), set(self.test_indices)
        train = [i for i in range(len(dataset))
                 if i not in valid and i not in test]
        return (np.array(train), np.array(sorted(valid), dtype=np.int64),
                np.array(sorted(test), dtype=np.int64))


class RandomGroupSplitter(Splitter):
    """Whole groups (``groups``, one label a sample) in a random order:
    each goes to train until train holds ``frac_train`` of the samples,
    then to valid, then to test."""

    def __init__(self, groups: Sequence[Any]):
        self.groups = list(groups)

    def split(self, dataset, frac_train=0.8, frac_valid=0.1, frac_test=0.1,
              seed=None, log_every_n=None):
        _validate_fracs(frac_train, frac_valid, frac_test)
        group_dict: Dict[Any, List[int]] = {}
        for i, g in enumerate(self.groups):
            group_dict.setdefault(g, []).append(i)
        group_ids = list(group_dict)
        perm = np.random.RandomState(seed).permutation(len(group_ids))
        n = len(dataset)
        train_cut, valid_cut = frac_train * n, (frac_train + frac_valid) * n
        train, valid, test = [], [], []
        count = 0
        for gi in perm:
            members = group_dict[group_ids[gi]]
            if count < train_cut:
                train += members
            elif count < valid_cut:
                valid += members
            else:
                test += members
            count += len(members)
        return np.array(train), np.array(valid), np.array(test)


class RandomStratifiedSplitter(Splitter):
    """Each task's actives (nonzero label, nonzero weight), shuffled and
    cut at the fractions, then the rest likewise."""

    def split(self, dataset, frac_train=0.8, frac_valid=0.1, frac_test=0.1,
              seed=None, log_every_n=None):
        _validate_fracs(frac_train, frac_valid, frac_test)
        rng = np.random.RandomState(seed)
        y, w = dataset.y, dataset.w
        if y.ndim == 1:
            y, w = y[:, None], w[:, None]
        n, n_tasks = y.shape
        remaining = set(range(n))
        train, valid, test = [], [], []

        def deal(items):
            rng.shuffle(items)
            a, b = _cuts(len(items), frac_train, frac_valid)
            train.extend(items[:a])
            valid.extend(items[a:b])
            test.extend(items[b:])
        for t in range(n_tasks):
            actives = [i for i in range(n)
                       if i in remaining and w[i, t] != 0 and y[i, t] != 0]
            deal(actives)
            remaining -= set(actives)
        deal(list(remaining))
        return np.array(train), np.array(valid), np.array(test)


class SingletaskStratifiedSplitter(Splitter):
    """Samples sorted by one task's label, in blocks of 10: each block
    shuffled and dealt by the fractions (rounded to tenths); what is left
    at the end goes to train."""

    def __init__(self, task_number: int = 0):
        self.task_number = task_number

    def split(self, dataset, frac_train=0.8, frac_valid=0.1, frac_test=0.1,
              seed=None, log_every_n=None):
        _validate_fracs(frac_train, frac_valid, frac_test)
        rng = np.random.RandomState(seed)
        y = dataset.y
        sortidx = np.argsort(y[:, self.task_number] if y.ndim > 1 else y)
        split_cd = 10
        train_cutoff = int(np.round(frac_train * split_cd))
        valid_cutoff = int(np.round(frac_valid * split_cd)) + train_cutoff
        train, valid, test = [], [], []
        while sortidx.shape[0] >= split_cd:
            block, sortidx = np.split(sortidx, [split_cd])
            shuffled = rng.permutation(range(split_cd))
            train += list(block[shuffled[:train_cutoff]])
            valid += list(block[shuffled[train_cutoff:valid_cutoff]])
            test += list(block[shuffled[valid_cutoff:]])
        train += list(sortidx)
        return np.array(train), np.array(valid), np.array(test)


def _mols(dataset):
    from deepchem_tpu_torch.chem import mol_from_smiles
    return [mol_from_smiles(str(s)) for s in dataset.ids]


def _fingerprints(dataset) -> np.ndarray:
    """Morgan fingerprints (radius 2, 1024 bits) of the ids' SMILES, zeros
    where one does not parse."""
    from deepchem_tpu_torch.chem import morgan_fingerprint
    return np.asarray([morgan_fingerprint(m, 2, 1024) if m is not None
                       else np.zeros(1024, dtype=np.uint8)
                       for m in _mols(dataset)], dtype=bool)


class MolecularWeightSplitter(Splitter):
    """Sorted by the ids' molecular weights (0 where a SMILES does not
    parse), lightest in train."""

    def split(self, dataset, frac_train=0.8, frac_valid=0.1, frac_test=0.1,
              seed=None, log_every_n=None):
        _validate_fracs(frac_train, frac_valid, frac_test)
        mws = [m.molecular_weight() if m is not None else 0.0
               for m in _mols(dataset)]
        order = np.argsort(np.asarray(mws), kind='stable')
        a, b = _cuts(len(dataset), frac_train, frac_valid)
        return order[:a], order[a:b], order[b:]


def generate_scaffold(smiles: str, include_chirality: bool = False) -> str:
    """The Bemis-Murcko scaffold's canonical SMILES ('' where there is
    none or the SMILES does not parse)."""
    from deepchem_tpu_torch.chem import scaffold_smiles
    s = scaffold_smiles(smiles, include_chirality)
    return s if s is not None else ''


class ScaffoldSplitter(Splitter):
    """Samples grouped by the scaffold of their ids' SMILES; the groups,
    largest first (ties by first index), fill train, then valid, then
    test."""

    def generate_scaffolds(self, dataset: Dataset,
                           log_every_n: int = 1000) -> List[List[int]]:
        scaffolds: Dict[str, List[int]] = {}
        for ind, smiles in enumerate(dataset.ids):
            scaffolds.setdefault(generate_scaffold(str(smiles)),
                                 []).append(ind)
        return [sorted(v) for _, v in sorted(
            scaffolds.items(), key=lambda kv: (len(kv[1]), kv[1][0]),
            reverse=True)]

    def split(self, dataset, frac_train=0.8, frac_valid=0.1, frac_test=0.1,
              seed=None, log_every_n=1000):
        _validate_fracs(frac_train, frac_valid, frac_test)
        train_cutoff = frac_train * len(dataset)
        valid_cutoff = (frac_train + frac_valid) * len(dataset)
        train, valid, test = [], [], []
        for group in self.generate_scaffolds(dataset):
            if len(train) + len(group) > train_cutoff:
                if len(train) + len(valid) + len(group) > valid_cutoff:
                    test += group
                else:
                    valid += group
            else:
                train += group
        return np.array(train), np.array(valid), np.array(test)


def _tanimoto_block(blk: np.ndarray, fps: np.ndarray, counts: np.ndarray,
                    s: int) -> np.ndarray:
    """Tanimoto similarities of rows ``s ..`` (``blk``) against every row,
    through a float32 product."""
    inter = blk.astype(np.float32) @ fps.astype(np.float32).T
    union = counts[s:s + len(blk), None] + counts[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


class FingerprintSplitter(Splitter):
    """Ordered by each molecule's mean Tanimoto similarity to all others:
    the least similar form test, then valid, the rest train."""

    def split(self, dataset, frac_train=0.8, frac_valid=0.1, frac_test=0.1,
              seed=None, log_every_n=None):
        _validate_fracs(frac_train, frac_valid, frac_test)
        fps = _fingerprints(dataset)
        n = len(fps)
        train_size, valid_size = int(frac_train * n), int(frac_valid * n)
        test_size = n - train_size - valid_size
        counts = fps.astype(np.float32).sum(axis=1)
        sums = np.zeros(n, dtype=np.float64)
        for s in range(0, n, 512):
            sums[s:s + 512] = _tanimoto_block(fps[s:s + 512], fps, counts,
                                              s).sum(axis=1)
        order = list(np.argsort(sums / max(n - 1, 1)))
        return (np.array(order[test_size + valid_size:]),
                np.array(order[test_size:test_size + valid_size]),
                np.array(order[:test_size]))


def butina_cluster(fps: np.ndarray, sim_cutoff: float) -> List[List[int]]:
    """Butina's sphere-exclusion clusters of binary fingerprints: rows of
    the most neighbours (similarity at least ``sim_cutoff``) first, each
    taking its unassigned neighbours; clusters largest first."""
    n = len(fps)
    counts = fps.astype(np.float32).sum(axis=1)
    neighbors: List[set] = []
    for s in range(0, n, 512):
        sims = _tanimoto_block(fps[s:s + 512], fps, counts, s)
        for r in range(sims.shape[0]):
            neighbors.append(set(np.nonzero(sims[r] >= sim_cutoff)[0]))
    order = np.argsort([-len(nb) for nb in neighbors], kind='stable')
    assigned = np.zeros(n, dtype=bool)
    clusters: List[List[int]] = []
    for c in order:
        if assigned[c]:
            continue
        members = [i for i in neighbors[c] if not assigned[i]]
        if c not in members:
            members.append(int(c))
        assigned[members] = True
        clusters.append(sorted(members))
    clusters.sort(key=len, reverse=True)
    return clusters


class ButinaSplitter(Splitter):
    """Butina clusters at Tanimoto distance ``cutoff``, largest first, fill
    train, then valid (or test while it is empty), then test."""

    def __init__(self, cutoff: float = 0.6):
        self.cutoff = cutoff

    def split(self, dataset, frac_train=0.8, frac_valid=0.1, frac_test=0.1,
              seed=None, log_every_n=None):
        _validate_fracs(frac_train, frac_valid, frac_test)
        clusters = butina_cluster(_fingerprints(dataset), 1.0 - self.cutoff)
        train_cutoff = frac_train * len(dataset)
        valid_cutoff = (frac_train + frac_valid) * len(dataset)
        train, valid, test = [], [], []
        for group in clusters:
            if len(train) + len(group) <= train_cutoff:
                train += list(group)
            elif len(train) + len(valid) + len(group) <= valid_cutoff \
                    or not test:
                valid += list(group)
            else:
                test += list(group)
        if frac_test == 0 and test:
            valid += test
            test = []
        return np.array(train), np.array(valid), np.array(test)


class MaxMinSplitter(Splitter):
    """Test and valid picked by MaxMin diversity from a random first
    molecule (``RandomState(seed or 0)``), test first; train the rest."""

    def split(self, dataset, frac_train=0.8, frac_valid=0.1, frac_test=0.1,
              seed=None, log_every_n=None):
        _validate_fracs(frac_train, frac_valid, frac_test)
        rng = np.random.RandomState(0 if seed is None else seed)
        f = _fingerprints(dataset).astype(np.float32)
        counts = f.sum(axis=1)
        n = len(f)
        num_valid = int(frac_valid * n)
        num_test = n - int(frac_train * n) - num_valid

        def dist_to(i):
            inter = f @ f[i]
            union = counts + counts[i] - inter
            return 1.0 - np.where(union > 0,
                                  inter / np.maximum(union, 1e-9), 0.0)
        picked: List[int] = []
        if num_test + num_valid > 0:
            picked.append(int(rng.randint(n)))
            min_dist = dist_to(picked[0])
            while len(picked) < num_test + num_valid:
                nxt = int(np.argmax(min_dist))
                picked.append(nxt)
                min_dist = np.minimum(min_dist, dist_to(nxt))
        picked_set = set(picked)
        train = [i for i in range(n) if i not in picked_set]
        return (np.array(train), np.array(picked[num_test:]),
                np.array(picked[:num_test]))


class TaskSplitter(Splitter):
    """Splits along the task axis (meta-learning): the first
    ``round(frac_train * n_tasks)`` tasks, the next
    ``round(frac_valid * n_tasks)``, the rest; every sample in each."""

    def train_valid_test_split(self, dataset, frac_train=0.8,
                               frac_valid=0.1, frac_test=0.1, **kwargs):
        y, w, X, ids = dataset.y, dataset.w, dataset.X, dataset.ids
        n_tasks = y.shape[1]
        a = int(np.round(frac_train * n_tasks))
        b = a + int(np.round(frac_valid * n_tasks))
        return tuple(NumpyDataset(X, y[:, s], w[:, s], ids)
                     for s in (slice(0, a), slice(a, b), slice(b, None)))

    def k_fold_split(self, dataset, k: int, **kwargs):
        y, w, X, ids = dataset.y, dataset.w, dataset.X, dataset.ids
        n_tasks = y.shape[1]
        size = n_tasks // k
        return [NumpyDataset(X, y[:, i * size:n_tasks if i == k - 1
                                  else (i + 1) * size],
                             w[:, i * size:n_tasks if i == k - 1
                               else (i + 1) * size], ids)
                for i in range(k)]


def merge_fold_datasets(fold_datasets) -> Optional[NumpyDataset]:
    """:class:`TaskSplitter` folds joined back along the task axis (they
    share X and ids)."""
    if not len(fold_datasets):
        return None
    return NumpyDataset(fold_datasets[0].X,
                        np.concatenate([f.y for f in fold_datasets], axis=1),
                        np.concatenate([f.w for f in fold_datasets], axis=1),
                        fold_datasets[0].ids)


class TimeSplitter(Splitter):
    """In the order of ``time_values`` (one a sample; stable), earliest in
    train; in dataset order without them."""

    def __init__(self, time_values: Optional[Sequence] = None):
        self.time_values = time_values

    def split(self, dataset, frac_train=0.8, frac_valid=0.1, frac_test=0.1,
              seed=None, log_every_n=None):
        _validate_fracs(frac_train, frac_valid, frac_test)
        order = np.argsort(np.asarray(self.time_values), kind='stable') \
            if self.time_values is not None else np.arange(len(dataset))
        a, b = _cuts(len(dataset), frac_train, frac_valid)
        return order[:a], order[a:b], order[b:]


TimeSplitterPDBbind = TimeSplitter
