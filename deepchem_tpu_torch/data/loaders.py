"""Loaders from files to featurized ``DiskDataset``s, a shard at a time.

The port's own copy of ``deepchem_tpu/data/loaders.py``: CSV, CSV of
precomputed features, JSON lines, SDF, FASTA, FASTQ and in-memory
frontends.  The files are read without pandas (``utils/data_utils.py``
reads CSV and JSON columns as pandas types them, per shard), so a file
loads to the same X, y, w and ids in both packages.  The next shard is
read and featurized in a thread while the one before is written.
"""

from __future__ import annotations

import inspect
import itertools
import logging
import os
import queue
import threading
import time
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from deepchem_tpu_torch.data.datasets import DiskDataset
from deepchem_tpu_torch.feat.base import Featurizer, UserDefinedFeaturizer
from deepchem_tpu_torch.utils.data_utils import (Table, _csv_shards,
                                                 _json_shards, _open,
                                                 to_numeric)

logger = logging.getLogger(__name__)


def _filter_valid(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Drop failed featurizations (empty arrays); stack the survivors into
    one numeric array when they share a shape.  Returns them and their
    indices."""
    valid = np.array([
        f is not None and (not isinstance(f, np.ndarray) or f.size > 0)
        for f in feats], dtype=bool)
    kept = feats[valid]
    if kept.dtype == object and len(kept):
        first = kept[0]
        if all(isinstance(f, np.ndarray)
               and f.shape == getattr(first, 'shape', None)
               and f.dtype.kind in 'fiub' for f in kept):
            kept = np.stack(list(kept))
    return kept, np.nonzero(valid)[0]


def _lookahead(gen: Iterator, depth: int = 1) -> Iterator:
    """``gen``'s items, the next ``depth`` made in a thread while the
    caller handles the one before; an exception in ``gen`` is raised to
    the caller, and a caller that stops early stops the thread."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in gen:
                if not put(item):
                    return
            put(end)
        except BaseException as e:             # handed to the consumer
            put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join()


def _labels(table: Table, tasks: Sequence[str]
            ) -> Tuple[np.ndarray, np.ndarray]:
    """(y, w) float64 from the task columns: a cell that is not a number is
    missing, y 0 and w 0 there."""
    n = len(table)
    y = np.zeros((n, len(tasks)), dtype=float)
    w = np.ones((n, len(tasks)), dtype=float)
    for i, task in enumerate(tasks):
        vals = to_numeric(table[task])
        missing = np.isnan(vals)
        y[:, i] = np.nan_to_num(vals, nan=0.0)
        w[:, i] = (~missing).astype(float)
    return y, w


class DataLoader:
    """Files to a ``DiskDataset``, one shard at a time.  ``n_jobs``
    featurizer processes a shard (default every core, as the JAX
    package).  ``seconds`` holds the last ``create_dataset``'s time in
    reading the files, featurizing and writing the shards (reading and
    featurizing run in a thread beside the writes)."""

    def __init__(self, tasks: Sequence[str], featurizer: Featurizer,
                 id_field: Optional[str] = None, log_every_n: int = 1000,
                 n_jobs: Optional[int] = None):
        if not isinstance(tasks, (list, tuple)):
            raise ValueError('tasks must be a list of task names')
        self.tasks = list(tasks)
        self.featurizer = featurizer
        self.id_field = id_field
        self.log_every_n = log_every_n
        self.n_jobs = os.cpu_count() if n_jobs is None else n_jobs
        self.user_specified_features = None
        self.seconds = {'read': 0.0, 'featurize': 0.0, 'write': 0.0}
        if isinstance(featurizer, UserDefinedFeaturizer):
            self.user_specified_features = featurizer.feature_fields

    def featurize(self, inputs, data_dir: Optional[str] = None,
                  shard_size: Optional[int] = 8192) -> DiskDataset:
        """Another name of :meth:`create_dataset`."""
        return self.create_dataset(inputs, data_dir, shard_size)

    def _featurize(self, inputs) -> np.ndarray:
        """The featurizer over one shard's inputs, with the loader's pool
        width where its ``featurize`` takes one."""
        kwargs = {'log_every_n': self.log_every_n}
        if 'n_jobs' in inspect.signature(
                self.featurizer.featurize).parameters:
            kwargs['n_jobs'] = self.n_jobs
        return self.featurizer.featurize(inputs, **kwargs)

    def create_dataset(self, inputs, data_dir: Optional[str] = None,
                       shard_size: Optional[int] = 8192) -> DiskDataset:
        """A ``DiskDataset`` in ``data_dir`` (default a new temporary
        folder) of the files ``inputs``: a shard of featurized rows for
        every ``shard_size`` rows read, rows whose features failed
        dropped."""
        if isinstance(inputs, (str, os.PathLike)):
            inputs = [inputs]
        seconds = self.seconds = dict.fromkeys(self.seconds, 0.0)

        def shard_generator():
            shards = self._get_shards(list(inputs), shard_size)
            for shard_num in itertools.count():
                t0 = time.perf_counter()
                shard = next(shards, None)
                t1 = time.perf_counter()
                seconds['read'] += t1 - t0
                if shard is None:
                    return
                X, valid = self._featurize_shard(shard)
                seconds['featurize'] += time.perf_counter() - t1
                ids = self._shard_ids(shard)
                logger.info('featurized shard %d (%d/%d valid)', shard_num,
                            len(X), len(ids))
                y = w = None
                if self.tasks:
                    y, w = self._shard_labels(shard)
                    y, w = y[valid], w[valid]
                yield X, y, w, ids[valid]

        def timed(items):
            # the time between handing a shard over and being asked for
            # the next is the writer's
            for item in items:
                t0 = time.perf_counter()
                yield item
                seconds['write'] += time.perf_counter() - t0
        return DiskDataset.create_dataset(
            timed(_lookahead(shard_generator())), data_dir, self.tasks)

    def _get_shards(self, inputs: List, shard_size: Optional[int]):
        raise NotImplementedError

    def _featurize_shard(self, shard) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def _shard_ids(self, shard) -> np.ndarray:
        raise NotImplementedError

    def _shard_labels(self, shard) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError


class CSVLoader(DataLoader):
    """CSV files (perhaps compressed) to a ``DiskDataset``.
    ``feature_field`` names the column the featurizer reads (SMILES, say);
    the ids are the ``id_field`` column, by default that one; the task
    columns give y, w 0 where a cell is empty, an NA token or not a
    number."""

    def __init__(self, tasks: Sequence[str], featurizer: Featurizer,
                 feature_field: Optional[str] = None,
                 id_field: Optional[str] = None,
                 smiles_field: Optional[str] = None,
                 log_every_n: int = 1000, n_jobs: Optional[int] = None):
        if smiles_field is not None:
            logger.warning('smiles_field is deprecated; use feature_field')
            if feature_field is None:
                feature_field = smiles_field
        super().__init__(tasks, featurizer, id_field, log_every_n,
                         n_jobs=n_jobs)
        self.feature_field = feature_field
        if id_field is None:
            self.id_field = feature_field

    def _get_shards(self, inputs, shard_size):
        for path in inputs:
            yield from _csv_shards(path, shard_size)

    def _featurize_shard(self, shard: Table):
        return _filter_valid(self._featurize(shard[self.feature_field]))

    def _shard_ids(self, shard: Table) -> np.ndarray:
        return shard[self.id_field] if self.id_field else shard.index

    def _shard_labels(self, shard: Table):
        return _labels(shard, self.tasks)


class UserCSVLoader(CSVLoader):
    """CSV files whose features are columns already: X is the
    featurizer's ``feature_fields`` as float64."""

    def _featurize_shard(self, shard: Table):
        if not isinstance(self.featurizer, UserDefinedFeaturizer):
            raise ValueError('UserCSVLoader needs a UserDefinedFeaturizer')
        X = shard[self.featurizer.feature_fields].astype(float)
        return X, np.arange(len(X))


class JsonLoader(DataLoader):
    """JSON-lines files (one record a line) to a ``DiskDataset``; the ids
    are the ``id_field`` column, by default the rows' positions in the
    file."""

    def __init__(self, tasks, featurizer, feature_field, id_field=None,
                 label_field=None, weight_field=None,
                 log_every_n: int = 1000, n_jobs: Optional[int] = None):
        super().__init__(tasks, featurizer, id_field, log_every_n,
                         n_jobs=n_jobs)
        self.feature_field = feature_field
        self.label_field = label_field
        self.weight_field = weight_field

    def _get_shards(self, inputs, shard_size):
        for path in inputs:
            yield from _json_shards(path, shard_size)

    def _featurize_shard(self, shard: Table):
        return _filter_valid(self._featurize(shard[self.feature_field]))

    def _shard_ids(self, shard: Table) -> np.ndarray:
        return shard[self.id_field] if self.id_field else shard.index

    def _shard_labels(self, shard: Table):
        return _labels(shard, self.tasks)


class SDFLoader(DataLoader):
    """SDF files to a ``DiskDataset``: the molecules featurized, the ids
    their canonical SMILES ('' where a record has no molecule), the tasks'
    values from each record's properties (w 0 where one is absent or not a
    number)."""

    def __init__(self, tasks, featurizer, sanitize: bool = False,
                 log_every_n: int = 1000, n_jobs: Optional[int] = None):
        super().__init__(tasks, featurizer, None, log_every_n,
                         n_jobs=n_jobs)
        self.sanitize = sanitize

    def _get_shards(self, inputs, shard_size):
        from deepchem_tpu_torch.chem.sdf import parse_sdf
        buf = []
        for path in inputs:
            with _open(path) as f:
                text = f.read()
            for record in parse_sdf(text):
                buf.append(record)
                if shard_size is not None and len(buf) >= shard_size:
                    yield buf
                    buf = []
        if buf:
            yield buf

    def _featurize_shard(self, shard):
        return _filter_valid(self._featurize([m for m, _ in shard]))

    def _shard_ids(self, shard) -> np.ndarray:
        from deepchem_tpu_torch.chem import mol_to_smiles
        ids = np.empty(len(shard), dtype=object)
        ids[:] = [mol_to_smiles(m) if m is not None else ''
                  for m, _ in shard]
        return ids

    def _shard_labels(self, shard):
        y = np.zeros((len(shard), len(self.tasks)))
        w = np.ones((len(shard), len(self.tasks)))
        for j, (_, props) in enumerate(shard):
            for i, task in enumerate(self.tasks):
                try:
                    y[j, i] = float(props.get(task, ''))
                except (TypeError, ValueError):
                    w[j, i] = 0.0
        return y, w


def _one_hot_dna(seqs: Sequence[str]) -> np.ndarray:
    """A, C, G, T and anything else (N) one-hot, padded to the longest."""
    charmap = {'A': 0, 'C': 1, 'G': 2, 'T': 3}
    L = max((len(s) for s in seqs), default=0)
    out = np.zeros((len(seqs), L, 5), dtype=np.float32)
    for i, s in enumerate(seqs):
        for j, c in enumerate(s.upper()):
            out[i, j, charmap.get(c, 4)] = 1.0
    return out


class _SequenceLoader(DataLoader):
    """Sequence files to a one-shard ``DiskDataset``: X the featurizer's
    features of the sequences (default one-hot DNA, padded), ids their
    names; no labels."""

    def __init__(self, featurizer: Optional[Featurizer] = None):
        super().__init__([], featurizer, n_jobs=1)

    def create_dataset(self, inputs, data_dir: Optional[str] = None,
                       shard_size: Optional[int] = None) -> DiskDataset:
        if isinstance(inputs, (str, os.PathLike)):
            inputs = [inputs]
        seqs: List[str] = []
        ids: List[str] = []
        for path in inputs:
            with _open(path) as f:
                for name, seq in self._records(f):
                    ids.append(name)
                    seqs.append(seq)
        X = self.featurizer.featurize(seqs) if self.featurizer is not None \
            else _one_hot_dna(seqs)
        out = np.empty(len(ids), dtype=object)
        out[:] = ids
        return DiskDataset.from_numpy(X, ids=out, data_dir=data_dir)

    def _records(self, f) -> Iterator[Tuple[str, str]]:
        raise NotImplementedError


class FASTALoader(_SequenceLoader):
    """FASTA files: each ``>name`` and the sequence lines under it."""

    def __init__(self, featurizer: Optional[Featurizer] = None,
                 auto_add_annotations: bool = False, legacy: bool = False):
        super().__init__(featurizer)
        self.auto_add_annotations = auto_add_annotations

    def _records(self, f):
        header, chunks = None, []
        for line in f:
            line = line.strip()
            if line.startswith('>'):
                if header is not None:
                    yield header, ''.join(chunks)
                header, chunks = line[1:], []
            elif line:
                chunks.append(line)
        if header is not None:
            yield header, ''.join(chunks)


class FASTQLoader(_SequenceLoader):
    """FASTQ files: records of four lines, ``@name``, the sequence, ``+``
    and the qualities."""

    def _records(self, f):
        lines = [ln.strip() for ln in f]
        for i in range(0, len(lines) - 3, 4):
            yield lines[i][1:], lines[i + 1]


class InMemoryLoader(DataLoader):
    """Datapoints in memory to a ``DiskDataset``: each input is a
    datapoint or a tuple ``(x, y, w, id)`` cut short anywhere after x
    (y default zeros, w ones, id its position)."""

    def create_dataset(self, inputs: Sequence[Any],
                       data_dir: Optional[str] = None,
                       shard_size: Optional[int] = 8192) -> DiskDataset:
        inputs = list(inputs)

        def shard_generator():
            size = shard_size or len(inputs) or 1
            for start in range(0, len(inputs), size):
                points, ys, ws, ids = [], [], [], []
                for i, row in enumerate(inputs[start:start + size]):
                    row = list(row) if isinstance(row, (tuple, list)) \
                        else [row]
                    points.append(row[0])
                    ys.append(row[1] if len(row) > 1
                              else np.zeros(len(self.tasks)))
                    ws.append(row[2] if len(row) > 2
                              else np.ones(len(self.tasks)))
                    ids.append(row[3] if len(row) > 3 else start + i)
                X, valid = _filter_valid(self._featurize(points))
                yield (X, np.asarray(ys)[valid], np.asarray(ws)[valid],
                       np.asarray(ids, dtype=object)[valid])
        return DiskDataset.create_dataset(shard_generator(), data_dir,
                                          self.tasks)
