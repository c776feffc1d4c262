"""The data directory, downloads, persistence of datasets and
transformers, and readers of CSV, JSON-lines and SDF files.

The port's own copy of ``deepchem_tpu/utils/data_utils.py``, written
without pandas or joblib, which the card's machine lacks:

- arrays are saved as ``.npy`` (numeric) or pickled (object arrays and
  anything else), never in joblib's format;
- the readers yield :class:`Table` shards, a few columns of numpy arrays,
  where the JAX package yields DataFrames.  A CSV column gets the dtype
  ``pandas.read_csv`` infers for it, chunk by chunk: int64 (no missing
  cell), float64 (NaN where missing), bool, or an object array of
  strings with NaN where missing.  A cell holding one of pandas' default
  NA tokens (:data:`NA_TOKENS`) is missing.
"""

from __future__ import annotations

import csv
import gzip
import json
import logging
import os
import pickle
import re
import shutil
import tarfile
import zipfile
from typing import Any, Dict, Iterator, List, Optional, Sequence
from urllib.parse import urlparse

import numpy as np

logger = logging.getLogger(__name__)

#: the cells ``pandas.read_csv`` reads as missing by default
NA_TOKENS = frozenset([
    '', '#N/A', '#N/A N/A', '#NA', '-1.#IND', '-1.#QNAN', '-NaN', '-nan',
    '1.#IND', '1.#QNAN', '<NA>', 'N/A', 'NA', 'NULL', 'NaN', 'None', 'n/a',
    'nan', 'null'])
_INT = re.compile(r'[+-]?\d+')
_FLOAT = re.compile(r'[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?'
                    r'|inf|infinity)', re.IGNORECASE)
_BOOL = {'True': True, 'TRUE': True, 'true': True,
         'False': False, 'FALSE': False, 'false': False}


def get_data_dir() -> str:
    """``DEEPCHEM_DATA_DIR`` if set, else ``~/.deepchem_tpu``; made if
    missing."""
    d = os.environ.get('DEEPCHEM_DATA_DIR') or os.path.join(
        os.path.expanduser('~'), '.deepchem_tpu')
    os.makedirs(d, exist_ok=True)
    return d


def download_url(url: str, dest_dir: Optional[str] = None,
                 name: Optional[str] = None) -> str:
    """The local path of ``url``'s file in ``dest_dir`` (default the data
    directory), fetched with ``urllib`` unless it is already there."""
    if dest_dir is None:
        dest_dir = get_data_dir()
    if name is None:
        name = os.path.basename(urlparse(url).path)
    dest = os.path.join(dest_dir, name)
    if os.path.exists(dest):
        return dest
    import urllib.request
    os.makedirs(dest_dir, exist_ok=True)
    logger.info('downloading %s', url)
    urllib.request.urlretrieve(url, dest)
    return dest


def untargz_file(path: str, dest_dir: str) -> None:
    with tarfile.open(path) as t:
        t.extractall(dest_dir)


def unzip_file(path: str, dest_dir: str) -> None:
    with zipfile.ZipFile(path) as z:
        z.extractall(dest_dir)


def save_to_disk(obj: Any, filename: str) -> None:
    """Write ``obj``: a numeric array as ``.npy`` where ``filename`` ends
    so, anything else pickled."""
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    if filename.endswith('.npy'):
        np.save(filename, np.asarray(obj), allow_pickle=False)
        return
    with open(filename, 'wb') as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_from_disk(filename: str) -> Any:
    """Read what :func:`save_to_disk` wrote: ``.npy`` or ``.npz``, else a
    pickle (perhaps gzipped)."""
    base = filename[:-3] if filename.endswith('.gz') else filename
    if os.path.splitext(base)[1] in ('.npy', '.npz'):
        return np.load(filename, allow_pickle=True)
    with _open(filename, 'rb') as f:
        return pickle.load(f)


def save_dataset_to_disk(save_dir: str, train, valid, test,
                         transformers: List) -> None:
    """Move each split to ``save_dir/{train,valid,test}_dir`` and save the
    transformers beside them."""
    for name, ds in (('train', train), ('valid', valid), ('test', test)):
        ds.move(os.path.join(save_dir, f'{name}_dir'))
    save_transformers(save_dir, transformers)


def load_dataset_from_disk(save_dir: str):
    """``(True, (train, valid, test), transformers)`` from what
    :func:`save_dataset_to_disk` wrote, or ``(False, None, [])`` where a
    split's manifest is missing.  A folder that holds another format's
    shards raises (see ``DiskDataset``)."""
    from deepchem_tpu_torch.data.datasets import DiskDataset
    dirs = [os.path.join(save_dir, f'{n}_dir')
            for n in ('train', 'valid', 'test')]
    if not all(os.path.isfile(os.path.join(d, DiskDataset.MANIFEST))
               for d in dirs):
        return False, None, list()
    datasets = tuple(DiskDataset(d) for d in dirs)
    return True, datasets, load_transformers(save_dir)


def save_transformers(save_dir: str, transformers: List) -> None:
    save_to_disk(list(transformers),
                 os.path.join(save_dir, 'transformers.pkl'))


def load_transformers(save_dir: str) -> List:
    path = os.path.join(save_dir, 'transformers.pkl')
    return load_from_disk(path) if os.path.exists(path) else []


def _open(path: str, mode: str = 'rt'):
    """``path`` opened, through gzip where its name ends ``.gz`` (as
    pandas infers it)."""
    kw = {'newline': ''} if 't' in mode else {}
    if path.endswith('.gz'):
        return gzip.open(path, mode, **kw)
    return open(path, mode, **kw)


class Table:
    """A shard of rows as named columns, each a numpy array: what a
    reader yields where the JAX package yields a DataFrame.
    ``table[name]`` is a column (a DataFrame's ``df[name].values``),
    ``table[[a, b]]`` a 2-D array of those columns, and ``index`` the
    rows' positions in their file."""

    def __init__(self, columns: Dict[str, np.ndarray], start: int = 0):
        self.data = columns
        self.columns = list(columns)
        self.start = start

    def __len__(self) -> int:
        return len(next(iter(self.data.values()))) if self.data else 0

    def __getitem__(self, key):
        if isinstance(key, (list, tuple)):
            return np.stack([self.data[k] for k in key], axis=1) \
                if key else np.zeros((len(self), 0))
        return self.data[key]

    @property
    def index(self) -> np.ndarray:
        return np.arange(self.start, self.start + len(self))


def csv_column(cells: Sequence[Optional[str]]) -> np.ndarray:
    """A CSV column's cells (None where the row was short) as
    ``pandas.read_csv`` types them."""
    missing = [c is None or c in NA_TOKENS for c in cells]
    present = [c for c, m in zip(cells, missing) if not m]
    if not present:
        return np.full(len(cells), np.nan)
    if not any(missing) and all(_INT.fullmatch(c) for c in present):
        try:
            return np.array([int(c) for c in cells], dtype=np.int64)
        except OverflowError:
            pass
    if all(_FLOAT.fullmatch(c) for c in present):
        return np.array([np.nan if m else float(c)
                         for c, m in zip(cells, missing)], dtype=np.float64)
    if not any(missing) and all(c in _BOOL for c in present):
        return np.array([_BOOL[c] for c in cells], dtype=bool)
    out = np.empty(len(cells), dtype=object)
    out[:] = [np.nan if m else c for c, m in zip(cells, missing)]
    return out


def to_numeric(column: np.ndarray) -> np.ndarray:
    """``pandas.to_numeric(column, errors='coerce')`` as float64: a
    numeric or bool column as it is, in an object column each string
    that reads as a number that number and anything else NaN."""
    if column.dtype != object:
        return column.astype(np.float64)
    out = np.full(len(column), np.nan)
    for i, v in enumerate(column):
        if isinstance(v, str):
            if _FLOAT.fullmatch(v.strip()):
                out[i] = float(v)
        elif isinstance(v, (bool, int, float, np.number)):
            out[i] = float(v)
    return out


def _csv_shards(path: str, shard_size: Optional[int]) -> Iterator[Table]:
    """A CSV file's shards, each ``index`` running on through the file
    (as ``pandas.read_csv``'s chunks)."""
    with _open(path) as f:
        reader = csv.reader(f)
        header = next(reader)
        rows: List[List[str]] = []
        start = 0
        for row in reader:
            if not row:
                continue               # pandas skips blank lines
            if len(row) > len(header):
                raise ValueError(f'{path}: a row of {len(row)} fields '
                                 f'under a header of {len(header)}')
            rows.append(row)
            if shard_size is not None and len(rows) == shard_size:
                yield _csv_table(header, rows, start)
                start += len(rows)
                rows = []
        if rows or start == 0:
            yield _csv_table(header, rows, start)


def _csv_table(header: List[str], rows: List[List[str]],
               start: int) -> Table:
    return Table({name: csv_column([r[j] if j < len(r) else None
                                    for r in rows])
                  for j, name in enumerate(header)}, start)


def load_csv_files(filenames: Sequence[str],
                   shard_size: Optional[int] = None) -> Iterator[Table]:
    """Each CSV file (perhaps compressed) as :class:`Table` shards of at
    most ``shard_size`` rows (all its rows with None), each indexed from
    0."""
    for fname in filenames:
        for table in _csv_shards(fname, shard_size):
            yield Table(table.data)


def csv_header(path: str) -> List[str]:
    """The column names of a CSV file (perhaps compressed)."""
    with _open(path) as f:
        return next(csv.reader(f))


_MISSING = object()          # a key a JSON record lacks


def json_column(values: Sequence[Any]) -> np.ndarray:
    """A JSON-lines column (``_MISSING`` where a record lacks the key) as
    ``pandas.read_json`` types it: int64 where every value is an integer
    or an integral float and none is missing, float64 where every value is
    a number or missing, bool where every value is a bool, else objects
    (NaN where missing or null)."""
    present = [v for v in values if v is not _MISSING and v is not None]
    missing = len(present) < len(values)
    if present and all(isinstance(v, bool) for v in present) \
            and not missing:
        return np.array(values, dtype=bool)
    if all(isinstance(v, (int, float)) and not isinstance(v, bool)
           for v in present):
        arr = np.array([np.nan if v is _MISSING or v is None else v
                        for v in values], dtype=np.float64)
        if not missing and present \
                and np.all(np.isfinite(arr)) and np.all(arr == np.round(arr)):
            return arr.astype(np.int64)
        return arr
    out = np.empty(len(values), dtype=object)
    out[:] = [np.nan if v is _MISSING or v is None else v for v in values]
    return out



def _json_shards(path: str, shard_size: Optional[int]) -> Iterator[Table]:
    """A JSON-lines file's shards, each ``index`` running on through the
    file (a loader's ids where it names no id column)."""
    with _open(path) as f:
        records = [json.loads(ln) for ln in f if ln.strip()]
    keys: Dict[str, None] = {}
    for r in records:
        keys.update(dict.fromkeys(r))
    size = shard_size or max(1, len(records))
    for start in range(0, max(1, len(records)), size):
        chunk = records[start:start + size]
        yield Table({k: json_column([r.get(k, _MISSING) for r in chunk])
                     for k in keys}, start)


def load_json_files(filenames: Sequence[str],
                    shard_size: Optional[int] = None) -> Iterator[Table]:
    """Each JSON-lines file (one record a line) as :class:`Table` shards
    of at most ``shard_size`` rows, each indexed from 0."""
    for fname in filenames:
        for table in _json_shards(fname, shard_size):
            yield Table(table.data)


def load_sdf_files(filenames: Sequence[str], clean_mols: bool = True,
                   tasks: Optional[Sequence[str]] = None,
                   shard_size: Optional[int] = None) -> Iterator[Table]:
    """The records of SDF files as :class:`Table` shards with columns
    ``mol`` (a :class:`Molecule`, or None where ``clean_mols`` is False and
    it did not parse), ``smiles`` (canonical, '' for no molecule) and each
    task's property (its text, None where absent)."""
    from deepchem_tpu_torch.chem import mol_to_smiles
    from deepchem_tpu_torch.chem.sdf import parse_sdf
    tasks = list(tasks or [])
    rows: List[tuple] = []

    def table():
        cols = {'mol': [r[0] for r in rows], 'smiles': [r[1] for r in rows]}
        for j, t in enumerate(tasks):
            cols[t] = [r[2][j] for r in rows]
        out = {}
        for k, v in cols.items():
            out[k] = np.empty(len(v), dtype=object)
            out[k][:] = v
        return Table(out)
    for fname in filenames:
        with _open(fname) as f:
            text = f.read()
        for mol, props in parse_sdf(text):
            if mol is None and clean_mols:
                continue
            rows.append((mol, mol_to_smiles(mol) if mol is not None else '',
                         [props.get(t) for t in tasks]))
            if shard_size and len(rows) >= shard_size:
                yield table()
                rows = []
    if rows:
        yield table()


def move_or_copy(src: str, dst: str) -> None:
    """``src``'s tree at ``dst`` (replaced if there): renamed where it is a
    temporary folder, else copied."""
    import tempfile
    if os.path.isdir(dst):
        shutil.rmtree(dst)
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    if os.path.abspath(src).startswith(
            os.path.abspath(tempfile.gettempdir()) + os.sep):
        shutil.move(src, dst)
    else:
        shutil.copytree(src, dst)
