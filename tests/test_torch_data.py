"""The port's data layer against the JAX package's, on the CPU.

``NumpyDataset`` and ``DiskDataset`` (creation, shards, ``select`` into a
folder, ``merge``, ``reshard``, ``transform`` through the balancing and
normalization transformers, ``iterbatches`` in order and shuffled under
seeded streams, the shuffles, the memory cache, saving and reloading),
``Databag``, ``make_pytorch_dataset`` and the loaders (CSV, CSV of
features, JSON lines, SDF, FASTA, FASTQ, in memory) on files written
here: empty cells, pandas' NA tokens, quoted commas, gzip, SMILES that do
not parse, shards of 7 rows.  Arrays, ids (values and types) and task
names must be equal; transformer statistics within 1e-12.
"""

import gzip
import json
import os
import random
import threading

import numpy as np
import pytest
import torch

import deepchem_tpu.data as jdata
import deepchem_tpu.feat as jfeat
import deepchem_tpu.trans as jtrans
from deepchem_tpu.utils import data_utils as jdu
import deepchem_tpu_torch.data as pdata
import deepchem_tpu_torch.feat as pfeat
import deepchem_tpu_torch.trans as ptrans
from deepchem_tpu_torch.data.pytorch_datasets import make_pytorch_dataset
from deepchem_tpu_torch.utils import data_utils as pdu

torch.set_num_threads(1)

SMILES = ['CCO', 'c1ccccc1O', 'CC(=O)Oc1ccccc1C(=O)O', 'not_a_smiles',
          'CN1C=NC2=C1C(=O)N(C(=O)N2C)C', 'C[N+](C)(C)CC(=O)[O-]',
          'F/C=C/F', 'CC#N', 'C1CC1N', 'OC(=O)CNCP(=O)(O)O', 'C1=CC=CN1',
          'c1ccc2ccccc2c1']
NA_CELLS = ['', 'NA', 'nan', 'N/A', 'NULL', 'None', '#N/A', 'n/a', '<NA>']


def _same(a, b) -> bool:
    """Equal arrays, or object arrays of equal entries (GraphData by its
    arrays), with the same dtype kind."""
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or (a.dtype == object) != (b.dtype == object):
        return False
    if a.dtype != object:
        return a.dtype == b.dtype and np.array_equal(
            a, b, equal_nan=a.dtype.kind in 'fc')
    return all(_same_item(x, y) for x, y in zip(a.ravel(), b.ravel()))


def _same_item(x, y) -> bool:
    if hasattr(x, 'node_features'):
        return (np.array_equal(x.node_features, y.node_features)
                and np.array_equal(x.edge_index, y.edge_index))
    if isinstance(x, np.ndarray):
        return _same(x, y)
    if isinstance(x, float) and x != x:
        return isinstance(y, float) and y != y
    return type(x) is type(y) and x == y


def _same_dataset(jd, pd_) -> bool:
    return all(_same(getattr(jd, k), getattr(pd_, k))
               for k in ('X', 'y', 'w', 'ids'))


def _arrays(seed=0, n=23, tasks=3):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 4))
    y = rng.randint(0, 2, (n, tasks)).astype(np.float64)
    w = (rng.uniform(size=(n, tasks)) > 0.2).astype(np.float64)
    ids = np.array([f'm{i}' for i in range(n)], dtype=object)
    return X, y, w, ids


def _disk_pair(tmp_path, shard=5, **kw):
    """The same arrays as a JAX and a port DiskDataset of shards of
    ``shard`` rows."""
    X, y, w, ids = _arrays(**kw)
    shards = [(X[i:i + shard], y[i:i + shard], w[i:i + shard],
               ids[i:i + shard]) for i in range(0, len(X), shard)]
    tasks = ['a', 'b', 'c']
    jd = jdata.DiskDataset.create_dataset(shards, str(tmp_path / 'jax'),
                                          tasks)
    pd_ = pdata.DiskDataset.create_dataset(shards, str(tmp_path / 'port'),
                                           tasks)
    return jd, pd_


# -- NumpyDataset -------------------------------------------------------------

def test_numpy_dataset_methods_match(tmp_path):
    X, y, w, ids = _arrays()
    jd, pd_ = jdata.NumpyDataset(X, y, w, ids), pdata.NumpyDataset(X, y, w,
                                                                   ids)
    sel = [5, 1, 1, 22]
    assert _same_dataset(jd.select(sel), pd_.select(sel))
    assert _same_dataset(jdata.NumpyDataset.merge([jd, jd.select(sel)]),
                         pdata.NumpyDataset.merge([pd_, pd_.select(sel)]))
    for a, b in zip(jd.get_statistics(), pd_.get_statistics()):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    jd.to_json(str(tmp_path / 'j.json'))
    pd_.to_json(str(tmp_path / 'p.json'))
    assert (tmp_path / 'j.json').read_text() == \
        (tmp_path / 'p.json').read_text()
    assert _same_dataset(jdata.NumpyDataset.from_json(str(tmp_path /
                                                          'j.json')),
                         pdata.NumpyDataset.from_json(str(tmp_path /
                                                          'p.json')))
    disk = pdata.DiskDataset.from_numpy(X, y, w, ids,
                                        data_dir=str(tmp_path / 'd'))
    assert _same_dataset(jd, pdata.NumpyDataset.from_DiskDataset(disk))
    assert list(jd.get_task_names()) == list(pd_.get_task_names())


@pytest.mark.parametrize('deterministic,pad', [(True, True), (False, False)])
def test_numpy_iterbatches_match(deterministic, pad):
    X, y, w, ids = _arrays()
    jd, pd_ = jdata.NumpyDataset(X, y, w, ids), pdata.NumpyDataset(X, y, w,
                                                                   ids)
    np.random.seed(3)
    want = list(jd.iterbatches(5, epochs=2, deterministic=deterministic,
                               pad_batches=pad))
    got = list(pd_.iterbatches(5, epochs=2, deterministic=deterministic,
                               pad_batches=pad,
                               rng=np.random.RandomState(3)))
    assert len(want) == len(got) == 10
    assert all(_same(a, b) for bw, bg in zip(want, got)
               for a, b in zip(bw, bg))


# -- DiskDataset --------------------------------------------------------------

def test_disk_dataset_shards_and_accessors(tmp_path):
    jd, pd_ = _disk_pair(tmp_path)
    assert pd_.get_number_shards() == jd.get_number_shards() == 5
    assert pd_.get_shard_size() == jd.get_shard_size() == 5
    assert len(pd_) == len(jd) == 23
    assert pd_.get_shape() == jd.get_shape()
    assert list(pd_.tasks) == list(jd.tasks)
    assert _same_dataset(jd, pd_)
    for i in range(5):
        assert all(_same(a, b) for a, b in zip(jd.get_shard(i),
                                               pd_.get_shard(i)))
    assert _same(jd.get_shard_ids(2), pd_.get_shard_ids(2))
    assert pd_.get_data_shape() == jd.get_data_shape()
    # from_numpy: task names the JAX package writes (numbers as strings)
    X, y, w, ids = _arrays()
    a = jdata.DiskDataset.from_numpy(X, y, w, ids,
                                     data_dir=str(tmp_path / 'jn'))
    b = pdata.DiskDataset.from_numpy(X, y, w, ids,
                                     data_dir=str(tmp_path / 'pn'))
    assert list(a.tasks) == list(b.tasks) and _same_dataset(a, b)
    # the port's manifest names its format; no joblib file is written
    manifest = json.loads((tmp_path / 'port' / 'manifest.json').read_text())
    assert manifest['format'] == pdata.datasets.SHARD_FORMAT
    assert not any(f.endswith('.joblib')
                   for f in os.listdir(tmp_path / 'port'))


def test_disk_select_into_a_folder_and_merge(tmp_path):
    jd, pd_ = _disk_pair(tmp_path)
    idx = [17, 3, 4, 9, 0, 22, 3]
    js = jd.select(idx, select_dir=str(tmp_path / 'js'))
    ps = pd_.select(idx, select_dir=str(tmp_path / 'ps'),
                    select_shard_size=3)
    assert os.path.isfile(tmp_path / 'ps' / 'manifest.json')
    assert ps.get_number_shards() == 3
    assert _same_dataset(js, ps)
    assert _same_dataset(jd.select(idx), pd_.select(idx))
    jm = jdata.DiskDataset.merge([jd, js])
    pm = pdata.DiskDataset.merge([pd_, ps], merge_dir=str(tmp_path / 'pm'))
    assert _same_dataset(jm, pm) and list(pm.tasks) == list(jm.tasks)
    assert pm.get_number_shards() == 5 + 3
    assert jm.get_number_shards() == 5 + 2


def test_disk_reshard(tmp_path):
    jd, pd_ = _disk_pair(tmp_path)
    jd.reshard(7)
    version = pd_._version
    pd_.reshard(7)
    assert pd_._version > version
    assert [len(s[0]) for s in pd_.itershards()] == \
        [len(s[0]) for s in jd.itershards()] == [7, 7, 7, 2]
    assert _same_dataset(jd, pd_)
    assert _same_dataset(jd, pdata.DiskDataset(pd_.data_dir))


def test_disk_transform_through_balancing_and_normalization(tmp_path):
    jd, pd_ = _disk_pair(tmp_path)
    jb, pb = jtrans.BalancingTransformer(dataset=jd), \
        ptrans.BalancingTransformer(dataset=pd_)
    for tj, tp in zip(jb.weights, pb.weights):
        assert tj.keys() == tp.keys()
        np.testing.assert_allclose([tj[k] for k in tj], [tp[k] for k in tj],
                                   rtol=0, atol=1e-12)
    out = tmp_path / 'balanced'
    pt = pb.transform(pd_, out_dir=str(out))
    assert isinstance(pt, pdata.DiskDataset) and pt.data_dir == str(out)
    assert pt.get_number_shards() == 5
    jt = jb.transform(jd)
    np.testing.assert_allclose(pt.w, jt.w, rtol=0, atol=1e-12)
    assert _same(pt.y, jt.y) and _same(pt.ids, jt.ids)
    jn = jtrans.NormalizationTransformer(transform_y=True, dataset=jd)
    pn = ptrans.NormalizationTransformer(transform_y=True, dataset=pd_)
    np.testing.assert_allclose(pn.y_means, jn.y_means, rtol=0, atol=1e-12)
    np.testing.assert_allclose(pn.y_stds, jn.y_stds, rtol=0, atol=1e-12)
    np.testing.assert_allclose(pn.transform(pd_).y, jn.transform(jd).y,
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize('batch_size,pad', [(4, True), (6, False),
                                            (None, False)])
def test_disk_iterbatches_in_order(tmp_path, batch_size, pad):
    jd, pd_ = _disk_pair(tmp_path)
    want = list(jd.iterbatches(batch_size, deterministic=True,
                               pad_batches=pad))
    got = list(pd_.iterbatches(batch_size, deterministic=True,
                               pad_batches=pad))
    assert len(want) == len(got)
    assert all(_same(a, b) for bw, bg in zip(want, got)
               for a, b in zip(bw, bg))
    if batch_size is not None:        # as a NumpyDataset of its arrays
        flat = list(pdata.NumpyDataset(pd_.X, pd_.y, pd_.w, pd_.ids)
                    .iterbatches(batch_size, deterministic=True,
                                 pad_batches=pad))
        assert all(_same(a, b) for bf, bg in zip(flat, got)
                   for a, b in zip(bf, bg))


def test_disk_iterbatches_shuffled_under_seeded_streams(tmp_path):
    jd, pd_ = _disk_pair(tmp_path)
    random.seed(11)
    np.random.seed(12)
    want = list(jd.iterbatches(4, epochs=2))
    got = list(pd_.iterbatches(4, epochs=2, rng=np.random.RandomState(12),
                               shard_rng=random.Random(11)))
    assert len(want) == len(got)
    assert all(_same(a, b) for bw, bg in zip(want, got)
               for a, b in zip(bw, bg))
    # the global streams, as the JAX package, when none is given
    random.seed(11)
    np.random.seed(12)
    again = list(pd_.iterbatches(4, epochs=2))
    assert all(_same(a, b) for bw, bg in zip(want, again)
               for a, b in zip(bw, bg))


def test_disk_iterbatches_abandoned_stops_its_thread(tmp_path):
    _, pd_ = _disk_pair(tmp_path)
    before = threading.active_count()
    it = pd_.iterbatches(1, deterministic=True)
    next(it)
    it.close()
    assert threading.active_count() == before


def test_disk_shuffles_match(tmp_path):
    jd, pd_ = _disk_pair(tmp_path)
    np.random.seed(5)
    jc = jd.complete_shuffle(str(tmp_path / 'jc'))
    pc = pd_.complete_shuffle(str(tmp_path / 'pc'),
                              rng=np.random.RandomState(5))
    assert _same_dataset(jc, pc)
    random.seed(6)
    jd.shuffle_shards()
    pd_.shuffle_shards(rng=random.Random(6))
    assert _same_dataset(jd, pd_)
    np.random.seed(7)
    jd.shuffle_each_shard()
    pd_.shuffle_each_shard(rng=np.random.RandomState(7))
    assert _same_dataset(jd, pd_)
    assert _same_dataset(jd, pdata.DiskDataset(pd_.data_dir))


def test_disk_memory_cache(tmp_path):
    _, pd_ = _disk_pair(tmp_path)
    first = pd_.get_shard(0)
    assert pd_.get_shard(0) is first                 # served from the cache
    per_shard = pd_._shard_nbytes(first)
    pd_.memory_cache_size = 2 * per_shard
    for i in range(5):
        pd_.get_shard(i)
    assert pd_._cache_order == [3, 4]
    assert pd_._cache_used <= pd_.memory_cache_size
    pd_.memory_cache_size = 0
    assert pd_._cache_used == 0 and not pd_._cache
    assert _same(pd_.get_shard(0)[0], first[0])      # read again
    pd_.set_shard(1, *first)
    assert _same(pd_.get_shard(1)[0], first[0])


def test_save_and_reload_splits(tmp_path):
    X, y, w, ids = _arrays()
    splits = [pdata.DiskDataset.from_numpy(X[s], y[s], w[s], ids[s],
                                           tasks=['a', 'b', 'c'])
              for s in (slice(0, 15), slice(15, 19), slice(19, None))]
    t = ptrans.BalancingTransformer(dataset=splits[0])
    pdu.save_dataset_to_disk(str(tmp_path / 'cache'), *splits, [t])
    found, loaded, transformers = pdu.load_dataset_from_disk(
        str(tmp_path / 'cache'))
    assert found and len(loaded) == 3
    assert all(_same_dataset(a, b) for a, b in zip(splits, loaded))
    assert transformers[0].weights == t.weights
    assert pdu.load_dataset_from_disk(str(tmp_path / 'absent')) == \
        (False, None, [])


def test_a_folder_of_jax_shards_is_refused(tmp_path):
    jd, _ = _disk_pair(tmp_path)
    with pytest.raises(ValueError, match=str(tmp_path / 'jax')):
        pdata.DiskDataset(jd.data_dir)


def test_databag_and_feature_helpers():
    X, y, w, ids = _arrays()
    bags = []
    for mod in (jdata, pdata):
        bag = mod.Databag({'a': mod.NumpyDataset(X, y, w, ids)})
        bag.add_dataset('b', mod.NumpyDataset(X * 2, y, w, ids))
        bags.append(list(bag.iterbatches(batch_size=6)))
    assert len(bags[0]) == len(bags[1]) == 4
    for bj, bp in zip(*bags):
        assert list(bj) == list(bp)
        assert all(_same(bj[k], bp[k]) for k in bj)
    dense = (X > 0).astype(np.float64)
    sj, sp = jdata.sparsify_features(dense), pdata.sparsify_features(dense)
    assert _same(sj, sp)
    assert _same(jdata.densify_features(sj, 4),
                 pdata.densify_features(sp, 4))
    assert _same(jdata.pad_features(30, X), pdata.pad_features(30, X))


@pytest.mark.parametrize('batch_size', [None, 5])
def test_make_pytorch_dataset_matches(tmp_path, batch_size):
    jd, pd_ = _disk_pair(tmp_path)
    want = list(jd.make_pytorch_dataset(epochs=2, deterministic=True,
                                        batch_size=batch_size))
    got = list(pd_.make_pytorch_dataset(epochs=2, deterministic=True,
                                        batch_size=batch_size))
    assert isinstance(make_pytorch_dataset(pd_),
                      torch.utils.data.IterableDataset)
    assert len(want) == len(got) > 0
    assert all(_same(a, b) for bw, bg in zip(want, got)
               for a, b in zip(bw, bg))
    # two loader workers take alternate samples and together all of them
    loader = torch.utils.data.DataLoader(
        make_pytorch_dataset(pdata.NumpyDataset(pd_.X, pd_.y, pd_.w),
                             deterministic=True),
        num_workers=2, batch_size=None, collate_fn=lambda b: b)
    seen = sorted(round(float(x[0]), 12) for x, _, _, _ in loader)
    assert seen == sorted(round(float(v), 12) for v in pd_.X[:, 0])


# -- loaders ------------------------------------------------------------------

def _write_csv(path, n=40, seed=0, numeric_ids=False):
    """A Tox21-shaped CSV: SMILES (some that do not parse), two task
    columns with empty cells, NA tokens, words and a quoted comma in the
    name, then ids."""
    rng = np.random.RandomState(seed)
    lines = ['smiles,NR-AR,"SR, p53",mol_id']
    for i in range(n):
        cells = [rng.choice(['0', '1', '0.0', '1.5', 'x'] + NA_CELLS)
                 for _ in range(2)]
        mol_id = str(1000 + i) if numeric_ids else f'"TOX,{i}"'
        lines.append(f'{SMILES[i % len(SMILES)]},{cells[0]},{cells[1]},'
                     f'{mol_id}')
    text = '\n'.join(lines) + '\n'
    if str(path).endswith('.gz'):
        with gzip.open(path, 'wt') as f:
            f.write(text)
    else:
        path.write_text(text)
    return str(path)


@pytest.mark.parametrize('name,shard_size,numeric_ids,n_jobs', [
    ('t.csv', 7, False, 1), ('t.csv.gz', None, True, 1),
    ('t.csv.gz', 8192, False, 2)])
def test_csv_loader_matches(tmp_path, name, shard_size, numeric_ids,
                            n_jobs):
    n = 80 if n_jobs > 1 else 40       # the pool takes 65 datapoints or more
    path = _write_csv(tmp_path / name, n=n, numeric_ids=numeric_ids)
    tasks = ['NR-AR', 'SR, p53']
    runs = [Loader(tasks, feat_mod.ConvMolFeaturizer(),
                   feature_field='smiles', id_field='mol_id',
                   n_jobs=n_jobs).create_dataset(
        path, data_dir=str(tmp_path / tag), shard_size=shard_size)
        for tag, Loader, feat_mod in (('j', jdata.CSVLoader, jfeat),
                                      ('p', pdata.CSVLoader, pfeat))]
    jd, pd_ = runs
    assert pd_.get_number_shards() == jd.get_number_shards()
    assert len(pd_) == n - n // len(SMILES) - (n % len(SMILES) > 3)
    assert _same_dataset(jd, pd_) and list(pd_.tasks) == tasks
    assert (pd_.w == 0).any() and (pd_.w == 1).any()


def test_csv_loader_fingerprints_and_default_ids(tmp_path):
    path = _write_csv(tmp_path / 't.csv', n=30, seed=1)
    jd = jdata.CSVLoader(['NR-AR'], jfeat.CircularFingerprint(size=64),
                         feature_field='smiles', n_jobs=1).create_dataset(
        path, shard_size=7)
    pd_ = pdata.CSVLoader(['NR-AR'], pfeat.CircularFingerprint(size=64),
                          feature_field='smiles', n_jobs=1).create_dataset(
        path, shard_size=7)
    assert pd_.X.dtype != object and _same_dataset(jd, pd_)


def test_csv_columns_typed_as_pandas_types_them(tmp_path):
    import pandas as pd
    cells = {'ints': ['1', '-2', '30'], 'floats': ['1', 'NA', '2.5'],
             'bools': ['True', 'false', 'TRUE'],
             'words': ['a', '', 'b,c'], 'empty': ['', 'NA', 'nan']}
    rows = [','.join(f'"{cells[k][i]}"' if ',' in cells[k][i]
                     else cells[k][i] for k in cells) for i in range(3)]
    (tmp_path / 'c.csv').write_text(','.join(cells) + '\n'
                                    + '\n'.join(rows) + '\n')
    df = pd.read_csv(tmp_path / 'c.csv')
    table = next(pdu.load_csv_files([str(tmp_path / 'c.csv')]))
    for k in cells:
        want = df[k].to_numpy()
        if want.dtype.kind not in 'iufb':
            want = np.asarray(want, dtype=object)
        assert _same(want, table[k]), k
        np.testing.assert_array_equal(
            pd.to_numeric(df[k], errors='coerce').to_numpy(dtype=float),
            pdu.to_numeric(table[k]))


def test_user_csv_loader_matches(tmp_path):
    rng = np.random.RandomState(2)
    lines = ['f1,f2,label,name'] + [
        f'{rng.normal():.6f},{rng.normal():.6f},{rng.randint(2)},n{i}'
        for i in range(12)]
    (tmp_path / 'u.csv').write_text('\n'.join(lines) + '\n')
    jd = jdata.UserCSVLoader(['label'], jfeat.UserDefinedFeaturizer(
        ['f1', 'f2']), id_field='name').create_dataset(
        str(tmp_path / 'u.csv'), shard_size=5)
    pd_ = pdata.UserCSVLoader(['label'], pfeat.base.UserDefinedFeaturizer(
        ['f1', 'f2']), id_field='name').create_dataset(
        str(tmp_path / 'u.csv'), shard_size=5)
    assert _same_dataset(jd, pd_)


def test_json_loader_matches(tmp_path):
    rng = np.random.RandomState(3)
    with open(tmp_path / 'r.jsonl', 'w') as f:
        for i in range(20):
            rec = {'smiles': SMILES[i % len(SMILES)], 'idx': i * 10}
            if i % 4:
                rec['y'] = float(rng.randint(2)) if i % 5 else 'bad'
            f.write(json.dumps(rec) + '\n')
    for id_field in ('idx', None):
        jd = jdata.JsonLoader(['y'], jfeat.ConvMolFeaturizer(), 'smiles',
                              id_field=id_field).create_dataset(
            str(tmp_path / 'r.jsonl'), shard_size=6)
        pd_ = pdata.JsonLoader(['y'], pfeat.ConvMolFeaturizer(), 'smiles',
                               id_field=id_field).create_dataset(
            str(tmp_path / 'r.jsonl'), shard_size=6)
        assert _same_dataset(jd, pd_), id_field


def test_sdf_loader_matches(tmp_path):
    from deepchem_tpu_torch.chem import mol_from_smiles
    from deepchem_tpu_torch.chem.sdf import mol_to_molblock
    blocks = []
    for i, s in enumerate(['CCO', 'c1ccccc1O', 'CC(=O)O', 'CCN', 'C1CC1']):
        props = f'> <logP>\n{0.5 * i}\n\n' if i != 2 else \
            '> <logP>\nn/a\n\n'
        blocks.append(mol_to_molblock(mol_from_smiles(s)) + '\n' + props
                      + '$$$$\n')
    (tmp_path / 'm.sdf').write_text(''.join(blocks))
    jd = jdata.SDFLoader(['logP'], jfeat.CircularFingerprint(
        size=32)).create_dataset(str(tmp_path / 'm.sdf'), shard_size=2)
    pd_ = pdata.SDFLoader(['logP'], pfeat.CircularFingerprint(
        size=32)).create_dataset(str(tmp_path / 'm.sdf'), shard_size=2)
    assert _same_dataset(jd, pd_) and pd_.w[2, 0] == 0


def test_sequence_loaders_match(tmp_path):
    (tmp_path / 's.fasta').write_text(
        '>seq1 first\nACGT\nNNAC\n>seq2\nGGTTA\n\n>seq3\nacgtx\n')
    (tmp_path / 's.fastq').write_text(
        '@r1\nACGTN\n+\nIIIII\n@r2\nGG\n+\nII\n')
    for J, P, name in ((jdata.FASTALoader, pdata.FASTALoader, 's.fasta'),
                       (jdata.FASTQLoader, pdata.FASTQLoader, 's.fastq')):
        jd = J().create_dataset(str(tmp_path / name))
        pd_ = P().create_dataset(str(tmp_path / name))
        assert _same_dataset(jd, pd_) and list(jd.tasks) == list(pd_.tasks)


def test_in_memory_loader_matches():
    rows = [('CCO', [1.0], [1.0], 'a'), ('bad', [0.0], [1.0], 'b'),
            ('c1ccccc1', [0.0], [0.5], 'c'), 'CN']
    jd = jdata.InMemoryLoader(['t'], jfeat.CircularFingerprint(
        size=16)).create_dataset(rows, shard_size=2)
    pd_ = pdata.InMemoryLoader(['t'], pfeat.CircularFingerprint(
        size=16)).create_dataset(rows, shard_size=2)
    assert _same_dataset(jd, pd_)


def test_loader_timings_are_recorded(tmp_path):
    path = _write_csv(tmp_path / 't.csv', n=20)
    loader = pdata.CSVLoader(['NR-AR'], pfeat.ConvMolFeaturizer(),
                             feature_field='smiles', n_jobs=1)
    loader.create_dataset(path, shard_size=7)
    assert set(loader.seconds) == {'read', 'featurize', 'write'}
    assert all(v > 0 for v in loader.seconds.values())


def test_jax_data_utils_csv_reader_agrees(tmp_path):
    path = _write_csv(tmp_path / 'c.csv', n=15, seed=4)
    frames = list(jdu.load_csv_files([path], shard_size=4))
    tables = list(pdu.load_csv_files([path], shard_size=4))
    assert len(frames) == len(tables) == 4
    for df, table in zip(frames, tables):
        assert list(df.columns) == table.columns
        assert _same(np.asarray(df['mol_id'].to_numpy(), dtype=object),
                     table['mol_id'])
        np.testing.assert_array_equal(df.index.to_numpy(), table.index)


def test_dataframe_and_metadata_methods_match(tmp_path):
    jd, pd_ = _disk_pair(tmp_path)
    df = jdata.NumpyDataset(jd.X, jd.y, jd.w, jd.ids).to_dataframe()
    assert _same_dataset(jdata.NumpyDataset.from_dataframe(df),
                         pdata.NumpyDataset.from_dataframe(df))
    tasks, table = pd_.load_metadata()
    jtasks, frame = jd.load_metadata()
    assert tasks == jtasks
    assert list(table['rows']) == list(frame['rows']) == [5, 5, 5, 5, 3]
    for a, b in ((jd.get_label_means(), pd_.get_label_means()),
                 (jd.get_label_stds(), pd_.get_label_stds())):
        assert len(a) == len(b) == 5
        for x, z in zip(a, b):
            np.testing.assert_allclose(z, x, rtol=0, atol=1e-12)
