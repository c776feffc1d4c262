"""The port's MoleculeNet loaders, benchmark harness and searches against
the JAX package's, on the CPU.

``load_tox21`` (ConvMol graphs, random split seeded 123, balancing) and
``load_delaney`` (fingerprints, scaffold split, normalization) on CSVs
written here into a temporary data dir, through both packages: the same
cache folder names, split sizes, X, y, w and ids, transformer
statistics within 1e-12, and ``reload=True`` returning the cached
splits.  The grid and random searches on a stub model builder: the same
parameter sets, filenames and best parameters.  ``run_benchmark`` on the
CPU at 1 epoch.  Then the port's data layer imported and run with jax,
the JAX package, pandas, scikit-learn, joblib and PIL blocked.
"""

import gzip
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import deepchem_tpu.hyper as jhyper
import deepchem_tpu.molnet as jmolnet
import deepchem_tpu_torch.hyper as phyper
import deepchem_tpu_torch.molnet as pmolnet
from deepchem_tpu_torch.data import DiskDataset
from deepchem_tpu_torch.molnet import run_benchmark as prb

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMILES = ['CC(=O)Oc1ccccc1C(=O)O', 'CN1C=NC2=C1C(=O)N(C(=O)N2C)C',
          'CC(C)Cc1ccc(cc1)C(C)C(=O)O', 'CC(=O)Nc1ccc(O)cc1',
          'CN1CCCC1c1cccnc1', 'CN(C)C(=N)NC(=N)N', 'Oc1ccc(cc1)[N+](=O)[O-]',
          'CCCCCCCCCc1ccc(O)cc1', 'OC(=O)CNCP(=O)(O)O', 'CCO',
          'c1ccc2[nH]ccc2c1', 'O=C1NC(=O)C(N1)(c1ccccc1)c1ccccc1',
          'ClC(Cl)(Cl)C(c1ccc(Cl)cc1)c1ccc(Cl)cc1', 'C1CCCCC1']
BAD = ['not_a_smiles', 'C1CC']
TOX21_ROWS = 70        # 68 that parse: the loader's pool takes 65 or more


def write_tox21(data_dir, rows=TOX21_ROWS, seed=0):
    """A Tox21-shaped ``tox21.csv.gz``: the 12 task columns with seeded
    0/1 labels, about 20 % of cells empty and a few written NA, then
    ``mol_id`` and ``smiles``; two rows whose SMILES do not parse."""
    rng = np.random.RandomState(seed)
    tasks = pmolnet.load_function.TOX21_TASKS
    lines = [','.join(tasks + ['mol_id', 'smiles'])]
    for i in range(rows):
        smi = BAD[i // 31] if i % 31 == 30 else SMILES[i % len(SMILES)]
        cells = []
        for _ in tasks:
            r = rng.uniform()
            cells.append('' if r < 0.2 else 'NA' if r < 0.23
                         else str(rng.randint(2)))
        lines.append(','.join(cells + [f'TOX{3000 + i}', smi]))
    with gzip.open(os.path.join(data_dir, 'tox21.csv.gz'), 'wt') as f:
        f.write('\n'.join(lines) + '\n')


def write_delaney(data_dir, rows=40, seed=1):
    rng = np.random.RandomState(seed)
    lines = ['Compound ID,measured log solubility in mols per litre,smiles']
    for i in range(rows):
        lines.append(f'"cmpd, {i}",{rng.normal():.4f},'
                     f'{SMILES[(3 * i) % len(SMILES)]}')
    with open(os.path.join(data_dir, 'delaney-processed.csv'), 'w') as f:
        f.write('\n'.join(lines) + '\n')


def _folders(root):
    return sorted(os.path.relpath(d, root) for d, _, files in os.walk(root)
                  if 'transformers.pkl' in files)


def _same_split(a, b):
    assert len(a) == len(b)
    Xa, Xb = a.X, b.X
    for ga, gb in zip(Xa, Xb):
        if hasattr(ga, 'node_features'):
            np.testing.assert_array_equal(ga.node_features, gb.node_features)
            np.testing.assert_array_equal(ga.edge_index, gb.edge_index)
        else:
            np.testing.assert_array_equal(ga, gb)
    for k in ('y', 'w'):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert list(a.ids) == list(b.ids)
    assert [type(i) for i in a.ids] == [type(i) for i in b.ids]
    assert list(a.get_task_names()) == list(b.get_task_names())


@pytest.fixture(scope='module')
def loaded(tmp_path_factory):
    """Both packages' load_tox21 and load_delaney on the same files."""
    data = tmp_path_factory.mktemp('data')
    write_tox21(str(data))
    write_delaney(str(data))
    out = {}
    for tag, mod in (('jax', jmolnet), ('port', pmolnet)):
        save = str(tmp_path_factory.mktemp(f'save_{tag}'))
        out[tag] = {
            'save': save,
            'tox21': mod.load_tox21(featurizer='graphconv',
                                    splitter='random', splitter_seed=123,
                                    reload=False, data_dir=str(data),
                                    save_dir=save),
            'delaney': mod.load_delaney(featurizer='ECFP',
                                        splitter='scaffold', reload=False,
                                        data_dir=str(data), save_dir=save)}
    out['data'] = str(data)
    return out


def test_cache_folders_are_named_alike(loaded):
    want = _folders(loaded['jax']['save'])
    assert want == _folders(loaded['port']['save'])
    assert os.path.join('tox21-featurized', 'convmolfeaturizer',
                        'randomsplitter-seed123', 'balancing') in want
    assert os.path.join('delaney-featurized', 'circularfingerprint',
                        'scaffoldsplitter',
                        'normalization_transform_y_True') in want


@pytest.mark.parametrize('name', ['tox21', 'delaney'])
def test_splits_and_transformers_match(loaded, name):
    jt, (jtr, jva, jte), jtrans = loaded['jax'][name]
    pt, (ptr, pva, pte), ptrans = loaded['port'][name]
    assert list(jt) == list(pt)
    for a, b in ((jtr, ptr), (jva, pva), (jte, pte)):
        assert isinstance(b, DiskDataset)
        _same_split(a, b)
    assert [len(ptr), len(pva), len(pte)] == [len(jtr), len(jva), len(jte)]
    assert len(jtrans) == len(ptrans) == 1
    if name == 'tox21':
        assert sum(map(len, (ptr, pva, pte))) == TOX21_ROWS - 2
        for wj, wp in zip(jtrans[0].weights, ptrans[0].weights):
            assert wj.keys() == wp.keys()
            np.testing.assert_allclose([wp[k] for k in wj],
                                       [wj[k] for k in wj], rtol=0,
                                       atol=1e-12)
        # w is 0 exactly where the cell was empty or NA: the file's rows
        # that parse, in the order of the seeded split
        with gzip.open(os.path.join(loaded['data'], 'tox21.csv.gz'),
                       'rt') as f:
            rows = [ln.split(',') for ln in f.read().splitlines()[1:]]
        cells = np.array([r[:12] for r in rows if r[-1] not in BAD])
        perm = np.random.RandomState(123).permutation(len(cells))
        w = np.concatenate([d.w for d in (ptr, pva, pte)])
        np.testing.assert_array_equal(
            w == 0, np.isin(cells[perm], ['', 'NA']))
        y = np.concatenate([d.y for d in (ptr, pva, pte)])
        assert set(np.unique(y)) <= {0.0, 1.0}
    else:
        np.testing.assert_allclose(ptrans[0].y_means, jtrans[0].y_means,
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(ptrans[0].y_stds, jtrans[0].y_stds,
                                   rtol=0, atol=1e-12)


def test_reload_returns_the_cached_splits(loaded):
    _, first, _ = loaded['port']['tox21']
    tasks, again, transformers = pmolnet.load_tox21(
        featurizer='graphconv', splitter='random', splitter_seed=123,
        reload=True, data_dir=loaded['data'],
        save_dir=loaded['port']['save'])
    assert list(tasks) == list(pmolnet.load_function.TOX21_TASKS)
    for a, b in zip(first, again):
        assert b.data_dir == a.data_dir
        _same_split(a, b)
    assert transformers[0].weights == loaded['port']['tox21'][2][0].weights


def test_a_cache_of_jax_shards_raises_naming_its_folder(loaded):
    folder = os.path.join(loaded['jax']['save'], 'tox21-featurized',
                          'convmolfeaturizer', 'randomsplitter-seed123',
                          'balancing')
    for reload in (True, False):
        with pytest.raises(ValueError, match=folder):
            pmolnet.load_tox21(featurizer='graphconv', splitter='random',
                               splitter_seed=123, reload=reload,
                               data_dir=loaded['data'],
                               save_dir=loaded['jax']['save'])


def test_presets_not_ported_raise(loaded):
    for name in ('maccs', 'rdkit-descriptors'):
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            pmolnet.load_tox21(featurizer=name, data_dir=loaded['data'],
                               save_dir=loaded['port']['save'])
    assert set(pmolnet.featurizers) == set(jmolnet.featurizers)
    assert set(pmolnet.splitters) == set(jmolnet.splitters)
    assert {k: t.get_directory_name()
            for k, t in pmolnet.transformers.items()} == \
        {k: t.get_directory_name() for k, t in jmolnet.transformers.items()}
    assert pmolnet.CheckFeaturizer == jmolnet.CheckFeaturizer
    assert pmolnet.CheckSplit == jmolnet.CheckSplit


class _Stub:
    """A model whose score is a fixed function of its parameters."""

    def __init__(self, **params):
        self.params = params
        self.fitted = 0

    def fit(self, dataset, nb_epoch=10):
        self.fitted += nb_epoch

    def evaluate(self, dataset, metrics, transformers=()):
        p = self.params
        score = -(np.log10(p['learning_rate']) + 3) ** 2 \
            + 0.01 * len(p.get('layers', ())) + 0.001 * p.get('dropout', 0)
        return {metrics[0].name: score}


class _Metric:
    name = 'score'


def test_grid_search_matches():
    params = {'learning_rate': [1e-4, 1e-3, 1e-2], 'layers': [(64,),
                                                              (64, 64)],
              'dropout': 0.5}
    want = jhyper.GridHyperparamOpt(_Stub).hyperparam_search(
        params, None, None, _Metric(), nb_epoch=2)
    got = phyper.GridHyperparamOpt(_Stub).hyperparam_search(
        params, None, None, _Metric(), nb_epoch=2)
    assert want[1] == got[1] and want[2] == got[2]
    assert got[0].params == got[1] and got[0].fitted == 2
    low = phyper.GridHyperparamOpt(_Stub).hyperparam_search(
        params, None, None, _Metric(), use_max=False)
    assert low[1] == jhyper.GridHyperparamOpt(_Stub).hyperparam_search(
        params, None, None, _Metric(), use_max=False)[1]


def test_random_search_matches(tmp_path):
    params = {'learning_rate': [1e-4, 1e-3, 1e-2, 1e-1],
              'dropout': lambda rng: float(rng.uniform()),
              'layers': [(8,), (8, 8), (8, 8, 8)]}
    want = jhyper.RandomHyperparamOpt(_Stub, max_iter=6).hyperparam_search(
        params, None, None, _Metric(), seed=7)
    got = phyper.RandomHyperparamOpt(_Stub, max_iter=6).hyperparam_search(
        params, None, None, _Metric(), seed=7)
    assert want[1] == got[1] and want[2] == got[2]
    got = phyper.RandomHyperparamOpt(_Stub, max_iter=2).hyperparam_search(
        params, None, None, _Metric(), seed=7, logdir=str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == sorted(got[2])
    assert got[0].params['model_dir'].startswith(str(tmp_path))
    drawn = phyper.RandomHyperparamOpt.generate_random_hyperparam_values(
        {'a': [1, 2], 'b': 3}, 4)
    assert len(drawn) == 4 and all(d['b'] == 3 and d['a'] in (1, 2)
                                   for d in drawn)


def test_hyperparam_filenames_match():
    from deepchem_tpu.hyper.base import \
        _convert_hyperparam_dict_to_filename as jname
    from deepchem_tpu_torch.hyper.base import \
        _convert_hyperparam_dict_to_filename as pname
    params = {'b': 0.5, 'a': [1, 2], 'c': np.mean, 'd': object(), 'e': 'x'}
    assert jname(params) == pname(params)


def test_run_benchmark_on_the_cpu(loaded, tmp_path):
    rows = prb.run_benchmark(
        ['tox21'], 'graphconv', hyper_parameters={'nb_epoch': 1},
        out_path=str(tmp_path), device='cpu', data_dir=loaded['data'],
        save_dir=loaded['port']['save'])
    assert len(rows) == 1
    row = rows[0]
    assert list(row) == ['dataset', 'mode', 'model', 'split', 'train_score',
                         'valid_score', 'time', 'load_s', 'fit_s', 'eval_s']
    assert (row['dataset'], row['mode'], row['model'], row['split']) == \
        ('tox21', 'classification', 'graphconv', 'random')
    assert 0 <= row['train_score'] <= 1 and 0 <= row['valid_score'] <= 1
    lines = (tmp_path / 'results.csv').read_text().splitlines()
    assert len(lines) == 2 and lines[0].startswith('dataset,mode')
    _, (tr, va, te), _ = loaded['port']['tox21']
    assert [len(tr), len(va), len(te)] == [54, 7, 7]
    with pytest.raises(NotImplementedError, match='scikit-learn'):
        prb.run_benchmark(['tox21'], 'logreg', device='cpu',
                          out_path=str(tmp_path), data_dir=loaded['data'],
                          save_dir=loaded['port']['save'])


BLOCKED_IMPORT = textwrap.dedent('''
    import importlib.abc, sys
    BLOCK = ('jax', 'jaxlib', 'flax', 'optax', 'deepchem_tpu', 'pandas',
             'sklearn', 'joblib', 'PIL')

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split('.')[0] in BLOCK:
                raise ImportError(f'{name} is blocked')
    sys.meta_path.insert(0, Block())
    sys.path.insert(0, sys.argv[1])
    import deepchem_tpu_torch.chem, deepchem_tpu_torch.data
    import deepchem_tpu_torch.hyper, deepchem_tpu_torch.splits
    import deepchem_tpu_torch.molnet, deepchem_tpu_torch.molnet.run_benchmark
    import deepchem_tpu_torch.utils.data_utils
    tasks, (tr, va, te), ts = deepchem_tpu_torch.molnet.load_tox21(
        featurizer='graphconv', splitter='random', splitter_seed=123,
        data_dir=sys.argv[2], save_dir=sys.argv[2])
    assert len(tasks) == 12 and len(tr) + len(va) + len(te) == 68
    assert not any(m.split('.')[0] in BLOCK for m in sys.modules)
    print('loaded', len(tr), len(va), len(te))
''')


def test_the_data_layer_needs_none_of_jax_pandas_sklearn_joblib_pil(
        tmp_path):
    write_tox21(str(tmp_path))
    out = subprocess.run(
        [sys.executable, '-c', BLOCKED_IMPORT, REPO, str(tmp_path)],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert 'loaded 54 7 7' in out.stdout
