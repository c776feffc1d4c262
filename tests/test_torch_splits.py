"""The port's splitters, canonical SMILES and scaffolds against the JAX
package's, on the CPU.

Every splitter's indices at the same seed (the JAX package seeds numpy's
global stream; the port draws from its own ``RandomState(seed)`` and
leaves the global stream alone), ``k_fold_split``, the task splits, and
``mol_to_smiles`` and ``scaffold_smiles`` string for string, on about 60
SMILES written here (drug-like rings, salts, stereo centres and double
bonds, acyclic molecules and one that does not parse).
"""

import numpy as np
import pytest
import torch

import deepchem_tpu.chem as jchem
import deepchem_tpu.data as jdata
import deepchem_tpu.splits as jsplits
import deepchem_tpu_torch.chem as pchem
import deepchem_tpu_torch.data as pdata
import deepchem_tpu_torch.splits as psplits

torch.set_num_threads(1)

SMILES = [
    'CC(=O)Oc1ccccc1C(=O)O', 'CN1C=NC2=C1C(=O)N(C(=O)N2C)C',
    'CC(C)Cc1ccc(cc1)C(C)C(=O)O', 'CC(=O)Nc1ccc(O)cc1',
    'COc1ccc2cc(ccc2c1)C(C)C(=O)O', 'OC(=O)Cc1ccccc1Nc1c(Cl)cccc1Cl',
    'CN1C(=O)CN=C(c2ccccc2)c2cc(Cl)ccc21', 'CN1CCCC1c1cccnc1',
    'CN(C)C(=N)NC(=N)N', 'CC(=O)CC(c1ccccc1)c1c(O)c2ccccc2oc1=O',
    'CC12CCC3C(CCC4=CC(=O)CCC34C)C1CCC2O',
    'CC12CCC3c4ccc(O)cc4CCC3C1CCC2O', 'CC(C)(c1ccc(O)cc1)c1ccc(O)cc1',
    'Oc1cc(Cl)ccc1Oc1ccc(Cl)cc1Cl', 'CCNc1nc(Cl)nc(NC(C)C)n1',
    'ClC(Cl)(Cl)C(c1ccc(Cl)cc1)c1ccc(Cl)cc1',
    'CCC1(C(=O)NC(=O)NC1=O)c1ccccc1', 'CCN(CC)CC(=O)Nc1c(C)cccc1C',
    'CC(C)NCC(O)COc1cccc2ccccc12', 'CNCCC(Oc1ccc(cc1)C(F)(F)F)c1ccccc1',
    'CNC1CCC(c2ccc(Cl)c(Cl)c2)c2ccccc12',
    'CCC(=C(c1ccccc1)c1ccc(OCCN(C)C)cc1)c1ccccc1',
    'CN(C)CCCN1c2ccccc2Sc2ccc(Cl)cc21',
    'OC1(CCN(CCCC(=O)c2ccc(F)cc2)CC1)c1ccc(Cl)cc1',
    'COc1ccc2[nH]c(nc2c1)S(=O)Cc1ncc(C)c(OC)c1C',
    'OC(=O)c1cn(C2CC2)c2cc(N3CCNCC3)c(F)cc2c1=O',
    'Cc1cc(NS(=O)(=O)c2ccc(N)cc2)no1', 'COc1cc(Cc2cnc(N)nc2N)cc(OC)c1OC',
    'CC1(C)SC2C(NC(=O)C(N)c3ccc(O)cc3)C(=O)N2C1C(=O)O',
    'CCCCc1nc(Cl)c(CO)n1Cc1ccc(cc1)-c1ccccc1-c1nn[nH]n1',
    'c1ccc2c(c1)cc1ccc3cccc4ccc2c1c34', 'Oc1ccc(cc1)[N+](=O)[O-]',
    'Oc1ccc(cc1)-c1coc2cc(O)cc(O)c2c1=O',
    'CC(C)C(=O)Nc1ccc(c(c1)C(F)(F)F)[N+](=O)[O-]',
    'CC1(OC(=O)N(C1=O)c1cc(Cl)cc(Cl)c1)C=C',
    'COc1ccc(cc1)C(c1ccc(OC)cc1)C(Cl)(Cl)Cl', 'CCCCCCCCCc1ccc(O)cc1',
    'CCCCOC(=O)c1ccccc1C(=O)OCCCC', 'NC(=O)N1c2ccccc2C=Cc2ccccc21',
    'OC(=O)CNCP(=O)(O)O', 'Oc1c(Cl)c(Cl)c(Cl)c(Cl)c1Cl',
    'O=C1NC(=O)C(N1)(c1ccccc1)c1ccccc1',
    'C[C@H](N)C(=O)O', 'N[C@@H](Cc1ccccc1)C(=O)O', 'F/C=C/F',
    'C/C=C\\C(=O)O', 'c1ccccc1CC[NH3+].[Cl-]', '[Na+].[O-]C(=O)c1ccccc1',
    'CCO', 'CCCC', 'OCC(O)CO', 'C1CCCCC1', 'c1ccncc1', 'C1CC1C1CC1',
    'O=C(O)c1ccccc1O', 'CC(C)(C)c1ccc(O)cc1', 'not_a_smiles',
    'C[C@@]12CC[C@H]3[C@@H](CC=C4C[C@@H](O)CC[C@]34C)[C@@H]1CC[C@@H]2O',
    'c1ccc2[nH]ccc2c1', 'C1=CC=CN1', 'CC(=O)OC1=CC=CC=C1C(=O)O']


def _pair(n_tasks=2, seed=0):
    rng = np.random.RandomState(seed)
    n = len(SMILES)
    X = rng.normal(size=(n, 3))
    y = rng.randint(0, 2, (n, n_tasks)).astype(np.float64)
    y[:, 0] = rng.normal(size=n)       # a regression-like first task
    w = (rng.uniform(size=(n, n_tasks)) > 0.1).astype(np.float64)
    ids = np.array(SMILES, dtype=object)
    return (jdata.NumpyDataset(X, y, w, ids),
            pdata.NumpyDataset(X, y, w, ids))


def _equal_splits(a, b):
    assert len(a) == len(b)
    for x, z in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x, dtype=np.int64),
                                      np.asarray(z, dtype=np.int64))


GROUPS = [i % 7 for i in range(len(SMILES))]
SPLITTERS = [
    ('RandomSplitter', (), {}),
    ('IndexSplitter', (), {}),
    ('SpecifiedSplitter', (), {'valid_indices': [3, 1, 40],
                               'test_indices': np.array([59, 2])}),
    ('RandomGroupSplitter', (GROUPS,), {}),
    ('RandomStratifiedSplitter', (), {}),
    ('SingletaskStratifiedSplitter', (), {'task_number': 0}),
    ('MolecularWeightSplitter', (), {}),
    ('ScaffoldSplitter', (), {}),
    ('FingerprintSplitter', (), {}),
    ('ButinaSplitter', (), {'cutoff': 0.6}),
    ('MaxMinSplitter', (), {}),
    ('TimeSplitter', (list(np.random.RandomState(9).permutation(
        len(SMILES))),), {}),
]


@pytest.mark.parametrize('name,args,kwargs', SPLITTERS,
                         ids=[s[0] for s in SPLITTERS])
@pytest.mark.parametrize('seed', [0, 123])
def test_splitter_indices_match(name, args, kwargs, seed):
    jd, pd_ = _pair()
    js = getattr(jsplits, name)(*args, **kwargs)
    ps = getattr(psplits, name)(*args, **kwargs)
    for fracs in ((0.8, 0.1, 0.1), (0.6, 0.3, 0.1)):
        want = js.split(jd, *fracs, seed=seed)
        state = np.random.get_state()[1].copy()
        got = ps.split(pd_, *fracs, seed=seed)
        # the port leaves numpy's global stream where it was
        np.testing.assert_array_equal(np.random.get_state()[1], state)
        _equal_splits(want, got)


@pytest.mark.parametrize('name', ['RandomSplitter', 'ScaffoldSplitter',
                                  'IndexSplitter'])
def test_k_fold_split_matches(name):
    jd, pd_ = _pair()
    want = getattr(jsplits, name)().k_fold_split(jd, 4, seed=5)
    got = getattr(psplits, name)().k_fold_split(pd_, 4, seed=5)
    assert len(want) == len(got) == 4
    for (jt, jc), (pt, pc) in zip(want, got):
        for a, b in ((jt, pt), (jc, pc)):
            np.testing.assert_array_equal(a.X, b.X)
            assert list(a.ids) == list(b.ids)


def test_train_valid_test_split_of_a_disk_dataset(tmp_path):
    jd, pd_ = _pair()
    disk = pdata.DiskDataset.from_numpy(pd_.X, pd_.y, pd_.w, pd_.ids,
                                        data_dir=str(tmp_path / 'd'))
    want = jsplits.RandomSplitter().train_valid_test_split(jd, seed=123)
    got = psplits.RandomSplitter().train_valid_test_split(
        disk, str(tmp_path / 'tr'), str(tmp_path / 'va'),
        str(tmp_path / 'te'), seed=123)
    for a, b in zip(want, got):
        assert isinstance(b, pdata.DiskDataset)
        np.testing.assert_array_equal(a.y, b.y)
        assert list(a.ids) == list(b.ids)
    tr, te = psplits.RandomSplitter().train_test_split(pd_, seed=3)
    jtr, jte = jsplits.RandomSplitter().train_test_split(jd, seed=3)
    assert list(tr.ids) == list(jtr.ids) and list(te.ids) == list(jte.ids)


def test_task_splitter_and_merge_fold_datasets():
    jd, pd_ = _pair(n_tasks=5)
    want = jsplits.TaskSplitter().train_valid_test_split(jd, 0.6, 0.2, 0.2)
    got = psplits.TaskSplitter().train_valid_test_split(pd_, 0.6, 0.2, 0.2)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a.y, b.y)
        np.testing.assert_array_equal(a.w, b.w)
    jf = jsplits.TaskSplitter().k_fold_split(jd, 2)
    pf = psplits.TaskSplitter().k_fold_split(pd_, 2)
    for a, b in zip(jf, pf):
        np.testing.assert_array_equal(a.y, b.y)
    merged = psplits.merge_fold_datasets(pf)
    np.testing.assert_array_equal(merged.y, jsplits.merge_fold_datasets(
        jf).y)
    np.testing.assert_array_equal(merged.y, pd_.y)


def test_butina_clusters_match():
    fps = np.random.RandomState(4).uniform(size=(40, 64)) > 0.7
    assert jsplits.butina_cluster(fps, 0.3) == psplits.butina_cluster(
        fps, 0.3)


@pytest.mark.parametrize('include_chirality', [False, True])
def test_canonical_smiles_and_scaffolds_match(include_chirality):
    for s in SMILES:
        jm, pm = jchem.mol_from_smiles(s), pchem.mol_from_smiles(s)
        assert (jm is None) == (pm is None)
        if jm is not None:
            assert jchem.mol_to_smiles(jm) == pchem.mol_to_smiles(pm), s
            assert jchem.mol_to_smiles(jm, canonical=False) == \
                pchem.mol_to_smiles(pm, canonical=False), s
            assert jchem.canonical_ranks(jm) == pchem.canonical_ranks(pm)
            assert jm.molecular_weight() == pm.molecular_weight(), s
        assert jchem.scaffold_smiles(s, include_chirality) == \
            pchem.scaffold_smiles(s, include_chirality), s
        assert jsplits.generate_scaffold(s) == psplits.generate_scaffold(s)
    # a canonical string reads back to itself
    for s in SMILES[:10] + SMILES[42:48]:
        c = pchem.mol_to_smiles(pchem.mol_from_smiles(s))
        assert pchem.mol_to_smiles(pchem.mol_from_smiles(c)) == c


def test_fractions_that_do_not_sum_to_one_raise():
    _, pd_ = _pair()
    with pytest.raises(ValueError):
        psplits.RandomSplitter().split(pd_, 0.8, 0.3, 0.1)
