"""MoleculeNet load functions.

The port's own copy of ``deepchem_tpu/molnet/load_function.py``'s CSV,
SDF and materials loaders.  Each ``load_<name>(featurizer, splitter,
transformers, reload=True, data_dir=None, save_dir=None, **kwargs)``
returns ``(tasks, (train, valid, test), transformers)``; the data file is
read from ``data_dir`` (the data directory by default) and fetched from
DeepChem's bucket only where it is not there.
"""

from __future__ import annotations

import csv
import json
import os
from typing import List, Optional

import numpy as np

import deepchem_tpu_torch.feat as feat
from deepchem_tpu_torch.data import (CSVLoader, Dataset, DiskDataset,
                                     JsonLoader, NumpyDataset, SDFLoader)
from deepchem_tpu_torch.molnet.loader import (DEEPCHEM_S3, _MolnetLoader,
                                              resolve_splitter)
from deepchem_tpu_torch.trans import NormalizationTransformer
from deepchem_tpu_torch.utils.data_utils import (Table, _open, csv_header,
                                                 download_url, get_data_dir,
                                                 json_column, load_csv_files,
                                                 untargz_file, _MISSING)

TOX21_TASKS = [
    'NR-AR', 'NR-AR-LBD', 'NR-AhR', 'NR-Aromatase', 'NR-ER', 'NR-ER-LBD',
    'NR-PPAR-gamma', 'SR-ARE', 'SR-ATAD5', 'SR-HSE', 'SR-MMP', 'SR-p53']
DELANEY_TASKS = ['measured log solubility in mols per litre']
FREESOLV_TASKS = ['y']
LIPO_TASKS = ['exp']
BACE_CLS_TASKS = ['Class']
BACE_REG_TASKS = ['pIC50']
BBBP_TASKS = ['p_np']
CLINTOX_TASKS = ['FDA_APPROVED', 'CT_TOX']
HIV_TASKS = ['HIV_active']
SIDER_TASKS = [
    'Hepatobiliary disorders', 'Metabolism and nutrition disorders',
    'Product issues', 'Eye disorders', 'Investigations',
    'Musculoskeletal and connective tissue disorders',
    'Gastrointestinal disorders', 'Social circumstances',
    'Immune system disorders', 'Reproductive system and breast disorders',
    'Neoplasms benign, malignant and unspecified (incl cysts and polyps)',
    'General disorders and administration site conditions',
    'Endocrine disorders', 'Surgical and medical procedures',
    'Vascular disorders', 'Blood and lymphatic system disorders',
    'Skin and subcutaneous tissue disorders',
    'Congenital, familial and genetic disorders', 'Infections and '
    'infestations', 'Respiratory, thoracic and mediastinal disorders',
    'Psychiatric disorders', 'Renal and urinary disorders',
    'Pregnancy, puerperium and perinatal conditions',
    'Ear and labyrinth disorders', 'Cardiac disorders',
    'Nervous system disorders', 'Injury, poisoning and procedural '
    'complications']
MUV_TASKS = [
    'MUV-466', 'MUV-548', 'MUV-600', 'MUV-644', 'MUV-652', 'MUV-689',
    'MUV-692', 'MUV-712', 'MUV-713', 'MUV-733', 'MUV-737', 'MUV-810',
    'MUV-832', 'MUV-846', 'MUV-852', 'MUV-858', 'MUV-859']
QM7_TASKS = ['u0_atom']
QM8_TASKS = [
    'E1-CC2', 'E2-CC2', 'f1-CC2', 'f2-CC2', 'E1-PBE0', 'E2-PBE0',
    'f1-PBE0', 'f2-PBE0', 'E1-CAM', 'E2-CAM', 'f1-CAM', 'f2-CAM']
QM9_TASKS = [
    'mu', 'alpha', 'homo', 'lumo', 'gap', 'r2', 'zpve', 'cv', 'u0', 'u298',
    'h298', 'g298']
THERMOSOL_TASKS = ['target']
HPPB_TASKS = ['target']
CLEARANCE_TASKS = ['target']


class _CSVMolnetLoader(_MolnetLoader):
    """A CSV file read by :class:`CSVLoader`."""

    def __init__(self, *args, url: str, filename: str,
                 feature_field: str = 'smiles', **kwargs):
        super().__init__(*args, **kwargs)
        self.url = url
        self.filename = filename
        self.feature_field = feature_field

    def _dataset_file(self) -> str:
        path = os.path.join(self.data_dir, self.filename)
        if not os.path.exists(path):
            download_url(self.url, self.data_dir, self.filename)
        return path

    def create_dataset(self) -> Dataset:
        loader = CSVLoader(tasks=self.tasks, featurizer=self.featurizer,
                           feature_field=self.feature_field)
        return loader.create_dataset(
            self._dataset_file(),
            shard_size=self.args.get('shard_size', 8192))


def _make_csv_load_fn(name: str, tasks: List[str], filename: str,
                      default_transformers: List[str],
                      feature_field: str = 'smiles',
                      url: Optional[str] = None):
    url = url or (DEEPCHEM_S3 + filename)

    def load_fn(featurizer='ECFP', splitter='scaffold', transformers=None,
                reload: bool = True, data_dir: Optional[str] = None,
                save_dir: Optional[str] = None, **kwargs):
        if transformers is None:
            transformers = list(default_transformers)
        loader = _CSVMolnetLoader(
            featurizer, splitter, transformers, tasks, data_dir, save_dir,
            url=url, filename=filename, feature_field=feature_field,
            **kwargs)
        return loader.load_dataset(name, reload)
    load_fn.__name__ = f'load_{name}'
    load_fn.__doc__ = (f'Load the {name} dataset ({filename}): (tasks, '
                       '(train, valid, test), transformers).')
    return load_fn


load_tox21 = _make_csv_load_fn('tox21', TOX21_TASKS, 'tox21.csv.gz',
                               ['balancing'])
load_delaney = _make_csv_load_fn('delaney', DELANEY_TASKS,
                                 'delaney-processed.csv', ['normalization'])
load_freesolv = _make_csv_load_fn('freesolv', FREESOLV_TASKS,
                                  'freesolv.csv.gz', ['normalization'])
load_sampl = _make_csv_load_fn('sampl', FREESOLV_TASKS, 'SAMPL.csv',
                               ['normalization'])
load_lipo = _make_csv_load_fn('lipo', LIPO_TASKS, 'Lipophilicity.csv',
                              ['normalization'])
load_bace_classification = _make_csv_load_fn(
    'bace_c', BACE_CLS_TASKS, 'bace.csv', ['balancing'], feature_field='mol')
load_bace_regression = _make_csv_load_fn(
    'bace_r', BACE_REG_TASKS, 'bace.csv', ['normalization'],
    feature_field='mol')
load_bbbp = _make_csv_load_fn('bbbp', BBBP_TASKS, 'BBBP.csv', ['balancing'])
load_clintox = _make_csv_load_fn('clintox', CLINTOX_TASKS, 'clintox.csv.gz',
                                 ['balancing'])
load_hiv = _make_csv_load_fn('hiv', HIV_TASKS, 'HIV.csv', ['balancing'])
load_sider = _make_csv_load_fn('sider', SIDER_TASKS, 'sider.csv.gz',
                               ['balancing'])
load_muv = _make_csv_load_fn('muv', MUV_TASKS, 'muv.csv.gz', ['balancing'])
load_thermosol = _make_csv_load_fn('thermosol', THERMOSOL_TASKS,
                                   'thermosol.csv', ['normalization'])
load_hppb = _make_csv_load_fn('hppb', HPPB_TASKS, 'hppb.csv',
                              ['normalization'])
load_clearance = _make_csv_load_fn('clearance', CLEARANCE_TASKS,
                                   'clearance.csv', ['normalization'])
load_qm8 = _make_csv_load_fn('qm8', QM8_TASKS, 'qm8.csv', ['normalization'])
load_qm9 = _make_csv_load_fn('qm9', QM9_TASKS, 'qm9.csv', ['normalization'])
load_zinc15 = _make_csv_load_fn('zinc15', ['mwt', 'logp', 'reactive'],
                                'zinc15_270K_2D.csv', ['normalization'])


class _DynamicCSVMolnetLoader(_CSVMolnetLoader):
    """A CSV file whose tasks are its header's columns but ``drop_cols``
    and the feature column (only those starting ``task_prefix``, where
    given)."""

    def __init__(self, *args, drop_cols=(), task_prefix=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.drop_cols = set(drop_cols) | {self.feature_field}
        self.task_prefix = task_prefix

    def create_dataset(self) -> Dataset:
        path = self._dataset_file()
        self.tasks = [c for c in csv_header(path)
                      if c not in self.drop_cols and (
                          not self.task_prefix
                          or c.startswith(self.task_prefix))]
        return super().create_dataset()

    def load_dataset(self, name, reload):
        tasks, datasets, transformers = super().load_dataset(name, reload)
        if not tasks and datasets:           # from the cache
            tasks = list(getattr(datasets[0], 'tasks', []) or [])
        return tasks, datasets, transformers


def _make_dynamic_csv_load_fn(name: str, filename: str,
                              default_transformers: List[str],
                              feature_field: str = 'smiles', drop_cols=(),
                              task_prefix=None, url: Optional[str] = None):
    url = url or (DEEPCHEM_S3 + filename)

    def load_fn(featurizer='ECFP', splitter='scaffold', transformers=None,
                reload: bool = True, data_dir: Optional[str] = None,
                save_dir: Optional[str] = None, **kwargs):
        if transformers is None:
            transformers = list(default_transformers)
        loader = _DynamicCSVMolnetLoader(
            featurizer, splitter, transformers, [], data_dir, save_dir,
            url=url, filename=filename, feature_field=feature_field,
            drop_cols=drop_cols, task_prefix=task_prefix, **kwargs)
        return loader.load_dataset(name, reload)
    load_fn.__name__ = f'load_{name}'
    load_fn.__doc__ = (f'Load the {name} dataset ({filename}; the tasks are '
                       'read from its header): (tasks, (train, valid, '
                       'test), transformers).')
    return load_fn


load_toxcast = _make_dynamic_csv_load_fn('toxcast', 'toxcast_data.csv.gz',
                                         ['balancing'])
load_pcba = _make_dynamic_csv_load_fn(
    'pcba', 'pcba.csv.gz', ['balancing'], drop_cols=('mol_id',),
    task_prefix='PCBA-')
load_nci = _make_dynamic_csv_load_fn(
    'nci', 'nci_unique.csv', ['normalization'],
    drop_cols=('mol_id', 'Compound'))
load_ppb = _make_dynamic_csv_load_fn('ppb', 'PPB.csv', ['normalization'])
load_sweetlead = _make_dynamic_csv_load_fn('sweetlead', 'sweet.csv.gz',
                                           ['balancing'])
load_chembl25 = _make_dynamic_csv_load_fn('chembl25', 'chembl25.csv.gz',
                                          ['normalization'])
load_hopv = _make_dynamic_csv_load_fn('hopv', 'hopv.csv', ['normalization'])
load_kaggle = _make_dynamic_csv_load_fn(
    'kaggle', 'KAGGLE_training_disguised_combined_full.csv.gz',
    ['normalization'], drop_cols=('Molecule',))
load_factors = _make_dynamic_csv_load_fn(
    'factors', 'FACTORS_training_disguised_combined_full.csv.gz',
    ['normalization'], drop_cols=('Molecule',))
load_kinase = _make_dynamic_csv_load_fn(
    'kinase', 'KINASE_training_disguised_combined_full.csv.gz',
    ['normalization'], drop_cols=('Molecule',))
load_uv = _make_dynamic_csv_load_fn(
    'uv', 'UV_training_disguised_combined_full.csv.gz', ['normalization'],
    drop_cols=('Molecule',))
load_uspto = _make_dynamic_csv_load_fn('uspto', 'USPTO_MIT.csv', [],
                                       feature_field='reactions')


def load_chembl(featurizer='ECFP', splitter='scaffold', transformers=None,
                set='5thresh', reload=True, data_dir=None, save_dir=None,
                **kwargs):
    """ChEMBL activities (``chembl_<set>.csv.gz``; the tasks are its
    columns but ``smiles`` and ``mol_id``)."""
    filename = f'chembl_{set}.csv.gz'
    path = download_url(DEEPCHEM_S3 + filename, data_dir or get_data_dir(),
                        filename)
    tasks = [c for c in csv_header(path) if c not in ('smiles', 'mol_id')]
    loader = _CSVMolnetLoader(
        featurizer, splitter,
        ['normalization'] if transformers is None else transformers, tasks,
        data_dir, save_dir, url=DEEPCHEM_S3 + filename, filename=filename,
        **kwargs)
    return loader.load_dataset(f'chembl_{set}', reload)


class _QM7Loader(_MolnetLoader):
    """QM7 from ``gdb7.sdf`` (fetched as ``gdb7.tar.gz``); where that
    cannot be had, the 1000-molecule ``gdb1k.sdf`` with its labels in
    ``gdb1k.sdf.csv``."""

    def create_dataset(self) -> Dataset:
        path = os.path.join(self.data_dir, 'gdb7.sdf')
        if not os.path.exists(path):
            try:
                untargz_file(download_url(DEEPCHEM_S3 + 'gdb7.tar.gz',
                                          self.data_dir), self.data_dir)
            except OSError:
                sdf = download_url(DEEPCHEM_S3 + 'gdb1k.sdf', self.data_dir,
                                   'gdb1k.sdf')
                download_url(DEEPCHEM_S3 + 'gdb1k.sdf.csv', self.data_dir,
                             'gdb1k.sdf.csv')
                return _SDFCSVLoader(['atomization_energy'],
                                     self.featurizer).create_dataset(sdf)
        return SDFLoader(tasks=self.tasks,
                         featurizer=self.featurizer).create_dataset(path)


#: mean bond enthalpies (kcal/mol) for the SDF and CSV alignment
_BOND_KCAL = {
    (1, 6, 1): 99, (1, 7, 1): 93, (1, 8, 1): 111, (1, 16, 1): 87,
    (6, 6, 1): 83, (6, 6, 2): 146, (6, 6, 3): 200, (6, 7, 1): 73,
    (6, 7, 2): 147, (6, 7, 3): 213, (6, 8, 1): 86, (6, 8, 2): 178,
    (7, 7, 1): 39, (7, 7, 2): 100, (7, 8, 1): 53, (7, 8, 2): 145,
    (8, 8, 1): 35, (6, 16, 1): 65, (7, 7, 3): 226, (6, 17, 1): 81,
    (8, 16, 1): 87, (16, 16, 1): 54, (1, 1, 1): 104}


def _bond_energy_estimate(m) -> float:
    tot = 0.0
    for b in m.bonds:
        z1, z2 = sorted([m.atoms[b.a1].atomic_num, m.atoms[b.a2].atomic_num])
        o = int(round(b.order)) if b.order != 1.5 else 1
        tot += _BOND_KCAL.get((z1, z2, o), _BOND_KCAL.get((z1, z2, 1), 70))
        if b.order == 1.5:
            tot += 25
    for a in m.atoms:
        z1, z2 = sorted([1, a.atomic_num])
        tot += a.total_hs * _BOND_KCAL.get((z1, z2, 1), 95)
    return -tot


def _align_sdf_labels(mols, y: np.ndarray) -> List[int]:
    """The SDF records (``len(y)`` of them) a shorter label column
    belongs to: the alignment of the records' bond-enthalpy estimates
    against the labels that skips ``len(mols) - len(y)`` records at least
    cost, by dynamic programming."""
    n, m = len(mols), len(y)
    budget = n - m
    if budget <= 0:
        return list(range(min(n, m)))
    e = np.array([_bond_energy_estimate(mol) for mol in mols])
    INF = 1e18
    dp = np.full((budget + 1, m + 1), INF)
    dp[0][0] = 0.0
    bt = np.zeros((budget + 1, m + 1), dtype=np.int8)
    for j in range(m + 1):
        for s in range(budget + 1):
            cur = dp[s][j]
            if cur >= INF:
                continue
            i = j + s
            if j < m and i < n:
                c = cur + abs(e[i] - y[j])
                if c < dp[s][j + 1]:
                    dp[s][j + 1] = c
                    bt[s][j + 1] = 0
            if s < budget and i < n and cur < dp[s + 1][j]:
                dp[s + 1][j] = cur
                bt[s + 1][j] = 1
    skips = set()
    s, j = budget, m
    while j > 0 or s > 0:
        if bt[s][j] == 1:
            s -= 1
            skips.add(j + s)
        else:
            j -= 1
    return [i for i in range(n) if i not in skips][:m]


class _SDFCSVLoader:
    """An SDF file whose labels are the last column of ``<file>.csv``,
    aligned to its records by :func:`_align_sdf_labels`; the ids are the
    kept records' indices as strings."""

    def __init__(self, tasks, featurizer):
        self.tasks = tasks
        self.featurizer = featurizer

    def create_dataset(self, sdf_path: str) -> Dataset:
        from deepchem_tpu_torch.chem.sdf import parse_sdf
        labels = next(load_csv_files([sdf_path + '.csv']))
        with _open(sdf_path) as f:
            mols = [m for m, _ in parse_sdf(f.read())]
        y = labels[labels.columns[-1]]
        keep = _align_sdf_labels(mols, y)
        X = self.featurizer.featurize([mols[i] for i in keep])
        y = y[:len(keep)]
        valid = np.array([x is not None and (not isinstance(x, np.ndarray)
                                             or x.size > 0) for x in X],
                         dtype=bool)
        ids = np.asarray(keep).astype(str)
        return DiskDataset.from_numpy(X[valid], y[valid], ids=ids[valid],
                                      tasks=self.tasks)


def load_qm7(featurizer=None, splitter='random', transformers=None,
             reload: bool = True, data_dir=None, save_dir=None, **kwargs):
    """QM7 (default ``CoulombMatrixEig(max_atoms=23)``, normalised)."""
    if featurizer is None or featurizer == 'CoulombMatrix':
        featurizer = feat.CoulombMatrixEig(max_atoms=23)
    loader = _QM7Loader(featurizer, splitter,
                        ['normalization'] if transformers is None
                        else transformers, QM7_TASKS, data_dir, save_dir,
                        **kwargs)
    return loader.load_dataset('qm7', reload)


def _json_table(path: str) -> Table:
    """A JSON file of records (a list) or of columns (``{column: {row:
    value}}``) as a :class:`Table`, typed as ``pandas.read_json``."""
    with _open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        rows = list(next(iter(data.values()), {}))
        data = [{k: col.get(r, _MISSING) for k, col in data.items()}
                for r in rows]
    keys = {}
    for r in data:
        keys.update(dict.fromkeys(r))
    return Table({k: json_column([r.get(k, _MISSING) for r in data])
                  for k in keys})


class _MaterialLoader(_MolnetLoader):
    """A materials file (JSON or CSV): the featurizer over its
    ``input_key`` column, the tasks' columns as y."""

    def __init__(self, *args, filename: str, input_key: str, **kwargs):
        super().__init__(*args, **kwargs)
        self.filename = filename
        self.input_key = input_key

    def create_dataset(self) -> Dataset:
        path = download_url(DEEPCHEM_S3 + self.filename, self.data_dir,
                            self.filename)
        table = _json_table(path) if path.endswith('.json') \
            else next(load_csv_files([path]))
        inputs = list(table[self.input_key])
        X = self.featurizer.featurize(inputs)
        valid = np.array([x is not None and (not isinstance(x, np.ndarray)
                                             or x.size > 0) for x in X],
                         dtype=bool)
        ids = np.empty(len(inputs), dtype=object)
        ids[:] = inputs
        return DiskDataset.from_numpy(X[valid], table[self.tasks][valid],
                                      ids=ids[valid], tasks=self.tasks)


def _make_material_load_fn(name, tasks, filename, input_key):
    def load_fn(featurizer=None, splitter='random', transformers=None,
                reload=True, data_dir=None, save_dir=None, **kwargs):
        loader = _MaterialLoader(
            feat.ElementPropertyFingerprint() if featurizer is None
            else featurizer, splitter,
            ['normalization'] if transformers is None else transformers,
            tasks, data_dir, save_dir, filename=filename,
            input_key=input_key, **kwargs)
        return loader.load_dataset(name, reload)
    load_fn.__name__ = f'load_{name}'
    load_fn.__doc__ = (f'Load the {name} materials dataset ({filename}): '
                       '(tasks, (train, valid, test), transformers).')
    return load_fn


load_bandgap = _make_material_load_fn(
    'bandgap', ['experimental_bandgap'], 'expt_gap.csv', 'composition')
load_perovskite = _make_material_load_fn(
    'perovskite', ['formation_energy'], 'perovskite.json', 'structure')
load_mp_formation_energy = _make_material_load_fn(
    'mp_formation_energy', ['formation_energy_per_atom'],
    'mp_formation_energy.json', 'structure')
load_mp_metallicity = _make_material_load_fn(
    'mp_metallicity', ['is_metal'], 'mp_is_metal.json', 'structure')


def _local_file(filename: str, data_dir: Optional[str]) -> str:
    return download_url(DEEPCHEM_S3 + filename, data_dir or get_data_dir(),
                        filename)


def _split_normalized(ds, splitter, task: str):
    """``ds`` split by ``splitter`` (unseeded, as the JAX package), y
    z-scored by train's statistics."""
    tr, va, te = resolve_splitter(splitter).train_valid_test_split(ds)
    t = NormalizationTransformer(transform_y=True, dataset=tr)
    return [task], (t.transform(tr), t.transform(va), t.transform(te)), [t]


def load_membrane_permeability(featurizer=None, splitter='random',
                               transformers=None, reload: bool = True,
                               data_dir=None, save_dir=None, **kwargs):
    """RRCK membrane permeability, LogP (``membrane_permeability.sdf`` and
    its labels in ``membrane_permeability.sdf.csv``), y z-scored."""
    if featurizer is None or featurizer == 'graphconv':
        featurizer = feat.ConvMolFeaturizer()
    elif featurizer == 'ECFP':
        featurizer = feat.CircularFingerprint(size=1024)
    ds = _SDFCSVLoader(['LogP(RRCK)'], featurizer).create_dataset(
        _local_file('membrane_permeability.sdf', data_dir))
    return _split_normalized(ds, splitter, 'LogP(RRCK)')


def load_flash_points(featurizer='ECFP', splitter='random',
                      transformers=None, reload: bool = True, data_dir=None,
                      save_dir=None, **kwargs):
    """Flash points (deg C) of binary mixtures (``flash_points.csv.gz``):
    the features are the molar-fraction-weighted sum of the components'
    1024-bit Morgan fingerprints; y z-scored."""
    with _open(_local_file('flash_points.csv.gz', data_dir)) as f:
        rows = list(csv.DictReader(f))
    uniq = sorted({r['smiles_1'] for r in rows} | {
        r['smiles_2'] for r in rows if r['smiles_2'] not in ('0', '', None)})
    fps = dict(zip(uniq, feat.CircularFingerprint(size=1024).featurize(
        uniq)))
    X, y, ids = [], [], []
    for r in rows:
        f1 = fps.get(r['smiles_1'])
        if not isinstance(f1, np.ndarray) or f1.size == 0:
            continue
        x = float(r['fraction_1']) * f1
        s2 = r['smiles_2']
        if s2 not in ('0', '', None):
            f2 = fps.get(s2)
            if not isinstance(f2, np.ndarray) or f2.size == 0:
                continue
            x = x + float(r['fraction_2']) * f2
        X.append(x)
        y.append(float(r['FP (°C)']))
        ids.append(f"{r['smiles_1']}|{s2}")
    ds = NumpyDataset(np.stack(X), np.asarray(y).reshape(-1, 1),
                      ids=np.asarray(ids))
    return _split_normalized(ds, splitter, 'flash_point')


def load_Platinum_Adsorption(featurizer=None, splitter='random',
                             transformers=(), reload: bool = True,
                             data_dir: Optional[str] = None, save_dir=None,
                             **kwargs):
    """Pt(111) N and NO adsorbate configurations with their formation
    energies (``Platinum_adsorption.json``, JSON lines, or the
    ``.tar.gz`` holding it), default ``SineCoulombMatrix``; no
    transformers."""
    data_dir = data_dir or get_data_dir()
    json_file = os.path.join(data_dir, 'Platinum_adsorption.json')
    if not os.path.exists(json_file):
        untargz_file(download_url(DEEPCHEM_S3 + 'Platinum_adsorption.tar.gz',
                                  data_dir, 'Platinum_adsorption.tar.gz'),
                     data_dir)
    loader = JsonLoader(tasks=['Formation Energy'],
                        feature_field='Structures',
                        label_field='Formation Energy',
                        featurizer=feat.SineCoulombMatrix()
                        if featurizer is None else featurizer)
    ds = loader.create_dataset(json_file)
    tasks = ['Formation Energy']
    if splitter is None:
        return tasks, (ds,), []
    return tasks, resolve_splitter(splitter).train_valid_test_split(ds), []
