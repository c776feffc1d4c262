"""Which featurizer (and its width) each (dataset, model) pair of the
benchmark takes, and which splitters each dataset allows; the port's
copy of ``deepchem_tpu/molnet/check_availability.py``."""

CheckFeaturizer = {
    ('tox21', 'tf'): ['ecfp', 1024],
    ('tox21', 'tf_robust'): ['ecfp', 1024],
    ('tox21', 'logreg'): ['ecfp', 1024],
    ('tox21', 'graphconv'): ['graphconv', 75],
    ('tox21', 'weave'): ['weave', 75],
    ('tox21', 'textcnn'): ['raw', 1],
    ('sider', 'tf'): ['ecfp', 1024],
    ('sider', 'graphconv'): ['graphconv', 75],
    ('muv', 'tf'): ['ecfp', 1024],
    ('muv', 'graphconv'): ['graphconv', 75],
    ('hiv', 'tf'): ['ecfp', 1024],
    ('hiv', 'graphconv'): ['graphconv', 75],
    ('bbbp', 'tf'): ['ecfp', 1024],
    ('bbbp', 'graphconv'): ['graphconv', 75],
    ('clintox', 'tf'): ['ecfp', 1024],
    ('clintox', 'graphconv'): ['graphconv', 75],
    ('bace_c', 'tf'): ['ecfp', 1024],
    ('bace_c', 'graphconv'): ['graphconv', 75],
    ('delaney', 'tf_regression'): ['ecfp', 1024],
    ('delaney', 'graphconvreg'): ['graphconv', 75],
    ('lipo', 'tf_regression'): ['ecfp', 1024],
    ('lipo', 'graphconvreg'): ['graphconv', 75],
    ('freesolv', 'tf_regression'): ['ecfp', 1024],
    ('qm7', 'dtnn'): ['coulomb_matrix', 23],
    ('qm8', 'mpnn'): ['graph-edges', 30],
    ('qm9', 'mpnn'): ['graph-edges', 30],
}

CheckSplit = {
    'tox21': ['index', 'random', 'scaffold', 'stratified'],
    'sider': ['index', 'random', 'scaffold'],
    'muv': ['index', 'random', 'scaffold'],
    'hiv': ['index', 'random', 'scaffold'],
    'bbbp': ['index', 'random', 'scaffold'],
    'clintox': ['index', 'random', 'scaffold'],
    'bace_c': ['index', 'random', 'scaffold'],
    'delaney': ['index', 'random', 'scaffold'],
    'lipo': ['index', 'random', 'scaffold'],
    'freesolv': ['index', 'random'],
    'qm7': ['index', 'random', 'stratified'],
    'qm8': ['index', 'random'],
    'qm9': ['index', 'random'],
}
