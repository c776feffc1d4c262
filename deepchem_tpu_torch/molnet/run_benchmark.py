"""The MoleculeNet benchmark harness: each dataset with one model at its
preset hyperparameters, scored on train and valid (and test), a row of
results a dataset appended to a CSV file.

The port's own copy of ``deepchem_tpu/molnet/run_benchmark.py``.  Models
are built on ``device`` (default the current CUDA device).  On the card
they train with ``fit_on_device`` and score with ``evaluate_on_device``,
and a failure there raises; on the CPU they use ``fit`` and ``evaluate``.
The ``logreg`` key wraps scikit-learn in the JAX package and raises here.
"""

from __future__ import annotations

import csv
import logging
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

import deepchem_tpu_torch.models as m
import deepchem_tpu_torch.molnet.load_function as lf
from deepchem_tpu_torch.metrics import Metric, pearson_r2_score, \
    roc_auc_score

logger = logging.getLogger(__name__)

CLASSIFICATION_DATASETS = {
    'tox21': lf.load_tox21, 'sider': lf.load_sider, 'muv': lf.load_muv,
    'hiv': lf.load_hiv, 'bbbp': lf.load_bbbp, 'clintox': lf.load_clintox,
    'bace_c': lf.load_bace_classification,
}
REGRESSION_DATASETS = {
    'delaney': lf.load_delaney, 'lipo': lf.load_lipo,
    'freesolv': lf.load_freesolv, 'qm7': lf.load_qm7, 'qm8': lf.load_qm8,
    'qm9': lf.load_qm9, 'bace_r': lf.load_bace_regression,
    'clearance': lf.load_clearance, 'hppb': lf.load_hppb,
}

#: each model key's hyperparameters
PRESET_HYPERPARAMS: Dict[str, Dict] = {
    'tf': {'layer_sizes': [1500], 'weight_init_stddevs': 0.02,
           'bias_init_consts': 1.0, 'dropouts': 0.5,
           'penalty': 0.1, 'batch_size': 50, 'nb_epoch': 10,
           'learning_rate': 0.001},
    'tf_regression': {'layer_sizes': [1000, 1000], 'dropouts': 0.25,
                      'batch_size': 128, 'nb_epoch': 50,
                      'learning_rate': 0.0008},
    'tf_robust': {'layer_sizes': [500], 'bypass_layer_sizes': [100],
                  'dropouts': 0.5, 'bypass_dropouts': 0.5,
                  'batch_size': 50, 'nb_epoch': 10,
                  'learning_rate': 0.0005},
    'logreg': {'penalty': 0.05, 'nb_epoch': None},
    'graphconv': {'batch_size': 64, 'nb_epoch': 40,
                  'learning_rate': 0.0005, 'n_filters': 64,
                  'n_fully_connected_nodes': 128},
    'graphconvreg': {'batch_size': 128, 'nb_epoch': 100,
                     'learning_rate': 0.0005, 'n_filters': 128,
                     'n_fully_connected_nodes': 256},
    'weave': {'batch_size': 64, 'nb_epoch': 40,
              'learning_rate': 0.0005, 'n_graph_feat': 128},
    'textcnn': {'batch_size': 64, 'nb_epoch': 40,
                'learning_rate': 0.0005},
    'gcn': {'batch_size': 128, 'nb_epoch': 50, 'learning_rate': 0.001},
    'gat': {'batch_size': 128, 'nb_epoch': 50, 'learning_rate': 0.001},
}

MODEL_FEATURIZERS = {
    'tf': 'ecfp', 'tf_regression': 'ecfp', 'tf_robust': 'ecfp',
    'logreg': 'ecfp', 'graphconv': 'graphconv',
    'graphconvreg': 'graphconv', 'weave': 'weave', 'textcnn': 'raw',
    'gcn': 'graph', 'gat': 'graph',
}


def _build_classifier(model: str, hp: Dict, n_tasks: int, n_features: int,
                      train, seed: int, device):
    if model == 'logreg':
        raise NotImplementedError(
            "'logreg' wraps scikit-learn's LogisticRegression, which the "
            "port does not carry")
    common = dict(batch_size=hp['batch_size'],
                  learning_rate=hp['learning_rate'], seed=seed,
                  device=device)
    if model == 'tf':
        return m.MultitaskClassifier(
            n_tasks, n_features, layer_sizes=hp['layer_sizes'],
            dropouts=hp['dropouts'], **common)
    if model == 'tf_robust':
        return m.RobustMultitaskClassifier(
            n_tasks, n_features, layer_sizes=hp['layer_sizes'],
            bypass_layer_sizes=hp['bypass_layer_sizes'],
            dropouts=hp['dropouts'], bypass_dropouts=hp['bypass_dropouts'],
            **common)
    if model == 'graphconv':
        return m.GraphConvModel(
            n_tasks, mode='classification',
            graph_conv_layers=[hp['n_filters']] * 2,
            dense_layer_size=hp['n_fully_connected_nodes'], **common)
    if model == 'weave':
        return m.WeaveModel(n_tasks, mode='classification',
                            n_graph_feat=hp.get('n_graph_feat', 128),
                            **common)
    if model == 'textcnn':
        char_dict, seq_length = m.TextCNNModel.build_char_dict(train)
        return m.TextCNNModel(n_tasks, char_dict=char_dict,
                              seq_length=seq_length, mode='classification',
                              **common)
    if model == 'gcn':
        return m.GCNModel(n_tasks, mode='classification', **common)
    if model == 'gat':
        return m.GATModel(n_tasks, mode='classification', **common)
    raise ValueError(f'unknown classification model {model}')


def _build_regressor(model: str, hp: Dict, n_tasks: int, n_features: int,
                     seed: int, device):
    if model == 'weave_regression':
        return m.WeaveModel(n_tasks, mode='regression',
                            batch_size=hp.get('batch_size', 64),
                            learning_rate=hp.get('learning_rate', 5e-4),
                            seed=seed, device=device)
    common = dict(batch_size=hp['batch_size'],
                  learning_rate=hp['learning_rate'], seed=seed,
                  device=device)
    if model == 'tf_regression':
        return m.MultitaskRegressor(
            n_tasks, n_features, layer_sizes=hp['layer_sizes'],
            dropouts=hp['dropouts'], **common)
    if model == 'graphconvreg':
        return m.GraphConvModel(
            n_tasks, mode='regression',
            graph_conv_layers=[hp['n_filters']] * 2,
            dense_layer_size=hp['n_fully_connected_nodes'], **common)
    if model == 'gcn':
        return m.GCNModel(n_tasks, mode='regression', **common)
    if model == 'gat':
        return m.GATModel(n_tasks, mode='regression', **common)
    raise ValueError(f'unknown regression model {model}')


def _on_card(model) -> bool:
    return model.device.type == 'cuda'


def _fit(model, train, nb_epoch: int) -> None:
    """``fit_on_device`` on the card, ``fit`` on the CPU."""
    if _on_card(model):
        model.fit_on_device(train, nb_epoch=nb_epoch)
    else:
        model.fit(train, nb_epoch=nb_epoch)


def _evaluate(model, dataset, metric, transformers):
    """``evaluate_on_device`` on the card, ``evaluate`` on the CPU."""
    if _on_card(model):
        return model.evaluate_on_device(dataset, [metric], transformers)
    return model.evaluate(dataset, [metric], transformers)


def _benchmark(model, train, valid, test, transformers, metric, nb_epoch,
               test_on: bool):
    t0 = time.time()
    _fit(model, train, nb_epoch)
    phases = {'fit_s': round(time.time() - t0, 1)}
    t0 = time.time()
    scores = {'train': _evaluate(model, train, metric, transformers),
              'valid': _evaluate(model, valid, metric, transformers)}
    if test_on:
        scores['test'] = _evaluate(model, test, metric, transformers)
    phases['eval_s'] = round(time.time() - t0, 1)
    return scores, model, phases


def benchmark_classification(train, valid, test, tasks, transformers,
                             n_features: int, metric, model: str,
                             test_on: bool = False, seed: int = 123,
                             hyper_parameters: Optional[Dict] = None,
                             device=None):
    """Build the classifier ``model`` at its preset (updated by
    ``hyper_parameters``), train it ``nb_epoch`` epochs and score it:
    ``(scores, model, {'fit_s', 'eval_s'})``."""
    hp = dict(PRESET_HYPERPARAMS.get(model, {}), **(hyper_parameters or {}))
    nb_epoch = hp.pop('nb_epoch', 10)
    built = _build_classifier(model, hp, len(tasks), n_features, train,
                              seed, device)
    return _benchmark(built, train, valid, test, transformers, metric,
                      nb_epoch, test_on)


def benchmark_regression(train, valid, test, tasks, transformers,
                         n_features: int, metric, model: str,
                         test_on: bool = False, seed: int = 123,
                         hyper_parameters: Optional[Dict] = None,
                         device=None):
    """:func:`benchmark_classification` for a regression model."""
    hp = dict(PRESET_HYPERPARAMS.get(model, {}), **(hyper_parameters or {}))
    nb_epoch = hp.pop('nb_epoch', 10)
    built = _build_regressor(model, hp, len(tasks), n_features, seed,
                             device)
    return _benchmark(built, train, valid, test, transformers, metric,
                      nb_epoch, test_on)


def run_benchmark(datasets: Sequence[str], model: str,
                  split: Optional[str] = None, metric=None,
                  featurizer: Optional[str] = None, out_path: str = '.',
                  hyper_parameters: Optional[Dict] = None,
                  test: bool = False, reload: bool = True, seed: int = 123,
                  out_file: Optional[str] = None, device=None,
                  **load_kwargs) -> List[Dict]:
    """For each dataset: load it (``featurizer``, default the model's;
    ``split``, default random; split seeded with ``seed``), build and
    train ``model`` (seeded with ``seed``) and score it (mean ROC-AUC for
    a classification dataset, mean Pearson r2 for a regression one, or
    ``metric``).  Returns the rows, each also appended to ``out_file``
    (default ``out_path/results.csv``), with the seconds of loading,
    fitting and scoring.  ``load_kwargs`` go to the load function
    (``data_dir``, ``save_dir``)."""
    results = []
    for dataset in datasets:
        if dataset in CLASSIFICATION_DATASETS:
            mode, loader = 'classification', CLASSIFICATION_DATASETS[dataset]
            metric_obj = metric or Metric(roc_auc_score, np.mean)
            bench = benchmark_classification
        elif dataset in REGRESSION_DATASETS:
            mode, loader = 'regression', REGRESSION_DATASETS[dataset]
            metric_obj = metric or Metric(pearson_r2_score, np.mean)
            bench = benchmark_regression
        else:
            raise ValueError(f'unknown dataset {dataset}')
        split_name = split or 'random'
        t0 = time.time()
        tasks, (train, valid, tst), transformers = loader(
            featurizer=featurizer or MODEL_FEATURIZERS.get(model, 'ecfp'),
            splitter=split_name, reload=reload, splitter_seed=seed,
            **load_kwargs)
        load_s = round(time.time() - t0, 1)
        x_shape = train.get_shape()[0]
        n_features = x_shape[1] if x_shape is not None \
            and len(x_shape) > 1 else 1024
        scores, _, phases = bench(
            train, valid, tst, tasks, transformers, n_features, metric_obj,
            model, test_on=test, seed=seed,
            hyper_parameters=hyper_parameters, device=device)
        row = {'dataset': dataset, 'mode': mode, 'model': model,
               'split': split_name,
               'train_score': list(scores['train'].values())[0],
               'valid_score': list(scores['valid'].values())[0],
               'time': round(time.time() - t0, 1), 'load_s': load_s,
               'fit_s': phases['fit_s'], 'eval_s': phases['eval_s']}
        if test:
            row['test_score'] = list(scores['test'].values())[0]
        results.append(row)
        out_file = out_file or os.path.join(out_path, 'results.csv')
        write_header = not os.path.exists(out_file)
        with open(out_file, 'a', newline='') as f:
            writer = csv.DictWriter(f, fieldnames=list(row))
            if write_header:
                writer.writeheader()
            writer.writerow(row)
        logger.info('%s/%s: train=%.4f valid=%.4f (%.1fs)', dataset, model,
                    row['train_score'], row['valid_score'], row['time'])
    return results
