"""The MoleculeNet loading pipeline: featurize, split, fit the
transformers on train, transform every split, and cache the result.

The port's own copy of ``deepchem_tpu/molnet/loader.py``.  A load with a
splitter is cached in ``save_dir/{name}-featurized/<featurizer>/
<splitter>[-seed<n>]/<transformers>`` (the names as the JAX package forms
them), and ``reload=True`` returns the cached splits.  A cache folder
that holds the JAX package's shards raises, naming the folder, rather
than being featurized over.  The named presets include two featurizers
the port does not have yet; resolving either raises
``NotImplementedError``.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple, Union

import deepchem_tpu_torch.feat as feat
import deepchem_tpu_torch.splits as splits
import deepchem_tpu_torch.trans as trans
from deepchem_tpu_torch.data import Dataset, DiskDataset
from deepchem_tpu_torch.utils.data_utils import (get_data_dir,
                                                 load_dataset_from_disk,
                                                 save_dataset_to_disk)

logger = logging.getLogger(__name__)

DEEPCHEM_S3 = 'https://deepchemdata.s3-us-west-1.amazonaws.com/datasets/'


class TransformerGenerator:
    """A transformer class and its arguments, built on a dataset when the
    dataset exists."""

    def __init__(self, transformer_class, **kwargs):
        self.transformer_class = transformer_class
        self.kwargs = kwargs

    def create_transformer(self, dataset: Dataset):
        return self.transformer_class(dataset=dataset, **self.kwargs)

    def get_directory_name(self) -> str:
        """The class's name, lower case, less 'transformer', then
        ``_{key}_{value}`` for each argument in key order."""
        name = self.transformer_class.__name__.lower().replace(
            'transformer', '')
        for k, v in sorted(self.kwargs.items()):
            if k != 'dataset':
                name += f'_{k}_{v}'
        return name


class NotPorted:
    """A preset whose featurizer the port does not have yet."""

    def __init__(self, name: str, needs: str):
        self.name = name
        self.needs = needs


featurizers: Dict[str, object] = {
    'ecfp': feat.CircularFingerprint(size=1024),
    'maccs': NotPorted('MACCSKeysFingerprint', 'chem/smarts.py (ROADMAP.md '
                       'section 1 item 2)'),
    'graphconv': feat.ConvMolFeaturizer(),
    'weave': feat.WeaveFeaturizer(),
    'raw': feat.RawFeaturizer(),
    'smiles2seq': feat.RawFeaturizer(smiles=True),
    'smiles2img': feat.SmilesToImage(img_size=80, img_spec='engd'),
    'onehot': feat.OneHotFeaturizer(),
    'rdkit-descriptors': NotPorted('RDKitDescriptors', 'chem/descriptors.py '
                                   '(ROADMAP.md section 1 item 2)'),
    'graph': feat.MolGraphConvFeaturizer(),
    'graph-edges': feat.MolGraphConvFeaturizer(use_edges=True),
}
splitters: Dict[str, splits.Splitter] = {
    'index': splits.IndexSplitter(),
    'random': splits.RandomSplitter(),
    'scaffold': splits.ScaffoldSplitter(),
    'butina': splits.ButinaSplitter(),
    'fingerprint': splits.FingerprintSplitter(),
    'stratified': splits.RandomStratifiedSplitter(),
}
transformers: Dict[str, TransformerGenerator] = {
    'balancing': TransformerGenerator(trans.BalancingTransformer),
    'normalization': TransformerGenerator(trans.NormalizationTransformer,
                                          transform_y=True),
    'minmax': TransformerGenerator(trans.MinMaxTransformer,
                                   transform_y=True),
    'clipping': TransformerGenerator(trans.ClippingTransformer,
                                     transform_X=True),
    'log': TransformerGenerator(trans.LogTransformer, transform_y=True),
}


def resolve_featurizer(featurizer):
    """A preset's featurizer by name (any case), or ``featurizer``
    itself."""
    if isinstance(featurizer, str):
        featurizer = featurizers[featurizer.lower()]
    if isinstance(featurizer, NotPorted):
        raise NotImplementedError(
            f'{featurizer.name} is not ported yet: it needs '
            f'{featurizer.needs}')
    return featurizer


def resolve_splitter(splitter):
    """A preset's splitter by name (any case), or ``splitter`` itself."""
    return splitters[splitter.lower()] if isinstance(splitter, str) \
        else splitter


def _dirname(obj) -> str:
    return type(obj).__name__.lower()


def _discard(dataset) -> None:
    """Remove a ``DiskDataset`` this pipeline made in a temporary folder
    and no longer needs."""
    if isinstance(dataset, DiskDataset) and os.path.abspath(
            dataset.data_dir).startswith(
                os.path.abspath(tempfile.gettempdir()) + os.sep):
        shutil.rmtree(dataset.data_dir, ignore_errors=True)


class _MolnetLoader:
    """One dataset's loader: subclasses give ``create_dataset``.  Keyword
    arguments: ``splitter_seed`` (seeds the split and names the cache),
    ``shard_size`` (rows a shard, 8192)."""

    def __init__(self, featurizer: Union[str, feat.Featurizer],
                 splitter: Union[str, splits.Splitter, None],
                 transformer_generators: Sequence[
                     Union[str, TransformerGenerator]],
                 tasks: Sequence[str], data_dir: Optional[str],
                 save_dir: Optional[str], **kwargs):
        self.data_dir = get_data_dir() if data_dir is None else data_dir
        self.save_dir = get_data_dir() if save_dir is None else save_dir
        self.featurizer = resolve_featurizer(featurizer)
        self.splitter = resolve_splitter(splitter)
        self.transformers = [
            transformers[t.lower()] if isinstance(t, str) else t
            for t in transformer_generators]
        self.tasks = list(tasks)
        self.args = kwargs

    def cache_folder(self, name: str) -> Optional[str]:
        """Where a load of ``name`` with this featurizer, splitter, seed
        and transformers is cached (None without a splitter)."""
        if self.splitter is None:
            return None
        splitter_name = _dirname(self.splitter)
        seed = self.args.get('splitter_seed')
        if seed is not None:
            splitter_name = f'{splitter_name}-seed{seed}'
        folder = os.path.join(self.save_dir, f'{name}-featurized',
                              _dirname(self.featurizer), splitter_name)
        if self.transformers:
            folder = os.path.join(folder, '_'.join(
                t.get_directory_name() for t in self.transformers))
        return folder

    def load_dataset(self, name: str, reload: bool
                     ) -> Tuple[List[str], Tuple[Dataset, ...], List]:
        """``(tasks, (train, valid, test), transformers)``, or with no
        splitter ``(tasks, (dataset,), transformers)``."""
        save_folder = self.cache_folder(name)
        if save_folder is not None:
            # raises where the folder holds the JAX package's shards
            found, cached, cached_transformers = \
                load_dataset_from_disk(save_folder)
            if reload and found:
                return self.tasks, cached, cached_transformers
        logger.info('About to featurize %s dataset.', name)
        dataset = self.create_dataset()
        if self.splitter is None:
            applied = [t.create_transformer(dataset)
                       for t in self.transformers]
            for t in applied:
                dataset = t.transform(dataset)
            return self.tasks, (dataset,), applied
        seed = self.args.get('splitter_seed')
        parts = self.splitter.train_valid_test_split(
            dataset, **({} if seed is None else {'seed': seed}))
        _discard(dataset)
        applied = [t.create_transformer(parts[0]) for t in self.transformers]
        for t in applied:
            new = tuple(t.transform(d) for d in parts)
            for d in parts:
                _discard(d)
            parts = new
        if save_folder is not None and isinstance(parts[0], DiskDataset):
            save_dataset_to_disk(save_folder, *parts, applied)
        return self.tasks, parts, applied

    def create_dataset(self) -> Dataset:
        raise NotImplementedError
