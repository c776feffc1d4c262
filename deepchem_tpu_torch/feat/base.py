"""Featurizer bases: the per-datapoint log-and-drop loop over any
datapoints (crystal structures, compositions) and over molecules, run in
the calling process or over a pool of worker processes."""

from __future__ import annotations

import logging
import multiprocessing as mp
import sys
from typing import Any, List, Sequence

import numpy as np

from deepchem_tpu_torch.chem import Molecule, mol_from_smiles

logger = logging.getLogger(__name__)

#: smallest number of datapoints featurized over a pool
POOL_MIN_POINTS = 65


class Featurizer:
    """Featurizer of any datapoints: a list of them, or one that is a
    string or not iterable.  Subclasses implement
    ``_featurize(self, datapoint)``.

    A datapoint that is None or fails to featurize is logged and becomes
    an empty array, so outputs stay aligned with inputs; numeric arrays of
    one shape are stacked into one array, anything else comes back as an
    object array, one entry a datapoint.

    With ``n_jobs > 1`` and at least :data:`POOL_MIN_POINTS` datapoints,
    as in the JAX package, the datapoints are featurized (and SMILES
    parsed) over a pool of ``n_jobs`` worker processes, in order, with the
    same results.  The workers are forked, as the JAX package's: a worker
    started fresh (spawn, or a fork server) imports the caller's main
    script again, which hangs a script that starts its work outside an
    ``if __name__ == '__main__'`` guard.  Forked workers run only the
    featurizer's Python and numpy code: none touches the card, even where
    the caller holds a CUDA context, and a featurizer that holds tensors
    is refused.
    """

    #: pools run, counted where a pool is started
    pool_runs = 0

    def featurize(self, datapoints, log_every_n: int = 1000,
                  n_jobs: int = 1) -> np.ndarray:
        if self._is_one(datapoints):
            datapoints = [datapoints]
        datapoints = list(datapoints)
        if n_jobs > 1 and len(datapoints) >= POOL_MIN_POINTS:
            features = _featurize_pooled(self, datapoints, n_jobs)
        else:
            features = []
            for i, point in enumerate(datapoints):
                if i % log_every_n == 0:
                    logger.info('Featurizing datapoint %i', i)
                features.append(self._featurize_point(point, i))
        return _stack_or_object(features)

    def __call__(self, datapoints, **kwargs) -> np.ndarray:
        return self.featurize(datapoints, **kwargs)

    @staticmethod
    def _is_one(datapoints) -> bool:
        return isinstance(datapoints, (str, bytes)) or not hasattr(
            datapoints, '__iter__')

    def _featurize_point(self, point, i: int):
        """One datapoint's features, or an empty array (logged) where it
        does not parse or fails."""
        try:
            item = self._prepare(point)
            if item is None:
                raise ValueError('could not parse the datapoint')
            return self._featurize(item)
        except Exception as e:    # log-and-drop keeps outputs aligned
            logger.warning(
                'Failed to featurize datapoint %d, %s. Appending empty '
                'array. Exception message: %s', i, point, e)
            return np.array([])

    def _prepare(self, point):
        """What ``_featurize`` takes for a datapoint (None: unparseable)."""
        return point

    def _featurize(self, datapoint):
        raise NotImplementedError

    def __repr__(self) -> str:
        args = ', '.join(f'{k}={v}' for k, v in sorted(vars(self).items())
                         if not k.startswith('_'))
        return f'{type(self).__name__}[{args}]'


class MolecularFeaturizer(Featurizer):
    """Featurizer whose datapoints are molecules, given as SMILES strings or
    :class:`Molecule` objects.  Subclasses implement
    ``_featurize(self, mol: Molecule)``; a SMILES that does not parse
    becomes an empty array.
    """

    @staticmethod
    def _is_one(datapoints) -> bool:
        return isinstance(datapoints, (str, Molecule))

    def _prepare(self, point):
        return mol_from_smiles(point) if isinstance(point, str) else point


class UserDefinedFeaturizer(Featurizer):
    """Features the user computed ahead of time, read by a loader from the
    columns ``feature_fields`` (``UserCSVLoader``)."""

    def __init__(self, feature_fields: Sequence[str]):
        self.feature_fields = list(feature_fields)


class RawFeaturizer(MolecularFeaturizer):
    """The :class:`Molecule` itself, or with ``smiles=True`` its canonical
    SMILES."""

    def __init__(self, smiles: bool = False):
        self.smiles = smiles

    def _featurize(self, mol: Molecule):
        if self.smiles:
            from deepchem_tpu_torch.chem import mol_to_smiles
            return mol_to_smiles(mol)
        return mol


def _stack_or_object(features: List[Any]) -> np.ndarray:
    """``np.stack`` of numeric arrays of one shape, else an object array."""
    first = features[0] if features else None
    if features and all(isinstance(f, np.ndarray)
                        and f.shape == first.shape and f.dtype.kind in 'fiub'
                        for f in features):
        return np.stack(features)
    out = np.empty(len(features), dtype=object)
    for i, f in enumerate(features):
        out[i] = f
    return out


_worker_featurizer: List[Featurizer] = []     # set in each pool worker


def _init_worker(featurizer: Featurizer) -> None:
    _worker_featurizer[:] = [featurizer]


def _featurize_in_worker(item):
    i, point = item
    return _worker_featurizer[0]._featurize_point(point, i)


def _featurize_pooled(featurizer: Featurizer, datapoints: List,
                      n_jobs: int) -> List:
    """``featurizer``'s features of ``datapoints`` over ``n_jobs`` forked
    workers, in order (chunks of ``n / (4 n_jobs)``, as the JAX
    package)."""
    torch = sys.modules.get('torch')
    if torch is not None and any(isinstance(v, torch.Tensor)
                                 for v in vars(featurizer).values()):
        raise ValueError(f'{type(featurizer).__name__} holds tensors: it '
                         'cannot be sent to pool workers (n_jobs=1 '
                         'featurizes in this process)')
    ctx = mp.get_context('fork')
    Featurizer.pool_runs += 1
    with ctx.Pool(n_jobs, initializer=_init_worker,
                  initargs=(featurizer,)) as pool:
        return pool.map(_featurize_in_worker, list(enumerate(datapoints)),
                        chunksize=max(1, len(datapoints) // (n_jobs * 4)))
