"""Featurizer bases: the per-datapoint log-and-drop loop over any
datapoints (crystal structures, compositions) and over molecules."""

from __future__ import annotations

import logging
from typing import Any, List

import numpy as np

from deepchem_tpu_torch.chem import Molecule, mol_from_smiles

logger = logging.getLogger(__name__)


class Featurizer:
    """Featurizer of any datapoints: a list of them, or one that is a
    string or not iterable.  Subclasses implement
    ``_featurize(self, datapoint)``.

    A datapoint that is None or fails to featurize is logged and becomes
    an empty array, so outputs stay aligned with inputs; numeric arrays of
    one shape are stacked into one array, anything else comes back as an
    object array, one entry a datapoint.
    """

    def featurize(self, datapoints, log_every_n: int = 1000) -> np.ndarray:
        if self._is_one(datapoints):
            datapoints = [datapoints]
        features: List[Any] = []
        for i, point in enumerate(datapoints):
            if i % log_every_n == 0:
                logger.info('Featurizing datapoint %i', i)
            item = self._prepare(point)
            try:
                if item is None:
                    raise ValueError('could not parse the datapoint')
                features.append(self._featurize(item))
            except Exception as e:    # log-and-drop keeps outputs aligned
                logger.warning(
                    'Failed to featurize datapoint %d, %s. Appending empty '
                    'array. Exception message: %s', i, point, e)
                features.append(np.array([]))
        return _stack_or_object(features)

    def __call__(self, datapoints, **kwargs) -> np.ndarray:
        return self.featurize(datapoints, **kwargs)

    @staticmethod
    def _is_one(datapoints) -> bool:
        return isinstance(datapoints, (str, bytes)) or not hasattr(
            datapoints, '__iter__')

    def _prepare(self, point):
        """What ``_featurize`` takes for a datapoint (None: unparseable)."""
        return point

    def _featurize(self, datapoint):
        raise NotImplementedError


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
