"""Featurizer base: the per-datapoint log-and-drop loop over molecules."""

from __future__ import annotations

import logging
from typing import Any, List

import numpy as np

from deepchem_tpu_torch.chem import Molecule, mol_from_smiles

logger = logging.getLogger(__name__)


class MolecularFeaturizer:
    """Featurizer whose datapoints are molecules, given as SMILES strings or
    :class:`Molecule` objects.  Subclasses implement
    ``_featurize(self, mol: Molecule)``.

    A datapoint that fails to parse or featurize is logged and becomes an
    empty array, so outputs stay aligned with inputs.
    """

    def featurize(self, datapoints, log_every_n: int = 1000) -> np.ndarray:
        if isinstance(datapoints, (str, Molecule)):
            datapoints = [datapoints]
        features: List[Any] = []
        for i, point in enumerate(datapoints):
            if i % log_every_n == 0:
                logger.info('Featurizing datapoint %i', i)
            mol = mol_from_smiles(point) if isinstance(point, str) else point
            try:
                if mol is None:
                    raise ValueError('could not parse molecule')
                features.append(self._featurize(mol))
            except Exception as e:    # log-and-drop keeps outputs aligned
                logger.warning(
                    'Failed to featurize datapoint %d, %s. Appending empty '
                    'array. Exception message: %s', i, point, e)
                features.append(np.array([]))
        out = np.empty(len(features), dtype=object)
        for i, f in enumerate(features):
            out[i] = f
        return out

    def __call__(self, datapoints, **kwargs) -> np.ndarray:
        return self.featurize(datapoints, **kwargs)

    def _featurize(self, mol: Molecule):
        raise NotImplementedError
