"""Dataset transformers: the ``Transformer`` base and
``NormalizationTransformer``, numpy only.

Counterparts of ``deepchem_tpu/trans/transformers.py``'s
``undo_transforms``, ``Transformer`` and ``NormalizationTransformer``.
A transformer maps a dataset's arrays (``transform``) and undoes its map
of the labels on a model's outputs (``untransform``), which
``TorchModel.predict`` and ``evaluate`` apply in reverse order.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from deepchem_tpu_torch.data import NumpyDataset


def undo_transforms(y: np.ndarray,
                    transformers: Sequence['Transformer']) -> np.ndarray:
    """``y`` with every transformer of the labels undone, the last
    first."""
    for transformer in reversed(list(transformers)):
        if transformer.transform_y:
            y = transformer.untransform(y)
    return y


class Transformer:
    """A map of some of a dataset's arrays: X, y, w and ids."""

    def __init__(self, transform_X: bool = False, transform_y: bool = False,
                 transform_w: bool = False, transform_ids: bool = False,
                 dataset: Optional[NumpyDataset] = None):
        self.transform_X = transform_X
        self.transform_y = transform_y
        self.transform_w = transform_w
        self.transform_ids = transform_ids
        if not (transform_X or transform_y or transform_w or transform_ids):
            raise ValueError('Transformer must transform at least one array')

    def transform_array(self, X, y, w, ids) -> Tuple:
        raise NotImplementedError

    def untransform(self, z):
        raise NotImplementedError('Cannot untransform')

    def transform(self, dataset: NumpyDataset) -> NumpyDataset:
        return dataset.transform(self)

    def __repr__(self):
        return type(self).__name__


class NormalizationTransformer(Transformer):
    """Z-scores of X or y from ``dataset``'s means and standard deviations
    (population, over samples; a deviation of 0 counts as 1).  With
    ``move_mean=False`` only the scale is changed."""

    def __init__(self, transform_X: bool = False, transform_y: bool = False,
                 transform_w: bool = False,
                 dataset: Optional[NumpyDataset] = None,
                 move_mean: bool = True):
        super().__init__(transform_X=transform_X, transform_y=transform_y,
                         transform_w=transform_w, dataset=dataset)
        if dataset is None:
            raise ValueError('dataset required')
        self.move_mean = move_mean
        if transform_X:
            self.X_means, X_stds = dataset.get_statistics(True, False)
            self.X_stds = np.where(np.asarray(X_stds) != 0, X_stds, 1.0)
        if transform_y:
            self.y_means, y_stds = dataset.get_statistics(False, True)
            self.y_stds = np.where(np.asarray(y_stds) != 0, y_stds, 1.0)

    def transform_array(self, X, y, w, ids):
        if self.transform_X:
            X = (X - self.X_means) / self.X_stds if self.move_mean \
                else X / self.X_stds
        if self.transform_y:
            y = (y - self.y_means) / self.y_stds if self.move_mean \
                else y / self.y_stds
        return X, y, w, ids

    def untransform(self, z):
        means, stds = (self.y_means, self.y_stds) if self.transform_y \
            else (self.X_means, self.X_stds)
        return z * stds + means if self.move_mean else z * stds
