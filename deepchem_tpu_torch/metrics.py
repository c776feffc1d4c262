"""Label helpers: the port's copy of ``deepchem_tpu/metrics/metric.py``'s
``to_one_hot``."""

from __future__ import annotations

import numpy as np


def to_one_hot(y: np.ndarray, n_classes: int = 2) -> np.ndarray:
    """``(N,)`` or ``(N, 1)`` labels -> ``(N, n_classes)`` one-hot float64;
    labels are rounded to the nearest class."""
    y = np.asarray(y)
    if y.ndim == 2 and y.shape[1] == 1:
        y = y[:, 0]
    if y.ndim != 1:
        raise ValueError('y must be 1-D or (N,1)')
    n = len(y)
    out = np.zeros((n, n_classes))
    out[np.arange(n), np.round(y).astype(int)] = 1
    return out
