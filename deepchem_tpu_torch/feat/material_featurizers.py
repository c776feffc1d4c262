"""Composition and periodic-structure featurizers.

Counterparts of ``deepchem_tpu/feat/material_featurizers.py``'s
``_ELEM_PROPS``, ``parse_composition``, ``ElementPropertyFingerprint``,
``ElemNetFeaturizer`` and ``SineCoulombMatrix``: compositions are parsed
and element statistics computed here, with no pymatgen or matminer.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np

from deepchem_tpu_torch.chem.mol import (ATOMIC_MASS, ATOMIC_SYMBOL,
                                         PERIODIC_TABLE)
from deepchem_tpu_torch.feat.base import Featurizer
from deepchem_tpu_torch.feat.crystal_featurizers import _structure_arrays

# atomic number -> (electronegativity, atomic radius in pm, period, group,
# melting point in K, approximate); an element not listed has NaN for all
_ELEM_PROPS: Dict[int, tuple] = {
    1: (2.20, 53, 1, 1, 14), 3: (0.98, 167, 2, 1, 454),
    4: (1.57, 112, 2, 2, 1560), 5: (2.04, 87, 2, 13, 2349),
    6: (2.55, 67, 2, 14, 3800), 7: (3.04, 56, 2, 15, 63),
    8: (3.44, 48, 2, 16, 54), 9: (3.98, 42, 2, 17, 53),
    11: (0.93, 190, 3, 1, 371), 12: (1.31, 145, 3, 2, 923),
    13: (1.61, 118, 3, 13, 933), 14: (1.90, 111, 3, 14, 1687),
    15: (2.19, 98, 3, 15, 317), 16: (2.58, 88, 3, 16, 388),
    17: (3.16, 79, 3, 17, 172), 19: (0.82, 243, 4, 1, 337),
    20: (1.00, 194, 4, 2, 1115), 22: (1.54, 176, 4, 4, 1941),
    23: (1.63, 171, 4, 5, 2183), 24: (1.66, 166, 4, 6, 2180),
    25: (1.55, 161, 4, 7, 1519), 26: (1.83, 156, 4, 8, 1811),
    27: (1.88, 152, 4, 9, 1768), 28: (1.91, 149, 4, 10, 1728),
    29: (1.90, 145, 4, 11, 1358), 30: (1.65, 142, 4, 12, 693),
    31: (1.81, 136, 4, 13, 303), 32: (2.01, 125, 4, 14, 1211),
    33: (2.18, 114, 4, 15, 1090), 34: (2.55, 103, 4, 16, 494),
    35: (2.96, 94, 4, 17, 266), 38: (0.95, 219, 5, 2, 1050),
    40: (1.33, 206, 5, 4, 2128), 42: (2.16, 190, 5, 6, 2896),
    47: (1.93, 165, 5, 11, 1235), 48: (1.69, 161, 5, 12, 594),
    49: (1.78, 156, 5, 13, 430), 50: (1.96, 145, 5, 14, 505),
    51: (2.05, 133, 5, 15, 904), 52: (2.10, 123, 5, 16, 723),
    53: (2.66, 115, 5, 17, 387), 56: (0.89, 253, 6, 2, 1000),
    74: (2.36, 193, 6, 6, 3695), 78: (2.28, 177, 6, 10, 2041),
    79: (2.54, 174, 6, 11, 1337), 80: (2.00, 171, 6, 12, 234),
    82: (2.33, 154, 6, 14, 601), 83: (2.02, 143, 6, 15, 544),
}

_COMP_RE = re.compile(r'([A-Z][a-z]?)(\d*\.?\d*)')


def parse_composition(formula: str) -> Dict[int, float]:
    """``'Fe2O3'`` -> ``{26: 2.0, 8: 3.0}``: each element symbol and its
    count (1 where none is written), summed over repeats; unknown symbols
    are skipped."""
    comp: Dict[int, float] = {}
    for sym, count in _COMP_RE.findall(formula.replace(' ', '')):
        if sym not in PERIODIC_TABLE:
            continue
        z = PERIODIC_TABLE[sym]
        comp[z] = comp.get(z, 0.0) + (float(count) if count else 1.0)
    return comp


class ElementPropertyFingerprint(Featurizer):
    """Statistics of elemental properties over a composition: for each of
    the atomic mass and the five properties of ``_ELEM_PROPS``, the min,
    max, range, fraction-weighted mean and weighted standard deviation over
    the elements that have it (their fractions renormalised), or five
    zeros where none has it.  30 float64 values."""

    def __init__(self, data_source: str = 'magpie'):
        self.data_source = data_source

    def _featurize(self, datapoint: str) -> np.ndarray:
        comp = parse_composition(str(datapoint))
        if not comp:
            raise ValueError(f'cannot parse composition {datapoint}')
        total = sum(comp.values())
        fracs = {z: c / total for z, c in comp.items()}
        rows, weights = [], []
        for z, f in fracs.items():
            props = _ELEM_PROPS.get(z, (np.nan,) * 5)
            rows.append([ATOMIC_MASS.get(z, 2.0 * z), *props])
            weights.append(f)
        P = np.asarray(rows, dtype=float)
        stats = []
        for col in range(P.shape[1]):
            v = P[:, col]
            ok = np.isfinite(v)
            if not ok.any():
                stats += [0.0] * 5
                continue
            v, w_ok = v[ok], np.asarray(weights)[ok]
            w_ok = w_ok / w_ok.sum()
            mean = float(np.sum(v * w_ok))
            stats += [v.min(), v.max(), v.max() - v.min(), mean,
                      float(np.sqrt(np.sum(w_ok * (v - mean) ** 2)))]
        return np.asarray(stats, dtype=np.float64)


class ElemNetFeaturizer(Featurizer):
    """The 86-wide vector of each element's fraction in a composition
    (``Z`` 1 to 86; heavier elements are left out), float32."""

    MAX_Z = 86

    def get_vector(self, comp) -> Optional[np.ndarray]:
        """An element -> amount dict (keys symbols or atomic numbers) as the
        86-wide fraction vector; ``None`` when an element lies outside ``Z``
        1 to 86 or is unknown."""
        sym_to_z = {v: k for k, v in ATOMIC_SYMBOL.items()}
        total = sum(comp.values()) or 1.0
        v = np.zeros(self.MAX_Z, dtype=np.float32)
        for key, c in comp.items():
            z = key if isinstance(key, int) else sym_to_z.get(str(key), 0)
            if not 1 <= z <= self.MAX_Z:
                return None
            v[z - 1] = c / total
        return v

    def _featurize(self, datapoint: str) -> np.ndarray:
        comp = parse_composition(str(datapoint))
        total = sum(comp.values()) or 1.0
        v = np.zeros(self.MAX_Z, dtype=np.float32)
        for z, c in comp.items():
            if 1 <= z <= self.MAX_Z:
                v[z - 1] = c / total
        return v


class SineCoulombMatrix(Featurizer):
    """Periodic Coulomb matrix of a crystal (Faber et al. 2015): ``Z_i Z_j
    / d_ij`` off the diagonal, with the sine distance ``d_ij`` of the
    fractional coordinates through the lattice, and ``0.5 Z_i^2.4`` on it,
    zero-padded to ``max_atoms``; with ``flatten``, its eigenvalues in
    descending order (float64), else the matrix.  The input is a structure
    as :class:`CGCNNFeaturizer` takes it."""

    def __init__(self, max_atoms: int = 100, flatten: bool = True):
        self.max_atoms = max_atoms
        self.flatten = flatten

    def _featurize(self, datapoint) -> np.ndarray:
        lattice, frac, zs = _structure_arrays(datapoint)
        n = len(zs)
        m = np.zeros((self.max_atoms, self.max_atoms))
        diff = frac[:, None, :] - frac[None, :, :]
        sin2 = np.square(np.sin(np.pi * diff))
        dist = np.sqrt(np.einsum('ijk,kl,ijl->ij', sin2,
                                 lattice @ lattice.T, sin2) + 1e-12)
        with np.errstate(divide='ignore'):
            cm = np.outer(zs, zs) / np.where(dist > 0, dist, np.inf)
        np.fill_diagonal(cm, 0.5 * zs ** 2.4)
        m[:n, :n] = cm
        if self.flatten:
            w, _ = np.linalg.eigh(m)
            return w[::-1].astype(np.float64)
        return m
