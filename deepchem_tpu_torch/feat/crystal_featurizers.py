"""Crystal graph featurizers for CGCNN and LCNN.

Counterparts of ``deepchem_tpu/feat/crystal_featurizers.py``'s
``_structure_arrays``, ``periodic_neighbors``, ``CGCNNFeaturizer`` and
``LCNNFeaturizer``.  A structure is a dict ``{'lattice': 3x3,
'frac_coords': (N, 3), 'species': [symbols]}`` (with ``'occupancy'`` for
LCNN), or any object with ``lattice.matrix``, ``frac_coords`` and
``species`` whose entries carry ``Z``, as a pymatgen ``Structure`` does;
periodic neighbours are found over the 3x3x3 images of the cell.
"""

from __future__ import annotations

import numpy as np

from deepchem_tpu_torch.chem.mol import PERIODIC_TABLE
from deepchem_tpu_torch.feat.base import Featurizer
from deepchem_tpu_torch.feat.graph_data import GraphData


def _structure_arrays(datapoint):
    """``(lattice [3, 3], fractional coordinates [N, 3], atomic numbers
    [N])`` of a structure dict or structure object."""
    if hasattr(datapoint, 'lattice'):
        lattice = np.asarray(datapoint.lattice.matrix)
        frac = np.asarray(datapoint.frac_coords)
        zs = np.asarray([s.Z for s in datapoint.species])
    else:
        lattice = np.asarray(datapoint['lattice'], dtype=float)
        frac = np.asarray(datapoint['frac_coords'], dtype=float)
        zs = np.asarray([PERIODIC_TABLE[s] for s in datapoint['species']])
    return lattice, frac, zs


def periodic_neighbors(lattice: np.ndarray, frac: np.ndarray,
                       radius: float, max_neighbors: int):
    """Neighbour pairs within ``radius`` over the 3x3x3 periodic images:
    for each centre atom ``i`` in turn, the ``max_neighbors`` nearest of
    the first ``3 * max_neighbors`` images in ``np.argsort``'s order (its
    default sort, which is not stable: among equal distances it picks as
    the JAX package picks) that lie within ``radius``.  Returns ``(src,
    dst, dist)``: int64, int64 and float32 arrays, ``dst`` the centre."""
    n = len(frac)
    cart = frac @ lattice
    shifts = np.array([(i, j, k) for i in (-1, 0, 1)
                       for j in (-1, 0, 1) for k in (-1, 0, 1)])
    src_all, dst_all, d_all = [], [], []
    images = (shifts @ lattice)[:, None, :] + cart[None, :, :]   # [27, N, 3]
    for i in range(n):
        d = np.linalg.norm(images - cart[i], axis=-1)     # [27, N]
        d[13, i] = np.inf      # the atom itself, at zero shift
        flat = d.reshape(-1)
        order = np.argsort(flat)
        picked = [oi for oi in order[:max_neighbors * 3]
                  if flat[oi] <= radius][:max_neighbors]
        for oi in picked:
            src_all.append(oi % n)
            dst_all.append(i)
            d_all.append(flat[oi])
    return (np.asarray(src_all, dtype=np.int64),
            np.asarray(dst_all, dtype=np.int64),
            np.asarray(d_all, dtype=np.float32))


class CGCNNFeaturizer(Featurizer):
    """Crystal graph for CGCNN (Xie & Grossman 2018): a 92-wide one-hot of
    each atom's atomic number (``Z - 1``, capped at 91), edges from each
    periodic neighbour to its centre, and each edge's distance expanded
    over Gaussians ``exp(-(d - c)^2 / step^2)`` at the centres
    ``np.arange(0, radius + step, step)``."""

    def __init__(self, radius: float = 8.0, max_neighbors: int = 12,
                 step: float = 0.2):
        self.radius = radius
        self.max_neighbors = max_neighbors
        self.step = step
        self.centers = np.arange(0, radius + self.step, self.step)

    def _featurize(self, datapoint) -> GraphData:
        lattice, frac, zs = _structure_arrays(datapoint)
        src, dst, d = periodic_neighbors(lattice, frac, self.radius,
                                         self.max_neighbors)
        node_feats = np.zeros((len(zs), 92), dtype=np.float32)
        for i, z in enumerate(zs):
            node_feats[i, min(int(z) - 1, 91)] = 1.0
        edge_feats = np.exp(
            -np.square(d[:, None] - self.centers) /
            (self.step ** 2)).astype(np.float32)
        return GraphData(node_feats, np.stack([src, dst]), edge_feats)


class LCNNFeaturizer(Featurizer):
    """Lattice graph for LCNN: a one-hot of each site's occupancy (a dict
    structure's ``'occupancy'``, else 0; clipped to ``n_occupancy - 1``),
    edges from each periodic neighbour within ``cutoff`` to its centre,
    and each edge's distance as its one feature."""

    def __init__(self, cutoff: float = 6.0, max_neighbors: int = 6,
                 n_occupancy: int = 3):
        self.cutoff = cutoff
        self.max_neighbors = max_neighbors
        self.n_occupancy = n_occupancy

    def _featurize(self, datapoint) -> GraphData:
        lattice, frac, zs = _structure_arrays(datapoint)
        src, dst, d = periodic_neighbors(lattice, frac, self.cutoff,
                                         self.max_neighbors)
        occ = np.asarray(datapoint.get('occupancy',
                                       np.zeros(len(frac), dtype=int)) if
                         isinstance(datapoint, dict)
                         else np.zeros(len(frac), dtype=int))
        node_feats = np.eye(self.n_occupancy, dtype=np.float32)[
            np.clip(occ, 0, self.n_occupancy - 1)]
        ef = d[:, None].astype(np.float32)
        return GraphData(node_feats, np.stack([src, dst]), ef)
