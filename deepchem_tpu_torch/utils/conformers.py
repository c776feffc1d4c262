"""3D coordinates without RDKit: a distance-geometry embedding of the bond
graph and a conformer generator over it.

``embed_molecule_3d`` seeds coordinates from the bond graph's path
lengths by classical multidimensional scaling (``np.linalg.eigh``), adds
seeded noise and relaxes bonds towards their lengths while pushing close
atoms apart.  The result is a plausible geometry, not a force-field one:
enough for Coulomb-matrix features when a molecule comes without an SDF
conformer.  The port's own copy of ``deepchem_tpu/utils/conformers.py``'s
numpy path, step for step: with the same numpy and seed both give the same
coordinates bit for bit.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional

import numpy as np

from deepchem_tpu_torch.chem.mol import Molecule

# rough covalent bond lengths (angstrom) per bond order
_BOND_LENGTH = {1.0: 1.5, 1.5: 1.4, 2.0: 1.33, 3.0: 1.2}


class ConformerGenerator:
    """Attaches one embedded conformer to a molecule
    (:func:`embed_molecule_3d` from ``RandomState(seed)``, drawn on in
    turn by each molecule), ranks conformers by a pairwise Lennard-Jones
    energy, relaxes them on it, and prunes them by RMSD."""

    def __init__(self, max_conformers: int = 1, rmsd_threshold: float = 0.5,
                 force_field: str = 'uff', pool_multiplier: int = 10,
                 seed: Optional[int] = None):
        self.max_conformers = max_conformers
        self.rmsd_threshold = rmsd_threshold
        self.force_field = force_field
        self.pool_multiplier = pool_multiplier
        self.rng = np.random.RandomState(seed)

    def generate_conformers(self, mol: Molecule) -> Molecule:
        """Attach a conformer to ``mol`` (in place, unless it has one) and
        return it."""
        if mol.conformer is not None:
            return mol
        coords = embed_molecule_3d(mol, rng=self.rng)
        mol.conformer = [tuple(c) for c in coords]
        return mol

    def embed_molecule(self, mol: Molecule) -> Molecule:
        """:meth:`generate_conformers`."""
        return self.generate_conformers(mol)

    def get_conformer_energies(self, mol: Molecule) -> np.ndarray:
        """``[E]``: the conformer's pairwise ``(1.5/d)^12 - 2 (1.5/d)^6``
        summed over atom pairs."""
        coords = np.asarray(mol.conformer)
        d = np.linalg.norm(coords[:, None] - coords[None, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        e = np.sum(np.power(1.5 / d, 12) - 2 * np.power(1.5 / d, 6)) / 2
        return np.array([e])

    def get_molecule_force_field(self, mol: Molecule, conf_id=None,
                                 **kwargs):
        """An object whose ``CalcEnergy()`` is the conformer's energy
        (:meth:`get_conformer_energies`)."""
        gen = self

        class _ForceField:
            def CalcEnergy(self_inner) -> float:
                return float(gen.get_conformer_energies(mol)[0])
        return _ForceField()

    def minimize_conformers(self, mol: Molecule, n_steps: int = 50,
                            lr: float = 1e-3) -> Molecule:
        """``n_steps`` of gradient descent at rate ``lr`` on the energy of
        :meth:`get_conformer_energies`, in place."""
        coords = np.asarray(mol.conformer, dtype=np.float64)
        if len(coords) < 2:
            return mol
        for _ in range(n_steps):
            diff = coords[:, None] - coords[None, :]
            d = np.linalg.norm(diff, axis=-1)
            np.fill_diagonal(d, np.inf)
            dE = (-12 * np.power(1.5, 12) / np.power(d, 13)
                  + 12 * np.power(1.5, 6) / np.power(d, 7))
            grad = np.sum(dE[..., None] * diff / d[..., None], axis=1)
            coords = coords - lr * grad
        mol.conformer = [tuple(c) for c in coords]
        return mol

    @staticmethod
    def get_conformer_rmsd(conformers) -> np.ndarray:
        """Pairwise RMSD over a list of ``(N, 3)`` conformers."""
        confs = [np.asarray(c, dtype=np.float64) for c in conformers]
        n = len(confs)
        rmsd = np.zeros((n, n))
        for i in range(n):
            for j in range(i + 1, n):
                rmsd[i, j] = rmsd[j, i] = np.sqrt(
                    np.mean(np.sum((confs[i] - confs[j]) ** 2, axis=-1)))
        return rmsd

    def prune_conformers(self, conformers) -> List[np.ndarray]:
        """At most ``max_conformers`` of ``conformers``, greedily in their
        order, each at least ``rmsd_threshold`` from those kept."""
        confs = [np.asarray(c, dtype=np.float64) for c in conformers]
        if not confs:
            return []
        rmsd = self.get_conformer_rmsd(confs)
        keep: List[int] = []
        for i in range(len(confs)):
            if len(keep) >= self.max_conformers:
                break
            if all(rmsd[i, j] >= self.rmsd_threshold for j in keep):
                keep.append(i)
        return [confs[i] for i in keep]


def embed_molecule_3d(mol: Molecule, n_iters: int = 200,
                      rng: Optional[np.random.RandomState] = None
                      ) -> np.ndarray:
    """``(N, 3)`` coordinates of ``mol``'s atoms: classical MDS of the bond
    graph's path lengths (bond lengths by order), seeded noise of 0.05 Å,
    then ``n_iters`` relaxation steps (bonds pulled to their lengths,
    atoms closer than 1.2 Å pushed apart).  ``rng`` defaults to
    ``RandomState(0)``."""
    rng = rng or np.random.RandomState(0)
    n = mol.num_atoms
    if n == 0:
        return np.zeros((0, 3))
    if n == 1:
        return np.zeros((1, 3))
    D = np.full((n, n), np.inf)
    for i in range(n):
        D[i, i] = 0
        dq = deque([i])
        while dq:
            u = dq.popleft()
            for b in mol.atom_bonds(u):
                v = b.other(u)
                w = _BOND_LENGTH.get(b.order, 1.5)
                if D[i, u] + w < D[i, v]:
                    D[i, v] = D[i, u] + w
                    dq.append(v)
    D[~np.isfinite(D)] = D[np.isfinite(D)].max() + 3.0
    J = np.eye(n) - np.ones((n, n)) / n
    B = -0.5 * J @ (D ** 2) @ J
    w, V = np.linalg.eigh(B)
    idx = np.argsort(w)[::-1][:3]
    coords = V[:, idx] * np.sqrt(np.maximum(w[idx], 1e-9))
    coords = coords + rng.normal(scale=0.05, size=coords.shape)
    for _ in range(n_iters):
        grad = np.zeros_like(coords)
        for b in mol.bonds:
            i, j = b.a1, b.a2
            vec = coords[i] - coords[j]
            dist = np.linalg.norm(vec) + 1e-9
            target = _BOND_LENGTH.get(b.order, 1.5)
            f = (dist - target) * vec / dist
            grad[i] -= f
            grad[j] += f
        d = np.linalg.norm(coords[:, None] - coords[None, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        close = d < 1.2
        if close.any():
            for i, j in zip(*np.nonzero(close)):
                vec = coords[i] - coords[j]
                grad[i] += 0.2 * vec / (d[i, j] + 1e-9)
        coords += 0.1 * grad
    return coords
