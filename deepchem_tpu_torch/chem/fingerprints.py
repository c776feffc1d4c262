"""Morgan (ECFP-style) circular fingerprints, in plain Python.

Counterpart of ``deepchem_tpu/chem/fingerprints.py``: the same initial
invariants, environment hashes (CRC-32 of little-endian int32 fields, so
no dependence on ``PYTHONHASHSEED``) and duplicate-environment rule, so
every bit and count equals the JAX package's on the same molecule.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Sequence, Set

import numpy as np

from deepchem_tpu_torch.chem.mol import Molecule


def _hash_ints(ints: Sequence[int]) -> int:
    """Stable 32-bit hash of an int sequence: CRC-32 of its low 31 bits
    packed as little-endian int32."""
    data = struct.pack(f'<{len(ints)}i', *[int(x) & 0x7fffffff for x in ints])
    return zlib.crc32(data) & 0xffffffff


def _initial_invariants(mol: Molecule, use_chirality: bool,
                        use_features: bool) -> List[int]:
    """Each atom's radius-0 hash: of (atomic number, degree, total H,
    charge, in ring, aromatic, radical electrons, rounded mass), or with
    ``use_features`` of pharmacophore flags (donor, acceptor, aromatic,
    halogen, cation, anion); with ``use_chirality`` the length of the
    chirality tag is appended."""
    invs = []
    for a in mol.atoms:
        if use_features:
            donor = int(a.atomic_num in (7, 8) and a.total_hs > 0)
            acceptor = int(a.atomic_num in (7, 8) and a.formal_charge <= 0)
            halogen = int(a.atomic_num in (9, 17, 35, 53))
            fields = (donor, acceptor, int(a.is_aromatic), halogen,
                      int(a.formal_charge > 0), int(a.formal_charge < 0))
        else:
            fields = (a.atomic_num, a.degree, a.total_hs, a.formal_charge,
                      int(a.in_ring), int(a.is_aromatic),
                      a.num_radical_electrons, round(a.mass))
        if use_chirality:
            fields = fields + (len(a.chirality),)
        invs.append(_hash_ints(fields))
    return invs


def morgan_fingerprint_counts(mol: Molecule, radius: int = 2,
                              use_chirality: bool = False,
                              use_bond_types: bool = True,
                              use_features: bool = False) -> Dict[int, int]:
    """``{feature hash: count}`` over every atom environment up to
    ``radius``.  Round ``r`` hashes ``(r, own hash, sorted (bond order code,
    neighbour hash) pairs)``; an environment is counted when it grew in
    that round and its bond set was not counted before."""
    invs = _initial_invariants(mol, use_chirality, use_features)
    n = mol.num_atoms
    env_bonds: List[Set[int]] = [set() for _ in range(n)]
    seen_envs: Dict[frozenset, int] = {}
    features: Dict[int, int] = {}

    def emit(h: int, bonds: Set[int]) -> None:
        key = frozenset(bonds)
        if key and key in seen_envs:
            return                   # the same environment counted already
        if key:
            seen_envs[key] = h
        features[h] = features.get(h, 0) + 1

    for i in range(n):
        emit(invs[i], set())
    current = list(invs)
    for r in range(1, radius + 1):
        new_invs, new_envs = [], []
        for i in range(n):
            nbrs = []
            env = set(env_bonds[i])
            for b in mol.atom_bonds(i):
                j = b.other(i)
                order_code = int(round(b.order * 2)) if use_bond_types else 1
                nbrs.append((order_code, current[j]))
                env.add(b.index)
                env |= env_bonds[j]
            nbrs.sort()
            flat: List[int] = [r, current[i]]
            for oc, inv in nbrs:
                flat.extend((oc, inv))
            new_invs.append(_hash_ints(flat))
            new_envs.append(env)
        for i in range(n):
            if len(new_envs[i]) > len(env_bonds[i]):
                emit(new_invs[i], new_envs[i])
        current, env_bonds = new_invs, new_envs
    return features


def morgan_fingerprint(mol: Molecule, radius: int = 2, n_bits: int = 2048,
                       use_chirality: bool = False,
                       use_bond_types: bool = True,
                       use_features: bool = False,
                       counts: bool = False) -> np.ndarray:
    """The fingerprint folded to ``n_bits`` (hash modulo ``n_bits``): uint8
    bits, or float32 counts with ``counts``."""
    feats = morgan_fingerprint_counts(mol, radius, use_chirality,
                                      use_bond_types, use_features)
    out = np.zeros(n_bits, dtype=np.float32 if counts else np.uint8)
    for h, c in feats.items():
        if counts:
            out[h % n_bits] += c
        else:
            out[h % n_bits] = 1
    return out


def sparse_morgan_fingerprint(mol: Molecule, radius: int = 2,
                              **kwargs) -> Dict[int, Dict[str, object]]:
    """The unfolded fingerprint: ``{hash: {'count': c}}``."""
    feats = morgan_fingerprint_counts(mol, radius, **kwargs)
    return {h: {'count': c} for h, c in feats.items()}


def tanimoto(fp1: np.ndarray, fp2: np.ndarray) -> float:
    """Tanimoto similarity of two binary fingerprints (0 for two empty
    ones)."""
    a = np.asarray(fp1).astype(bool)
    b = np.asarray(fp2).astype(bool)
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return float(inter) / float(union) if union else 0.0


def bulk_tanimoto(fp: np.ndarray, fps: np.ndarray) -> np.ndarray:
    """Tanimoto of one fingerprint against each row of ``fps``."""
    a = np.asarray(fp).astype(bool)
    B = np.asarray(fps).astype(bool)
    inter = np.logical_and(B, a[None, :]).sum(axis=1)
    union = np.logical_or(B, a[None, :]).sum(axis=1)
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0)
