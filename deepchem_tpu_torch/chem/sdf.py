"""SDF / MDL molblock reader and writer (pure Python).

Covers V2000 connection tables with 3D coordinates: ``mol_from_molblock``
parses one molblock (explicit hydrogens folded into the heavy atoms'
implicit counts, their coordinates dropped), ``parse_sdf`` iterates the
records of SDF text with their ``> <key>`` properties, and
``mol_to_molblock`` writes a molecule back, embedding 3D coordinates
(:func:`embed_molecule_3d`) for one that has none.  The port's own copy
of ``deepchem_tpu/chem/sdf.py``'s reader and writer; a molblock parses to
the same molecule and coordinates in both packages.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

from deepchem_tpu_torch.chem.mol import (ATOMIC_SYMBOL, BOND_AROMATIC,
                                         PERIODIC_TABLE, Atom, Molecule)

_MDL_BOND_ORDER = {1: 1.0, 2: 2.0, 3: 3.0, 4: BOND_AROMATIC}
_MDL_CHARGE = {0: 0, 1: 3, 2: 2, 3: 1, 4: 0, 5: -1, 6: -2, 7: -3}


def mol_from_molblock(block: str) -> Optional[Molecule]:
    """Parse one V2000 molblock; None where it does not parse."""
    try:
        return _parse_molblock(block)
    except (ValueError, IndexError):
        return None


def _parse_molblock(block: str) -> Molecule:
    lines = block.split('\n')
    counts = lines[3]
    natoms = int(counts[0:3])
    nbonds = int(counts[3:6])
    mol = Molecule()
    coords: List[Tuple[float, float, float]] = []
    for i in range(natoms):
        ln = lines[4 + i]
        x, y, z = float(ln[0:10]), float(ln[10:20]), float(ln[20:30])
        sym = ln[31:34].strip()
        if sym not in PERIODIC_TABLE:
            sym = sym.capitalize()
        if sym not in PERIODIC_TABLE:
            raise ValueError(f'unknown element {sym}')
        charge_code = int(ln[36:39]) \
            if len(ln) >= 39 and ln[36:39].strip() else 0
        mol.add_atom(Atom(atomic_num=PERIODIC_TABLE[sym],
                          formal_charge=_MDL_CHARGE.get(charge_code, 0)))
        coords.append((x, y, z))
    for i in range(nbonds):
        ln = lines[4 + natoms + i]
        code = int(ln[6:9])
        mol.add_bond(int(ln[0:3]) - 1, int(ln[3:6]) - 1,
                     order=_MDL_BOND_ORDER.get(code, 1.0),
                     is_aromatic=(code == 4))
    # the property block's charges override the atom lines'
    for ln in lines[4 + natoms + nbonds:]:
        if ln.startswith('M  CHG'):
            parts = ln.split()
            for p in range(int(parts[2])):
                mol.atoms[int(parts[3 + 2 * p]) - 1].formal_charge = \
                    int(parts[4 + 2 * p])
        elif ln.startswith('M  END'):
            break
    mol.conformer = coords
    # explicit hydrogens become implicit counts on the heavy-atom graph,
    # and only the heavy atoms keep coordinates
    if any(a.atomic_num == 1 for a in mol.atoms):
        heavy = [i for i, a in enumerate(mol.atoms) if a.atomic_num != 1]
        sub = mol.subgraph(heavy)
        sub.conformer = [coords[i] for i in heavy]
        return sub
    return mol.finalize()


def parse_sdf(text: str
              ) -> Iterator[Tuple[Optional[Molecule], Dict[str, str]]]:
    """``(molecule, properties)`` for each record of SDF ``text``; the
    molecule is None where its molblock does not parse or is absent."""
    for idx, record in enumerate(text.split('$$$$')):
        # only the separator's own newline goes: an empty title line is
        # the molblock's first line
        if idx > 0:
            if record.startswith('\r\n'):
                record = record[2:]
            elif record.startswith('\n'):
                record = record[1:]
        record = record.rstrip('\n')
        if not record.strip():
            continue
        if 'M  END' in record:
            mol_part, _, prop_part = record.partition('M  END')
            mol = mol_from_molblock(mol_part + 'M  END')
        else:
            mol, prop_part = None, record
        props: Dict[str, str] = {}
        key = None
        buf: List[str] = []
        for ln in prop_part.split('\n'):
            if ln.startswith('>'):
                if key is not None:
                    props[key] = '\n'.join(buf).strip()
                lo, hi = ln.find('<'), ln.rfind('>')
                key = ln[lo + 1:hi] if 0 <= lo < hi else None
                buf = []
            elif key is not None:
                buf.append(ln)
        if key is not None:
            props[key] = '\n'.join(buf).strip()
        yield mol, props


def mol_to_molblock(mol: Molecule, name: str = '') -> str:
    """A V2000 molblock of ``mol``: its conformer's coordinates, or an
    embedding's (:func:`embed_molecule_3d`) where it has none."""
    coords = mol.conformer
    if coords is None:
        from deepchem_tpu_torch.utils.conformers import embed_molecule_3d
        coords = [(float(x), float(y), float(z))
                  for x, y, z in embed_molecule_3d(mol)]
    lines = [name, '     dctpu          3D', '',
             f'{mol.num_atoms:3d}{mol.num_bonds:3d}  0  0  0  0  0  0  0  0'
             '999 V2000']
    for atom, (x, y, z) in zip(mol.atoms, coords):
        sym = ATOMIC_SYMBOL.get(atom.atomic_num, '*')
        lines.append(f'{x:10.4f}{y:10.4f}{z:10.4f} {sym:<3s} 0  0  0  0  0'
                     '  0  0  0  0  0  0  0')
    rev = {1.0: 1, 2.0: 2, 3.0: 3, 1.5: 4}
    for b in mol.bonds:
        lines.append(f'{b.a1 + 1:3d}{b.a2 + 1:3d}{rev.get(b.order, 1):3d}  0')
    charged = [(i + 1, a.formal_charge)
               for i, a in enumerate(mol.atoms) if a.formal_charge]
    if charged:
        parts = ' '.join(f'{i:3d} {c:3d}' for i, c in charged)
        lines.append(f'M  CHG{len(charged):3d} {parts}')
    lines.append('M  END')
    return '\n'.join(lines) + '\n'
