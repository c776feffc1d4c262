"""SMILES parser (pure Python, no RDKit).

The Daylight SMILES grammar subset drug-discovery datasets use:
organic-subset atoms, bracket atoms with isotope/charge/H-count/
chirality/atom-map, aromatic lowercase atoms, all bond symbols, branches,
ring-closure digits (incl. ``%nn``) and dot disconnections.  The port's
own copy of ``deepchem_tpu/chem/smiles.py``.  A bond keeps its ``/`` or
``\\`` mark, and a double bond with a marked single bond at each end gets
its cis/trans configuration (MolGraphConvFeaturizer's stereo one-hot);
tetrahedral ``@``/``@@`` is kept on the atom.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .mol import (Atom, Molecule, PERIODIC_TABLE, ORGANIC_SUBSET,
                  BOND_SINGLE, BOND_DOUBLE, BOND_TRIPLE, BOND_QUADRUPLE,
                  BOND_AROMATIC, CHI_CW, CHI_CCW)

_AROMATIC_ORGANIC = {'b', 'c', 'n', 'o', 'p', 's'}
_BOND_CHARS = {'-': BOND_SINGLE, '=': BOND_DOUBLE, '#': BOND_TRIPLE,
               '$': BOND_QUADRUPLE, ':': BOND_AROMATIC,
               '/': BOND_SINGLE, '\\': BOND_SINGLE}
_TWO_LETTER = ('Cl', 'Br')
_FLIP = {'/': '\\', '\\': '/'}


class SmilesParseError(ValueError):
    pass


def _parse_bracket_atom(s: str, i: int) -> Tuple[Atom, int]:
    """Parse a bracket atom starting at ``s[i] == '['``; return (atom, next_i)."""
    j = s.index(']', i)
    body = s[i + 1:j]
    k = 0
    n = len(body)
    isotope = 0
    while k < n and body[k].isdigit():
        isotope = isotope * 10 + int(body[k])
        k += 1
    aromatic = False
    if k < n and body[k] == '*':
        symbol = '*'
        k += 1
    else:
        sym2 = body[k:k + 2]
        if sym2 in ('se', 'as', 'te', 'si'):
            symbol = sym2.capitalize()
            aromatic = True
            k += 2
        elif (len(sym2) == 2 and sym2[0].isupper() and sym2[1].islower()
              and sym2 in PERIODIC_TABLE):
            symbol = sym2
            k += 2
        elif body[k].islower() and body[k] in _AROMATIC_ORGANIC:
            symbol = body[k].upper()
            aromatic = True
            k += 1
        elif body[k].isupper():
            symbol = body[k]
            k += 1
        else:
            raise SmilesParseError(f'bad bracket atom: [{body}]')
    if symbol not in PERIODIC_TABLE:
        raise SmilesParseError(f'unknown element {symbol!r} in [{body}]')
    atom = Atom(atomic_num=PERIODIC_TABLE[symbol], isotope=isotope,
                is_aromatic=aromatic, explicit_hs=0)
    if k < n and body[k] == '@':
        if k + 1 < n and body[k + 1] == '@':
            atom.chirality = CHI_CW
            k += 2
        else:
            atom.chirality = CHI_CCW
            k += 1
            # skip extended chirality classes (@TH1, @AL1, @SP1 ...)
            for tag in ('TH', 'AL', 'SP', 'TB', 'OH'):
                if body[k:k + len(tag)] == tag:
                    k += len(tag)
                    while k < n and body[k].isdigit():
                        k += 1
                    break
    if k < n and body[k] == 'H':
        k += 1
        h = 1
        if k < n and body[k].isdigit():
            h = 0
            while k < n and body[k].isdigit():
                h = h * 10 + int(body[k])
                k += 1
        atom.explicit_hs = h
    charge = 0
    while k < n and body[k] in '+-':
        sign = 1 if body[k] == '+' else -1
        k += 1
        if k < n and body[k].isdigit():
            mag = 0
            while k < n and body[k].isdigit():
                mag = mag * 10 + int(body[k])
                k += 1
            charge += sign * mag
        else:
            charge += sign
    atom.formal_charge = charge
    if k < n and body[k] == ':':          # atom map: read and dropped
        k += 1
        while k < n and body[k].isdigit():
            k += 1
    if k != n:
        raise SmilesParseError(f'trailing junk in bracket atom: [{body}]')
    return atom, j + 1


def mol_from_smiles(smiles: str) -> Optional[Molecule]:
    """Parse ``smiles`` into a :class:`Molecule`; returns None on failure
    (RDKit's ``MolFromSmiles`` contract, which the featurizer loop relies
    on to drop bad datapoints).

    >>> mol = mol_from_smiles('CCO')
    >>> mol.num_atoms, mol.num_bonds
    (3, 2)
    >>> mol_from_smiles('not a smiles') is None
    True
    """
    try:
        return _parse(smiles)
    except (SmilesParseError, ValueError, IndexError):
        return None


def _bond_order(mol: Molecule, a: int, b: int, pending: Optional[float],
                aromatic: bool) -> Tuple[float, bool]:
    """Order of a bond written with symbol ``pending`` (None: implicit —
    aromatic between two aromatic atoms, else single)."""
    if pending is None:
        if mol.atoms[a].is_aromatic and mol.atoms[b].is_aromatic:
            return BOND_AROMATIC, True
        return BOND_SINGLE, aromatic
    return pending, aromatic or pending == BOND_AROMATIC


def _parse(smiles: str) -> Molecule:
    smiles = smiles.strip()
    if not smiles:
        raise SmilesParseError('empty SMILES')
    mol = Molecule()
    prev_atom: List[Optional[int]] = [None]   # stack via branch parens
    pending_bond: Optional[float] = None
    pending_aromatic_bond = False
    pending_dir = ''
    # each atom's neighbours in written order, for tetrahedral chirality: a
    # ring-closure digit holds a slot filled when the ring closes, 'H' the
    # bracket hydrogen
    nbr_order: dict = {}
    ring_bonds = {}    # ring-closure number -> (atom_idx, order|None, dir,
    #                    slot)
    i = 0
    n = len(smiles)
    while i < n:
        c = smiles[i]
        if c in _BOND_CHARS:
            pending_bond = _BOND_CHARS[c]
            pending_aromatic_bond = (c == ':')
            pending_dir = c if c in '/\\' else ''
            i += 1
            continue
        if c == '.':
            if pending_bond is not None:
                raise SmilesParseError('bond before dot')
            prev_atom[-1] = None
            i += 1
            continue
        if c == '(':
            prev_atom.append(prev_atom[-1])
            i += 1
            continue
        if c == ')':
            if len(prev_atom) == 1:
                raise SmilesParseError('unbalanced parens')
            prev_atom.pop()
            i += 1
            continue
        if c.isdigit() or c == '%':
            if c == '%':
                if i + 2 >= n or not smiles[i + 1:i + 3].isdigit():
                    raise SmilesParseError('bad %ring closure')
                num = int(smiles[i + 1:i + 3])
                i += 3
            else:
                num = int(c)
                i += 1
            cur = prev_atom[-1]
            if cur is None:
                raise SmilesParseError('ring closure with no atom')
            if num in ring_bonds:
                other, order0, dir0, slot = ring_bonds.pop(num)
                pending = pending_bond if pending_bond is not None else order0
                order, arom = _bond_order(mol, cur, other, pending,
                                          pending_aromatic_bond)
                # the bond is stored (other, cur): a mark written at the
                # closing digit (cur to other) is flipped
                sdir = _FLIP[pending_dir] if pending_dir else dir0
                mol.add_bond(other, cur, order=order, is_aromatic=arom,
                             stereo_dir=sdir)
                slot[0] = cur
                nbr_order.setdefault(cur, []).append([other])
            else:
                slot = [None]
                ring_bonds[num] = (cur, pending_bond, pending_dir, slot)
                nbr_order.setdefault(cur, []).append(slot)
            pending_bond = None
            pending_aromatic_bond = False
            pending_dir = ''
            continue
        if c == '[':
            atom, i = _parse_bracket_atom(smiles, i)
        elif smiles[i:i + 2] in _TWO_LETTER:
            atom = Atom(atomic_num=PERIODIC_TABLE[smiles[i:i + 2]])
            i += 2
        elif c in ORGANIC_SUBSET and c != '*':
            atom = Atom(atomic_num=PERIODIC_TABLE[c])
            i += 1
        elif c == '*':
            atom = Atom(atomic_num=0)
            i += 1
        elif c in _AROMATIC_ORGANIC:
            atom = Atom(atomic_num=PERIODIC_TABLE[c.upper()], is_aromatic=True)
            i += 1
        else:
            raise SmilesParseError(f'unexpected char {c!r} at {i}')
        idx = mol.add_atom(atom)
        cur = prev_atom[-1]
        slots = nbr_order.setdefault(idx, [])
        if cur is not None:
            slots.append([cur])
            nbr_order.setdefault(cur, []).append([idx])
        if atom.chirality and atom.explicit_hs and atom.explicit_hs > 0:
            slots.append(['H'])
        if cur is not None:
            order, arom = _bond_order(mol, cur, idx, pending_bond,
                                      pending_aromatic_bond)
            mol.add_bond(cur, idx, order=order, is_aromatic=arom,
                         stereo_dir=pending_dir)
        pending_bond = None
        pending_aromatic_bond = False
        pending_dir = ''
        prev_atom[-1] = idx
    if len(prev_atom) != 1:
        raise SmilesParseError('unbalanced parens at end')
    if ring_bonds:
        raise SmilesParseError(f'unclosed ring bonds: {sorted(ring_bonds)}')
    for idx, slots in nbr_order.items():
        if mol.atoms[idx].chirality:
            mol.atoms[idx].chiral_order = [s[0] for s in slots]
    out = mol.finalize()
    _perceive_double_bond_stereo(out)
    return out


def _perceive_double_bond_stereo(mol: Molecule) -> None:
    """Each non-aromatic double bond with a marked single bond at both
    ends gets ``stereo`` ('cis' or 'trans') and ``stereo_atoms``: the
    first marked neighbour of each end, in bond order."""

    def marked_neighbor(end: int, exclude: int):
        """(x, the mark read from x to end) of end's first marked single
        bond to another atom than ``exclude``."""
        for b in mol.atom_bonds(end):
            x = b.other(end)
            if x == exclude or b.order != BOND_SINGLE or not b.stereo_dir:
                continue
            return x, b.stereo_dir if b.a1 == x else _FLIP[b.stereo_dir]
        return None

    for db in mol.bonds:
        if db.order != BOND_DOUBLE or db.is_aromatic:
            continue
        m1 = marked_neighbor(db.a1, db.a2)
        m2 = marked_neighbor(db.a2, db.a1)
        if m1 is None or m2 is None:
            continue
        (x, d_x_to_a1), (y, d_y_to_a2) = m1, m2
        db.stereo = 'trans' if d_x_to_a1 == _FLIP[d_y_to_a2] else 'cis'
        db.stereo_atoms = (x, y)
