"""Canonical atom ranks and canonical SMILES (pure Python).

The port's own copy of ``deepchem_tpu/chem/canon.py``: the same ranks
and the same strings, which the scaffold splitter groups molecules by.
Tetrahedral stereo (@/@@) is re-derived for the writer's traversal from
the neighbour order the parser recorded (``Atom.chiral_order``);
double-bond (E/Z) marks are solved over the output's spanning tree.  The
strings are unique per molecular graph, not RDKit's.
"""

from __future__ import annotations

from typing import Dict, List

from .mol import (BOND_DOUBLE, BOND_QUADRUPLE, BOND_SINGLE, BOND_TRIPLE,
                  ORGANIC_SUBSET, Molecule)

_BOND_SYM = {BOND_SINGLE: '', BOND_DOUBLE: '=', BOND_TRIPLE: '#',
             BOND_QUADRUPLE: '$'}


def canonical_ranks(mol: Molecule) -> List[int]:
    """Canonical atom ranks via iterative neighborhood refinement
    (Weininger-style CANGEN without the NP-hard tie handling; determinstic
    tie-break by invariant tuple then refinement history)."""
    n = mol.num_atoms
    if n == 0:
        return []
    invariants = []
    for a in mol.atoms:
        invariants.append((a.atomic_num, a.degree, a.total_hs,
                           a.formal_charge, int(a.is_aromatic),
                           int(a.in_ring), a.isotope))
    # initial ranks from sorted unique invariants (dict lookups: the
    # linear list.index here made ranking O(n^2) per round and was the
    # top profile entry for bulk featurization)
    pos = {inv: i for i, inv in enumerate(sorted(set(invariants)))}
    rank = [pos[inv] for inv in invariants]
    # hoist per-atom (bond-order-key, neighbor) pairs out of the rounds
    nbrs = [[(round(b.order * 2), b.other(i)) for b in mol.atom_bonds(i)]
            for i in range(n)]
    for _ in range(2 * n):
        keys = [(rank[i],
                 tuple(sorted((o, rank[j]) for o, j in nbrs[i])))
                for i in range(n)]
        pos = {k: i for i, k in enumerate(sorted(set(keys)))}
        new_rank = [pos[k] for k in keys]
        if new_rank == rank:
            break
        rank = new_rank
    # break remaining ties deterministically (lowest atom index in each tie
    # class gets the lower rank), then re-refine once
    while len(set(rank)) < n:
        seen: Dict[int, int] = {}
        tie_class = None
        for i in range(n):
            if rank[i] in seen:
                tie_class = rank[i]
                break
            seen[rank[i]] = i
        assert tie_class is not None
        first = min(i for i in range(n) if rank[i] == tie_class)
        rank = [r * 2 + (0 if (i == first) else 1) if r == tie_class
                else r * 2 for i, r in enumerate(rank)]
        # re-normalize + refine
        pos = {r: i for i, r in enumerate(sorted(set(rank)))}
        rank = [pos[r] for r in rank]
        for _ in range(n):
            keys = [(rank[i],
                     tuple(sorted((o, rank[j]) for o, j in nbrs[i])))
                    for i in range(n)]
            pos = {k: i for i, k in enumerate(sorted(set(keys)))}
            new_rank = [pos[k] for k in keys]
            if new_rank == rank:
                break
            rank = new_rank
    return rank


def _perm_parity(src: List, dst: List) -> int:
    """0 = even permutation src->dst, 1 = odd; -1 if not a permutation."""
    if len(src) != len(dst) or set(map(str, src)) != set(map(str, dst)):
        return -1
    pos = {str(x): i for i, x in enumerate(dst)}
    perm = [pos[str(x)] for x in src]
    parity = 0
    for i in range(len(perm)):
        for j in range(i + 1, len(perm)):
            if perm[i] > perm[j]:
                parity ^= 1
    return parity


def _atom_token(mol: Molecule, idx: int,
                chirality_out: str = None) -> str:
    a = mol.atoms[idx]
    sym = a.symbol
    plain = (sym in ORGANIC_SUBSET and a.formal_charge == 0 and
             a.isotope == 0 and a.explicit_hs < 0 and not a.chirality and
             a.num_radical_electrons == 0)
    if a.is_aromatic:
        sym_out = sym.lower()
    else:
        sym_out = sym
    if plain:
        return sym_out
    body = ''
    if a.isotope:
        body += str(a.isotope)
    body += sym_out
    if chirality_out is None and a.chirality and a.chiral_order is None:
        # no neighbor-order bookkeeping (e.g. programmatic construction):
        # emit the stored tag as-is
        chirality_out = a.chirality
    if chirality_out:
        body += chirality_out
    h = a.total_hs
    if h == 1:
        body += 'H'
    elif h > 1:
        body += f'H{h}'
    c = a.formal_charge
    if c == 1:
        body += '+'
    elif c == -1:
        body += '-'
    elif c > 1:
        body += f'+{c}'
    elif c < -1:
        body += f'-{-c}'
    return f'[{body}]'


def mol_to_smiles(mol: Molecule, canonical: bool = True) -> str:
    """Write SMILES.  With ``canonical=True`` atoms are visited in
    canonical rank order so the output is unique per molecule graph.

    For stereo molecules the string is additionally driven to a
    reparse-stable fixed point: rank ties between automorphic chiral
    centers are broken by input index, so a single write can depend on
    the input atom order; re-canonicalizing until stable (taking the
    lexicographic minimum on a 2-cycle) removes that dependence.
    

    Examples
    --------
    >>> from deepchem_tpu_torch.chem import mol_from_smiles, mol_to_smiles
    >>> mol_to_smiles(mol_from_smiles('OCC'))      # canonical form
    'CCO'
    >>> s1 = mol_to_smiles(mol_from_smiles('c1ccccc1C'))
    >>> s2 = mol_to_smiles(mol_from_smiles('Cc1ccccc1'))
    >>> s1 == s2                                   # order-invariant
    True
    """
    out = _mol_to_smiles_once(mol, canonical)
    if not canonical or not any(ch in out for ch in '@/\\'):
        return out
    from .smiles import mol_from_smiles
    seen = [out]
    for _ in range(3):
        m2 = mol_from_smiles(seen[-1])
        if m2 is None:
            return seen[-1]
        nxt = _mol_to_smiles_once(m2, True)
        if nxt == seen[-1]:
            return nxt
        if nxt in seen:                      # cycle: pick deterministically
            return min(seen[seen.index(nxt):] + [nxt])
        seen.append(nxt)
    return min(seen)


def _mol_to_smiles_once(mol: Molecule, canonical: bool = True) -> str:
    """Single-pass SMILES writer (see mol_to_smiles)."""
    n = mol.num_atoms
    if n == 0:
        return ''
    rank = canonical_ranks(mol) if canonical else list(range(n))
    visited = [False] * n
    ring_num_of_bond: Dict[int, int] = {}
    next_ring = [1]
    out: List[str] = []

    # Precompute ring-closure bonds via DFS spanning tree
    def component_smiles(root: int) -> str:
        tokens: List[str] = []
        # first pass: DFS spanning tree in canonical child order (mirrors the
        # write DFS below); every non-tree bond is a ring closure
        seen = {root}
        tree_bonds = set()
        comp_bonds = set()
        stack = [(root, iter(sorted(mol.atom_bonds(root),
                                    key=lambda bb: rank[bb.other(root)])))]
        while stack:
            u, it = stack[-1]
            for b in it:
                comp_bonds.add(b.index)
                v = b.other(u)
                if v not in seen:
                    seen.add(v)
                    tree_bonds.add(b.index)
                    stack.append((v, iter(sorted(
                        mol.atom_bonds(v),
                        key=lambda bb: rank[bb.other(v)]))))
                    break
            else:
                stack.pop()
        back_edges = comp_bonds - tree_bonds

        # --- E/Z: solve '/'-'\\' marks for stereo double bonds ---------
        # marks[bond] = (ref_atom, char): written ref->other displays char
        flip = {'/': '\\', '\\': '/'}
        marks: Dict[int, tuple] = {}

        def _mark_as(bidx: int, u: int, char_u_to_v: str):
            marks[bidx] = (u, char_u_to_v)

        def _mark_char(bidx: int, u: int) -> str:
            ref, ch = marks[bidx]
            return ch if ref == u else flip[ch]

        def _flank(end: int, other_end: int, prefer: int):
            """Pick a markable single tree bond at ``end`` — by CANONICAL
            rank, never by which neighbor the input happened to mark, so
            every writing of one geometry anchors identically.  Returns
            (bond, neighbor, same_side_as_prefer) or None."""
            cands = []
            for b in mol.atom_bonds(end):
                nb = b.other(end)
                if nb == other_end or b.order != BOND_SINGLE \
                        or b.is_aromatic or b.index not in comp_bonds:
                    continue
                # tree bonds preferred, but ring-closure (back-edge)
                # singles are markable too — their digit tokens carry
                # the direction char
                cands.append((b.index not in tree_bonds, rank[nb], b, nb))
            if not cands:
                return None
            _, _, b, nb = min(cands, key=lambda c: (c[0], c[1]))
            return b, nb, nb == prefer

        # canonical processing order + canonical seeding so every parse
        # of the same configuration emits identical marks
        stereo_dbs = sorted(
            (db for db in mol.bonds
             if db.index in comp_bonds and db.stereo
             and db.stereo_atoms is not None),
            key=lambda db: sorted((rank[db.a1], rank[db.a2])))
        for db in stereo_dbs:
            x0, y0 = db.stereo_atoms
            e1, e2 = db.a1, db.a2
            # canonical end order (parse orientation must not matter)
            if rank[e1] > rank[e2]:
                e1, e2 = e2, e1
                x0, y0 = y0, x0
            f1 = _flank(e1, e2, x0)
            f2 = _flank(e2, e1, y0)
            if f1 is None or f2 is None:
                continue
            b1, x, same1 = f1
            b2, y, same2 = f2
            want_trans = (db.stereo == 'trans') ^ (not same1) ^ (not same2)
            # constraint: char(x->e1) == char(e2->y) iff trans.  Anchor on
            # whichever flank is already marked (shared flanks in
            # conjugated systems); seed canonically only when both fresh.
            has1 = b1.index in marks
            has2 = b2.index in marks
            if has1 and has2:
                d1 = _mark_char(b1.index, x)
                want = d1 if want_trans else flip[d1]
                if _mark_char(b2.index, e2) != want:
                    # conflicting constraint (rare odd cycle): this bond's
                    # stereo is dropped from the output
                    continue
            elif has1:
                d1 = _mark_char(b1.index, x)
                _mark_as(b2.index, e2,
                         d1 if want_trans else flip[d1])
            elif has2:
                d2 = _mark_char(b2.index, e2)
                _mark_as(b1.index, x,
                         d2 if want_trans else flip[d2])
            else:
                # seed: '/' as seen from b1's lower-RANK endpoint
                lo = b1.a1 if rank[b1.a1] < rank[b1.a2] else b1.a2
                _mark_as(b1.index, lo, '/')
                d1 = _mark_char(b1.index, x)
                _mark_as(b2.index, e2,
                         d1 if want_trans else flip[d1])

        def bond_sym(b, u: int = -1) -> str:
            if b.is_aromatic:
                return ''
            if b.index in marks and u >= 0:
                return _mark_char(b.index, u)
            s = _BOND_SYM.get(b.order, '')
            # explicit single bond between two aromatic atoms (biphenyl)
            if (s == '' and mol.atoms[b.a1].is_aromatic and
                    mol.atoms[b.a2].is_aromatic and not b.is_aromatic):
                s = '-'
            return s

        def dfs(u: int, from_bond: int) -> None:
            visited[u] = True
            # ring closures at this atom, in canonical neighbor-rank order;
            # numbers are assigned at first encounter so output labels are
            # traversal-ordered (stable across input atom orderings)
            ring_tokens: List[str] = []
            ring_partners: List[int] = []
            for b in sorted(mol.atom_bonds(u),
                            key=lambda bb: rank[bb.other(u)]):
                if b.index in back_edges and b.index != from_bond:
                    if b.index not in ring_num_of_bond:
                        ring_num_of_bond[b.index] = next_ring[0]
                        next_ring[0] += 1
                    num = ring_num_of_bond[b.index]
                    ring_tokens.append(
                        bond_sym(b, u) +
                        (str(num) if num < 10 else f'%{num:02d}'))
                    ring_partners.append(b.other(u))
            children = []
            for b in sorted(mol.atom_bonds(u),
                            key=lambda bb: rank[bb.other(u)]):
                v = b.other(u)
                if not visited[v] and b.index not in back_edges:
                    children.append((b, v))
            # re-derive the tetrahedral tag in THIS traversal's neighbor
            # order (parse order lives in atom.chiral_order)
            a = mol.atoms[u]
            chir_out = None
            if a.chirality and a.chiral_order is not None:
                write_order: List = []
                if from_bond >= 0:
                    write_order.append(mol.bonds[from_bond].other(u))
                if a.total_hs > 0:
                    write_order.append('H')
                write_order += ring_partners
                write_order += [v for (_b, v) in children]
                parity = _perm_parity(a.chiral_order, write_order)
                if parity < 0:
                    chir_out = ''          # bookkeeping mismatch: drop tag
                elif parity == 0:
                    chir_out = a.chirality
                else:
                    chir_out = '@@' if a.chirality == '@' else '@'
            tokens.append(_atom_token(mol, u, chir_out))
            tokens.extend(ring_tokens)
            for ci, (b, v) in enumerate(children):
                last = ci == len(children) - 1
                if not last:
                    tokens.append('(')
                tokens.append(bond_sym(b, u))
                dfs(v, b.index)
                if not last:
                    tokens.append(')')
        dfs(root, -1)
        return ''.join(tokens)

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * n + 100))
    try:
        pieces = []
        roots = []
        for comp in mol.components():
            root = min(comp, key=lambda i: rank[i])
            roots.append(root)
        for root in roots:
            # per-component ring-number space: identical components of a
            # salt/mixture get identical strings regardless of position
            next_ring[0] = 1
            pieces.append(component_smiles(root))
        if canonical:
            # component order must not depend on input atom order (it was
            # the one remaining canonical-uniqueness leak: 16/8014 tox21
            # molecules — all salts — wrote components input-ordered)
            pieces.sort()
        return '.'.join(pieces)
    finally:
        sys.setrecursionlimit(old_limit)
