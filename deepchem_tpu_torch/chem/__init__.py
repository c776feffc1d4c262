"""Self-contained cheminformatics core: SMILES parsing and writing, the
molecule perception (implicit H, rings, aromaticity, hybridization)
under the featurizers, Morgan fingerprints and Murcko scaffolds."""

from deepchem_tpu_torch.chem.canon import canonical_ranks, mol_to_smiles
from deepchem_tpu_torch.chem.fingerprints import (bulk_tanimoto,
                                                  morgan_fingerprint,
                                                  morgan_fingerprint_counts,
                                                  sparse_morgan_fingerprint,
                                                  tanimoto)
from deepchem_tpu_torch.chem.mol import Atom, Bond, Molecule
from deepchem_tpu_torch.chem.scaffolds import murcko_scaffold, scaffold_smiles
from deepchem_tpu_torch.chem.smiles import SmilesParseError, mol_from_smiles

__all__ = ['Atom', 'Bond', 'Molecule', 'SmilesParseError', 'bulk_tanimoto',
           'canonical_ranks', 'mol_from_smiles', 'mol_to_smiles',
           'morgan_fingerprint', 'morgan_fingerprint_counts',
           'murcko_scaffold', 'scaffold_smiles', 'sparse_morgan_fingerprint',
           'tanimoto']
