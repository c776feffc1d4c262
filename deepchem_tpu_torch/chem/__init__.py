"""Self-contained cheminformatics core: SMILES parsing, the molecule
perception (implicit H, rings, aromaticity, hybridization) under the
featurizers, and Morgan fingerprints."""

from deepchem_tpu_torch.chem.fingerprints import (bulk_tanimoto,
                                                  morgan_fingerprint,
                                                  morgan_fingerprint_counts,
                                                  sparse_morgan_fingerprint,
                                                  tanimoto)
from deepchem_tpu_torch.chem.mol import Atom, Bond, Molecule
from deepchem_tpu_torch.chem.smiles import SmilesParseError, mol_from_smiles

__all__ = ['Atom', 'Bond', 'Molecule', 'SmilesParseError', 'bulk_tanimoto',
           'mol_from_smiles', 'morgan_fingerprint',
           'morgan_fingerprint_counts', 'sparse_morgan_fingerprint',
           'tanimoto']
