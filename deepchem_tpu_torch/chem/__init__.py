"""Self-contained cheminformatics core: SMILES parsing and the molecule
perception (implicit H, rings, aromaticity, hybridization) under the
featurizers."""

from deepchem_tpu_torch.chem.mol import Atom, Bond, Molecule
from deepchem_tpu_torch.chem.smiles import SmilesParseError, mol_from_smiles

__all__ = ['Atom', 'Bond', 'Molecule', 'SmilesParseError', 'mol_from_smiles']
