from deepchem_tpu_torch.molnet.check_availability import (CheckFeaturizer,
                                                          CheckSplit)
from deepchem_tpu_torch.molnet.load_function import (
    load_bace_classification, load_bace_regression, load_bandgap, load_bbbp,
    load_chembl, load_chembl25, load_clearance, load_clintox, load_delaney,
    load_factors, load_flash_points, load_freesolv, load_hiv, load_hopv,
    load_hppb, load_kaggle, load_kinase, load_lipo,
    load_membrane_permeability, load_mp_formation_energy,
    load_mp_metallicity, load_muv, load_nci, load_pcba, load_perovskite,
    load_Platinum_Adsorption, load_ppb, load_qm7, load_qm8, load_qm9,
    load_sampl, load_sider, load_sweetlead, load_thermosol, load_tox21,
    load_toxcast, load_uspto, load_uv, load_zinc15)
from deepchem_tpu_torch.molnet.loader import (TransformerGenerator,
                                              _MolnetLoader, featurizers,
                                              splitters, transformers)

#: the sweetlead loader under its DeepChem name
load_sweet = load_sweetlead

__all__ = [
    '_MolnetLoader', 'TransformerGenerator', 'featurizers', 'splitters',
    'transformers', 'CheckFeaturizer', 'CheckSplit', 'load_tox21',
    'load_delaney', 'load_freesolv', 'load_sampl', 'load_lipo',
    'load_bace_classification', 'load_bace_regression', 'load_bbbp',
    'load_clintox', 'load_hiv', 'load_sider', 'load_muv', 'load_qm7',
    'load_qm8', 'load_qm9', 'load_thermosol', 'load_hppb', 'load_clearance',
    'load_chembl', 'load_bandgap', 'load_perovskite',
    'load_mp_formation_energy', 'load_mp_metallicity', 'load_toxcast',
    'load_pcba', 'load_nci', 'load_ppb', 'load_sweetlead', 'load_sweet',
    'load_chembl25', 'load_hopv', 'load_kaggle', 'load_factors',
    'load_kinase', 'load_uv', 'load_zinc15', 'load_uspto',
    'load_membrane_permeability', 'load_flash_points',
    'load_Platinum_Adsorption',
]
