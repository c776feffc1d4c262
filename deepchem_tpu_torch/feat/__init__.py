from deepchem_tpu_torch.feat.base import Featurizer, MolecularFeaturizer
from deepchem_tpu_torch.feat.conformer_featurizers import (
    EquivariantGraphFeaturizer, MXMNetFeaturizer, RDKitConformerFeaturizer)
from deepchem_tpu_torch.feat.crystal_featurizers import (CGCNNFeaturizer,
                                                         LCNNFeaturizer)
from deepchem_tpu_torch.feat.graph_data import (BatchGraphData, GraphData,
                                                bucket_caps, pad_graph_batch)
from deepchem_tpu_torch.feat.molecule_featurizers import (
    CircularFingerprint, ConvMolFeaturizer, CoulombMatrix, CoulombMatrixEig,
    DMPNNFeaturizer, MolGraphConvFeaturizer, PagtnMolGraphFeaturizer,
    WeaveFeaturizer)
from deepchem_tpu_torch.feat.material_featurizers import (
    ElementPropertyFingerprint, ElemNetFeaturizer, SineCoulombMatrix)
from deepchem_tpu_torch.feat.tokenizers import (BasicSmilesTokenizer,
                                                SmilesTokenizer)

__all__ = ['Featurizer', 'MolecularFeaturizer', 'GraphData', 'BatchGraphData',
           'pad_graph_batch', 'bucket_caps', 'CircularFingerprint',
           'ConvMolFeaturizer', 'CoulombMatrix', 'CoulombMatrixEig',
           'DMPNNFeaturizer', 'MolGraphConvFeaturizer',
           'PagtnMolGraphFeaturizer', 'WeaveFeaturizer',
           'BasicSmilesTokenizer', 'SmilesTokenizer', 'CGCNNFeaturizer',
           'LCNNFeaturizer', 'ElementPropertyFingerprint',
           'ElemNetFeaturizer', 'SineCoulombMatrix',
           'RDKitConformerFeaturizer', 'EquivariantGraphFeaturizer',
           'MXMNetFeaturizer']
