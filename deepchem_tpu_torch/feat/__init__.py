from deepchem_tpu_torch.feat.base import MolecularFeaturizer
from deepchem_tpu_torch.feat.graph_data import (BatchGraphData, GraphData,
                                                bucket_caps, pad_graph_batch)
from deepchem_tpu_torch.feat.molecule_featurizers import (
    CircularFingerprint, ConvMolFeaturizer, CoulombMatrix, CoulombMatrixEig,
    DMPNNFeaturizer, MolGraphConvFeaturizer, PagtnMolGraphFeaturizer,
    WeaveFeaturizer)
from deepchem_tpu_torch.feat.tokenizers import (BasicSmilesTokenizer,
                                                SmilesTokenizer)

__all__ = ['MolecularFeaturizer', 'GraphData', 'BatchGraphData',
           'pad_graph_batch', 'bucket_caps', 'CircularFingerprint',
           'ConvMolFeaturizer', 'CoulombMatrix', 'CoulombMatrixEig',
           'DMPNNFeaturizer', 'MolGraphConvFeaturizer',
           'PagtnMolGraphFeaturizer', 'WeaveFeaturizer',
           'BasicSmilesTokenizer', 'SmilesTokenizer']
