from deepchem_tpu_torch.feat.base import MolecularFeaturizer
from deepchem_tpu_torch.feat.graph_data import (BatchGraphData, GraphData,
                                                bucket_caps, pad_graph_batch)
from deepchem_tpu_torch.feat.molecule_featurizers import (
    ConvMolFeaturizer, DMPNNFeaturizer, MolGraphConvFeaturizer,
    PagtnMolGraphFeaturizer)
from deepchem_tpu_torch.feat.tokenizers import (BasicSmilesTokenizer,
                                                SmilesTokenizer)

__all__ = ['MolecularFeaturizer', 'GraphData', 'BatchGraphData',
           'pad_graph_batch', 'bucket_caps', 'ConvMolFeaturizer',
           'DMPNNFeaturizer', 'MolGraphConvFeaturizer',
           'PagtnMolGraphFeaturizer',
           'BasicSmilesTokenizer', 'SmilesTokenizer']
