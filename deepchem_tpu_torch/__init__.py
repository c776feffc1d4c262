"""deepchem_tpu_torch: the PyTorch and CUDA port of ``deepchem_tpu``.

Plain tensor code is PyTorch; the JAX package's Pallas kernels are CUDA
kernels written for Hopper (``csrc/``), built at first use
(``kernels/build.py``).  Entry points run on the current CUDA device unless
the caller passes ``device='cpu'``.
"""

from deepchem_tpu_torch.data import NumpyDataset
from deepchem_tpu_torch.feat import (ConvMolFeaturizer, DMPNNFeaturizer,
                                     MolGraphConvFeaturizer,
                                     PagtnMolGraphFeaturizer, SmilesTokenizer)
from deepchem_tpu_torch.metrics import (Metric, mae_score, pearson_r2_score,
                                        rms_score, roc_auc_score)
from deepchem_tpu_torch.models import (AttentiveFPModel, BertEncoderMLM,
                                       DMPNNModel, GATModel, GCNModel,
                                       GNNModular, GraphConvModel,
                                       InfoGraphModel, InfoGraphStarModel,
                                       MPNNModel, PagtnModel, PNAModel)
from deepchem_tpu_torch.trans import NormalizationTransformer
from deepchem_tpu_torch.utils.evaluate import Evaluator, GeneratorEvaluator

__all__ = ['AttentiveFPModel', 'BertEncoderMLM', 'ConvMolFeaturizer',
           'DMPNNFeaturizer', 'DMPNNModel', 'Evaluator', 'GATModel',
           'GCNModel', 'GNNModular', 'GeneratorEvaluator',
           'GraphConvModel', 'InfoGraphModel', 'InfoGraphStarModel', 'Metric',
           'MolGraphConvFeaturizer', 'MPNNModel', 'NormalizationTransformer',
           'NumpyDataset', 'PNAModel', 'PagtnMolGraphFeaturizer',
           'PagtnModel',
           'SmilesTokenizer', 'mae_score', 'pearson_r2_score', 'rms_score',
           'roc_auc_score']
