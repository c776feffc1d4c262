"""deepchem_tpu_torch: the PyTorch and CUDA port of ``deepchem_tpu``.

Plain tensor code is PyTorch; the JAX package's Pallas kernels are CUDA
kernels written for Hopper (``csrc/``), built at first use
(``kernels/build.py``).  Entry points run on the current CUDA device unless
the caller passes ``device='cpu'``.
"""

from deepchem_tpu_torch.data import NumpyDataset
from deepchem_tpu_torch.feat import (CGCNNFeaturizer, ConvMolFeaturizer,
                                     CoulombMatrix, DMPNNFeaturizer,
                                     ElementPropertyFingerprint,
                                     ElemNetFeaturizer,
                                     EquivariantGraphFeaturizer,
                                     LCNNFeaturizer, MolGraphConvFeaturizer,
                                     MXMNetFeaturizer,
                                     PagtnMolGraphFeaturizer,
                                     RDKitConformerFeaturizer,
                                     SineCoulombMatrix, SmilesTokenizer,
                                     WeaveFeaturizer)
from deepchem_tpu_torch.metrics import (Metric, mae_score, pearson_r2_score,
                                        rms_score, roc_auc_score)
from deepchem_tpu_torch.models import (AtomicConvFeaturizer,
                                       AtomicConvModel, AttentiveFPModel,
                                       BertEncoderMLM,
                                       CGCNNModel, DAGModel, DAGTransformer,
                                       DMPNNModel, DTNNModel, ElemNetModel,
                                       GATModel, GCNModel, GNNModular,
                                       GraphConvModel, GroverFeaturizer,
                                       GroverModel, InfoGraphModel,
                                       InfoGraphStarModel, InfoMax3DModular,
                                       LCNNModel, MATFeaturizer, MATModel,
                                       MEGNetModel, MPNNModel,
                                       MXMNetModel, PagtnModel, PNAModel,
                                       SupportGraphClassifier, WeaveModel,
                                       AspuruGuzikAutoEncoder, ChemCeption,
                                       CNN, InceptionV3Model, OneFormer,
                                       SeqToSeq, Smiles2Vec, TextCNNModel,
                                       UNetModel)
from deepchem_tpu_torch.trans import NormalizationTransformer
from deepchem_tpu_torch.utils.evaluate import Evaluator, GeneratorEvaluator

__all__ = ['AspuruGuzikAutoEncoder', 'CNN', 'ChemCeption',
           'InceptionV3Model', 'OneFormer', 'SeqToSeq', 'Smiles2Vec',
           'TextCNNModel', 'UNetModel',
           'AtomicConvFeaturizer', 'AtomicConvModel', 'AttentiveFPModel',
           'BertEncoderMLM', 'CGCNNFeaturizer',
           'CGCNNModel', 'ConvMolFeaturizer', 'CoulombMatrix', 'DAGModel',
           'DAGTransformer', 'DMPNNFeaturizer', 'DMPNNModel', 'DTNNModel',
           'ElemNetFeaturizer', 'ElemNetModel', 'ElementPropertyFingerprint',
           'EquivariantGraphFeaturizer',
           'Evaluator', 'GATModel', 'GCNModel', 'GNNModular',
           'GeneratorEvaluator', 'GraphConvModel', 'GroverFeaturizer',
           'GroverModel', 'InfoGraphModel',
           'InfoGraphStarModel', 'InfoMax3DModular', 'LCNNFeaturizer',
           'LCNNModel', 'MATFeaturizer', 'MATModel', 'MEGNetModel',
           'Metric', 'MolGraphConvFeaturizer',
           'MPNNModel', 'MXMNetFeaturizer', 'MXMNetModel',
           'NormalizationTransformer', 'NumpyDataset',
           'PNAModel', 'PagtnMolGraphFeaturizer', 'PagtnModel',
           'RDKitConformerFeaturizer', 'SineCoulombMatrix',
           'SmilesTokenizer', 'SupportGraphClassifier', 'WeaveFeaturizer',
           'WeaveModel', 'mae_score',
           'pearson_r2_score', 'rms_score',
           'roc_auc_score']
