from deepchem_tpu_torch.models.bert_encoder import (BertEncoderMLM,
                                                    flash_or_xla_attention,
                                                    mlm_loss)
from deepchem_tpu_torch.models.convert import (encoder_params_from_flax,
                                               params_from_flax)
from deepchem_tpu_torch.models.dag import DAGModel, DAGTransformer
from deepchem_tpu_torch.models.dmpnn import DMPNNModel
from deepchem_tpu_torch.models.fcnet import (MultitaskClassifier,
                                             MultitaskFitTransformRegressor,
                                             MultitaskRegressor,
                                             RobustMultitaskClassifier,
                                             RobustMultitaskRegressor)
from deepchem_tpu_torch.models.gnn3d import (InfoMax3DModular, Net3DLayer,
                                             fourier_encode_dist, ntxent_loss)
from deepchem_tpu_torch.models.gnn_modular import GNNModular, ModularModel
from deepchem_tpu_torch.models.graph_layers import (AttentiveFPLayer,
                                                    DTNNEmbedding, DTNNStep,
                                                    EdgeNetworkMPNN,
                                                    EGNNLayer, GATLayer,
                                                    GCNLayer, GraphConv,
                                                    GraphGather, GRUCell,
                                                    LSTMCell, MaskedBatchNorm,
                                                    SetGather, WeaveGather,
                                                    WeaveLayer, graph_pool_max)
from deepchem_tpu_torch.models.graph_models import (AttentiveFPModel,
                                                    GATModel, GCNModel,
                                                    GraphConvModel,
                                                    GraphModel, MPNNModel,
                                                    PagtnLayer, PagtnModel)
from deepchem_tpu_torch.models.infograph import (InfoGraphModel,
                                                 InfoGraphStarModel)
from deepchem_tpu_torch.models.atomic_conv import (
    AtomicConvFeaturizer, AtomicConvModel, AtomicConvolution,
    ComplexNeighborListFragmentAtomicCoordinates, ani_symmetry_features,
    compute_neighbor_list, neighbor_dict, pdb_atoms)
from deepchem_tpu_torch.models.base import Model
from deepchem_tpu_torch.models.callbacks import ValidationCallback
from deepchem_tpu_torch.models.low_data import (AttnLSTMEmbedding,
                                                IterRefLSTMEmbedding,
                                                SupportGraphClassifier,
                                                cosine_dist)
from deepchem_tpu_torch.models.losses import (
    BinaryCrossEntropy, CategoricalCrossEntropy, DeepGraphInfomaxLoss,
    EdgePredictionLoss, GlobalMutualInformationLoss, GraphEdgeMaskingLoss,
    GraphNodeMaskingLoss, HingeLoss, HuberLoss, L1Loss, L2Loss,
    LocalMutualInformationLoss, Loss, PoissonLoss, ShannonEntropy,
    SigmoidCrossEntropy, SoftmaxCrossEntropy, SparseSoftmaxCrossEntropy,
    SquaredHingeLoss, VAE_ELBO, VAE_KLDivergence)
from deepchem_tpu_torch.models.irv import (IRVClassifier,
                                           MultitaskIRVClassifier)
from deepchem_tpu_torch.models.material_models import (CGCNNLayer,
                                                       CGCNNModel,
                                                       ElemNetModel,
                                                       LCNNModel,
                                                       MEGNetModel)
from deepchem_tpu_torch.models.multitask import SingletaskToMultitask
from deepchem_tpu_torch.models.mxmnet import MXMNetModel, PlexLayer
from deepchem_tpu_torch.models.pna import PNALayer, PNAModel
from deepchem_tpu_torch.models.progressive import (
    ProgressiveMultitaskClassifier, ProgressiveMultitaskRegressor)
from deepchem_tpu_torch.models.scscore import ScScoreModel
from deepchem_tpu_torch.models.optimizers import (
    KFAC, AdaGrad, Adam, AdamW, ExponentialDecay, GradientDescent, Lamb,
    LambdaLRWithWarmup, LearningRateSchedule, LinearCosineDecay, Optimizer,
    PiecewiseConstantSchedule, PolynomialDecay, RMSProp, SparseAdam)
from deepchem_tpu_torch.models.torch_model import TorchModel
from deepchem_tpu_torch.models.weave_models import DTNNModel, WeaveModel

# DeepChem's TensorGraph-era names
WeaveTensorGraph = WeaveModel
DTNNTensorGraph = DTNNModel
DAGTensorGraph = DAGModel

__all__ = ['AdaGrad', 'Adam', 'AdamW', 'AtomicConvFeaturizer',
           'AtomicConvModel', 'AtomicConvolution', 'AttentiveFPLayer',
           'AttentiveFPModel', 'AttnLSTMEmbedding', 'BertEncoderMLM',
           'BinaryCrossEntropy',
           'CGCNNLayer', 'CGCNNModel', 'CategoricalCrossEntropy',
           'ComplexNeighborListFragmentAtomicCoordinates',
           'DAGModel', 'DAGTensorGraph',
           'DAGTransformer', 'DMPNNModel', 'DTNNEmbedding', 'DTNNModel',
           'DTNNStep', 'DTNNTensorGraph', 'DeepGraphInfomaxLoss',
           'EdgeNetworkMPNN', 'EdgePredictionLoss', 'EGNNLayer',
           'ElemNetModel',
           'ExponentialDecay',
           'GATLayer', 'GATModel', 'GCNLayer', 'GCNModel', 'GNNModular',
           'GRUCell', 'GlobalMutualInformationLoss', 'GradientDescent',
           'GraphConv', 'GraphConvModel', 'GraphEdgeMaskingLoss',
           'GraphGather', 'GraphModel', 'GraphNodeMaskingLoss', 'HingeLoss',
           'HuberLoss', 'IRVClassifier', 'InfoGraphModel', 'InfoMax3DModular',
           'InfoGraphStarModel', 'IterRefLSTMEmbedding', 'KFAC',
           'L1Loss', 'L2Loss', 'LCNNModel', 'LSTMCell', 'Lamb', 'LambdaLRWithWarmup',
           'LearningRateSchedule', 'LinearCosineDecay',
           'LocalMutualInformationLoss', 'Loss', 'MEGNetModel', 'MPNNModel',
           'MaskedBatchNorm', 'Model', 'ModularModel', 'MXMNetModel',
           'MultitaskClassifier', 'MultitaskFitTransformRegressor',
           'MultitaskIRVClassifier', 'MultitaskRegressor', 'Net3DLayer',
           'Optimizer',
           'PNALayer', 'PNAModel', 'PlexLayer',
           'PagtnLayer', 'PagtnModel', 'PiecewiseConstantSchedule',
           'PoissonLoss', 'PolynomialDecay', 'ProgressiveMultitaskClassifier',
           'ProgressiveMultitaskRegressor', 'RMSProp',
           'RobustMultitaskClassifier', 'RobustMultitaskRegressor',
           'ScScoreModel', 'SetGather', 'SingletaskToMultitask',
           'ShannonEntropy', 'SigmoidCrossEntropy', 'SoftmaxCrossEntropy',
           'SupportGraphClassifier',
           'SparseAdam', 'SparseSoftmaxCrossEntropy', 'SquaredHingeLoss',
           'TorchModel', 'VAE_ELBO', 'VAE_KLDivergence',
           'ValidationCallback', 'WeaveGather', 'WeaveLayer', 'WeaveModel',
           'WeaveTensorGraph', 'ani_symmetry_features',
           'compute_neighbor_list', 'cosine_dist',
           'encoder_params_from_flax',
           'flash_or_xla_attention', 'fourier_encode_dist', 'graph_pool_max',
           'mlm_loss', 'neighbor_dict', 'ntxent_loss', 'params_from_flax',
           'pdb_atoms']
