from deepchem_tpu_torch.models.bert_encoder import (BertEncoderMLM,
                                                    flash_or_xla_attention,
                                                    mlm_loss)
from deepchem_tpu_torch.models.convert import (encoder_params_from_flax,
                                               params_from_flax)
from deepchem_tpu_torch.models.dmpnn import DMPNNModel
from deepchem_tpu_torch.models.gnn_modular import GNNModular, ModularModel
from deepchem_tpu_torch.models.graph_layers import (AttentiveFPLayer,
                                                    EdgeNetworkMPNN, GATLayer,
                                                    GCNLayer, GraphConv,
                                                    GraphGather, GRUCell,
                                                    LSTMCell, MaskedBatchNorm,
                                                    SetGather, graph_pool_max)
from deepchem_tpu_torch.models.graph_models import (AttentiveFPModel,
                                                    GATModel, GCNModel,
                                                    GraphConvModel,
                                                    GraphModel, MPNNModel,
                                                    PagtnLayer, PagtnModel)
from deepchem_tpu_torch.models.infograph import (InfoGraphModel,
                                                 InfoGraphStarModel)
from deepchem_tpu_torch.models.base import Model
from deepchem_tpu_torch.models.callbacks import ValidationCallback
from deepchem_tpu_torch.models.losses import (
    BinaryCrossEntropy, CategoricalCrossEntropy, DeepGraphInfomaxLoss,
    EdgePredictionLoss, GlobalMutualInformationLoss, GraphEdgeMaskingLoss,
    GraphNodeMaskingLoss, HingeLoss, HuberLoss, L1Loss, L2Loss,
    LocalMutualInformationLoss, Loss, PoissonLoss, ShannonEntropy,
    SigmoidCrossEntropy, SoftmaxCrossEntropy, SparseSoftmaxCrossEntropy,
    SquaredHingeLoss, VAE_ELBO, VAE_KLDivergence)
from deepchem_tpu_torch.models.pna import PNALayer, PNAModel
from deepchem_tpu_torch.models.optimizers import (
    KFAC, AdaGrad, Adam, AdamW, ExponentialDecay, GradientDescent, Lamb,
    LambdaLRWithWarmup, LearningRateSchedule, LinearCosineDecay, Optimizer,
    PiecewiseConstantSchedule, PolynomialDecay, RMSProp, SparseAdam)
from deepchem_tpu_torch.models.torch_model import TorchModel

__all__ = ['AdaGrad', 'Adam', 'AdamW', 'AttentiveFPLayer',
           'AttentiveFPModel', 'BertEncoderMLM', 'BinaryCrossEntropy',
           'CategoricalCrossEntropy', 'DMPNNModel', 'DeepGraphInfomaxLoss',
           'EdgeNetworkMPNN', 'EdgePredictionLoss', 'ExponentialDecay',
           'GATLayer', 'GATModel', 'GCNLayer', 'GCNModel', 'GNNModular',
           'GRUCell', 'GlobalMutualInformationLoss', 'GradientDescent',
           'GraphConv', 'GraphConvModel', 'GraphEdgeMaskingLoss',
           'GraphGather', 'GraphModel', 'GraphNodeMaskingLoss', 'HingeLoss',
           'HuberLoss', 'InfoGraphModel', 'InfoGraphStarModel', 'KFAC',
           'L1Loss', 'L2Loss', 'LSTMCell', 'Lamb', 'LambdaLRWithWarmup',
           'LearningRateSchedule', 'LinearCosineDecay',
           'LocalMutualInformationLoss', 'Loss', 'MPNNModel',
           'MaskedBatchNorm', 'Model', 'ModularModel', 'Optimizer',
           'PNALayer', 'PNAModel',
           'PagtnLayer', 'PagtnModel', 'PiecewiseConstantSchedule',
           'PoissonLoss', 'PolynomialDecay', 'RMSProp', 'SetGather',
           'ShannonEntropy', 'SigmoidCrossEntropy', 'SoftmaxCrossEntropy',
           'SparseAdam', 'SparseSoftmaxCrossEntropy', 'SquaredHingeLoss',
           'TorchModel', 'VAE_ELBO', 'VAE_KLDivergence',
           'ValidationCallback', 'encoder_params_from_flax',
           'flash_or_xla_attention', 'graph_pool_max', 'mlm_loss',
           'params_from_flax']
