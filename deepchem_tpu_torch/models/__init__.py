from deepchem_tpu_torch.models.bert_encoder import (BertEncoderMLM,
                                                    flash_or_xla_attention,
                                                    mlm_loss)
from deepchem_tpu_torch.models.convert import (encoder_params_from_flax,
                                               params_from_flax)
from deepchem_tpu_torch.models.dmpnn import DMPNNModel
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
from deepchem_tpu_torch.models.base import Model
from deepchem_tpu_torch.models.callbacks import ValidationCallback
from deepchem_tpu_torch.models.losses import (
    BinaryCrossEntropy, CategoricalCrossEntropy, HingeLoss, HuberLoss,
    L1Loss, L2Loss, Loss, PoissonLoss, ShannonEntropy, SigmoidCrossEntropy,
    SoftmaxCrossEntropy, SparseSoftmaxCrossEntropy, SquaredHingeLoss,
    VAE_ELBO, VAE_KLDivergence)
from deepchem_tpu_torch.models.optimizers import (
    KFAC, AdaGrad, Adam, AdamW, ExponentialDecay, GradientDescent, Lamb,
    LambdaLRWithWarmup, LearningRateSchedule, LinearCosineDecay, Optimizer,
    PiecewiseConstantSchedule, PolynomialDecay, RMSProp, SparseAdam)
from deepchem_tpu_torch.models.torch_model import TorchModel

__all__ = ['AdaGrad', 'Adam', 'AdamW', 'AttentiveFPLayer',
           'AttentiveFPModel', 'BertEncoderMLM', 'BinaryCrossEntropy',
           'CategoricalCrossEntropy', 'DMPNNModel', 'EdgeNetworkMPNN',
           'ExponentialDecay', 'GATLayer', 'GATModel', 'GCNLayer',
           'GCNModel', 'GRUCell', 'GradientDescent', 'GraphConv',
           'GraphConvModel', 'GraphGather', 'GraphModel', 'HingeLoss',
           'HuberLoss', 'KFAC', 'L1Loss', 'L2Loss', 'LSTMCell', 'Lamb',
           'LambdaLRWithWarmup', 'LearningRateSchedule', 'LinearCosineDecay',
           'Loss', 'MPNNModel', 'MaskedBatchNorm', 'Model', 'Optimizer',
           'PagtnLayer', 'PagtnModel', 'PiecewiseConstantSchedule',
           'PoissonLoss', 'PolynomialDecay', 'RMSProp', 'SetGather',
           'ShannonEntropy', 'SigmoidCrossEntropy', 'SoftmaxCrossEntropy',
           'SparseAdam', 'SparseSoftmaxCrossEntropy', 'SquaredHingeLoss',
           'TorchModel', 'VAE_ELBO', 'VAE_KLDivergence',
           'ValidationCallback', 'encoder_params_from_flax',
           'flash_or_xla_attention', 'graph_pool_max', 'mlm_loss',
           'params_from_flax']
