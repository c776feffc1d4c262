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
from deepchem_tpu_torch.models.losses import (L2Loss, Loss,
                                              SoftmaxCrossEntropy)
from deepchem_tpu_torch.models.optimizers import Adam, AdamW, Optimizer
from deepchem_tpu_torch.models.torch_model import TorchModel

__all__ = ['Adam', 'AdamW', 'AttentiveFPLayer', 'AttentiveFPModel',
           'BertEncoderMLM', 'DMPNNModel', 'EdgeNetworkMPNN', 'GATLayer',
           'GATModel', 'GCNLayer', 'GCNModel', 'GRUCell',
           'GraphConv', 'GraphConvModel', 'GraphGather', 'GraphModel',
           'L2Loss', 'LSTMCell', 'Loss', 'MPNNModel', 'MaskedBatchNorm',
           'Optimizer', 'PagtnLayer', 'PagtnModel', 'SetGather',
           'SoftmaxCrossEntropy',
           'TorchModel', 'encoder_params_from_flax',
           'flash_or_xla_attention', 'graph_pool_max', 'mlm_loss',
           'params_from_flax']
