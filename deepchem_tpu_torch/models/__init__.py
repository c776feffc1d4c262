from deepchem_tpu_torch.models.convert import params_from_flax
from deepchem_tpu_torch.models.graph_models import (GraphModel, PagtnLayer,
                                                    PagtnModel)
from deepchem_tpu_torch.models.losses import (L2Loss, Loss,
                                              SoftmaxCrossEntropy)
from deepchem_tpu_torch.models.optimizers import Adam, Optimizer
from deepchem_tpu_torch.models.torch_model import TorchModel

__all__ = ['Adam', 'GraphModel', 'L2Loss', 'Loss', 'Optimizer',
           'PagtnLayer', 'PagtnModel', 'SoftmaxCrossEntropy', 'TorchModel',
           'params_from_flax']
