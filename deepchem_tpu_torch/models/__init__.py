from deepchem_tpu_torch.models.convert import params_from_flax
from deepchem_tpu_torch.models.graph_models import (GraphModel, PagtnLayer,
                                                    PagtnModel)
from deepchem_tpu_torch.models.torch_model import TorchModel

__all__ = ['GraphModel', 'PagtnLayer', 'PagtnModel', 'TorchModel',
           'params_from_flax']
