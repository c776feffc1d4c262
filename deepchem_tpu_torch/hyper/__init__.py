from deepchem_tpu_torch.hyper.base import HyperparamOpt
from deepchem_tpu_torch.hyper.grid_search import GridHyperparamOpt
from deepchem_tpu_torch.hyper.random_search import RandomHyperparamOpt

__all__ = ['HyperparamOpt', 'GridHyperparamOpt', 'RandomHyperparamOpt']
