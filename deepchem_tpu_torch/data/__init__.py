from deepchem_tpu_torch.data.datasets import NumpyDataset, pad_batch

__all__ = ['NumpyDataset', 'pad_batch']
