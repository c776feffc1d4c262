from deepchem_tpu_torch.data.datasets import (Databag, Dataset, DiskDataset,
                                              ImageDataset, NumpyDataset,
                                              densify_features, pad_batch,
                                              pad_features,
                                              sparsify_features)
from deepchem_tpu_torch.data.loaders import (CSVLoader, DataLoader,
                                             FASTALoader, FASTQLoader,
                                             InMemoryLoader, JsonLoader,
                                             SDFLoader, UserCSVLoader)
from deepchem_tpu_torch.data.supports import (EpisodeGenerator,
                                              SupportGenerator,
                                              get_single_task_test,
                                              get_task_dataset,
                                              get_task_support,
                                              remove_dead_examples)

__all__ = ['CSVLoader', 'DataLoader', 'Databag', 'Dataset', 'DiskDataset',
           'EpisodeGenerator', 'FASTALoader', 'FASTQLoader', 'ImageDataset',
           'InMemoryLoader', 'JsonLoader', 'NumpyDataset', 'SDFLoader',
           'SupportGenerator', 'UserCSVLoader', 'densify_features',
           'get_single_task_test', 'get_task_dataset', 'get_task_support',
           'pad_batch', 'pad_features', 'remove_dead_examples',
           'sparsify_features']
