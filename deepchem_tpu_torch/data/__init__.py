from deepchem_tpu_torch.data.datasets import (ImageDataset, NumpyDataset,
                                              pad_batch)
from deepchem_tpu_torch.data.supports import (EpisodeGenerator,
                                              SupportGenerator,
                                              get_single_task_test,
                                              get_task_dataset,
                                              get_task_support,
                                              remove_dead_examples)

__all__ = ['EpisodeGenerator', 'ImageDataset', 'NumpyDataset', 'SupportGenerator',
           'get_single_task_test', 'get_task_dataset', 'get_task_support',
           'pad_batch', 'remove_dead_examples']
