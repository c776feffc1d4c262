from deepchem_tpu_torch.splits.splitters import (
    ButinaSplitter, FingerprintSplitter, IndexSplitter,
    MaxMinSplitter, MolecularWeightSplitter, RandomGroupSplitter,
    RandomSplitter, RandomStratifiedSplitter, ScaffoldSplitter,
    SingletaskStratifiedSplitter, SpecifiedSplitter, Splitter, TaskSplitter,
    TimeSplitter, TimeSplitterPDBbind, butina_cluster, generate_scaffold,
    merge_fold_datasets)

__all__ = [
    'Splitter', 'RandomSplitter', 'IndexSplitter', 'SpecifiedSplitter',
    'RandomGroupSplitter', 'RandomStratifiedSplitter',
    'SingletaskStratifiedSplitter', 'MolecularWeightSplitter',
    'ScaffoldSplitter', 'FingerprintSplitter', 'ButinaSplitter',
    'MaxMinSplitter', 'TaskSplitter', 'generate_scaffold', 'butina_cluster',
    'TimeSplitter', 'TimeSplitterPDBbind', 'merge_fold_datasets',
]
