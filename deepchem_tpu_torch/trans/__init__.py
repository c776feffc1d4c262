from deepchem_tpu_torch.trans.transformers import (
    BalancingTransformer, CDFTransformer, ClippingTransformer,
    CoulombFitTransformer,
    DuplicateBalancingTransformer, FlatteningTransformer, IRVTransformer,
    LogTransformer,
    MinMaxTransformer, NormalizationTransformer, PowerTransformer,
    Transformer, undo_grad_transforms, undo_transforms)

__all__ = ['BalancingTransformer', 'CDFTransformer', 'ClippingTransformer',
           'CoulombFitTransformer',
           'DuplicateBalancingTransformer', 'FlatteningTransformer',
           'IRVTransformer',
           'LogTransformer', 'MinMaxTransformer', 'NormalizationTransformer',
           'PowerTransformer', 'Transformer', 'undo_grad_transforms',
           'undo_transforms']

# DAGTransformer lives beside DAGModel (models/dag.py), imported when first
# asked for: models import this package
__all__.append('DAGTransformer')


def __getattr__(name):
    if name == 'DAGTransformer':
        from deepchem_tpu_torch.models.dag import DAGTransformer
        return DAGTransformer
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
