from deepchem_tpu_torch.trans.transformers import (
    BalancingTransformer, CDFTransformer, ClippingTransformer,
    DuplicateBalancingTransformer, FlatteningTransformer, LogTransformer,
    MinMaxTransformer, NormalizationTransformer, PowerTransformer,
    Transformer, undo_grad_transforms, undo_transforms)

__all__ = ['BalancingTransformer', 'CDFTransformer', 'ClippingTransformer',
           'DuplicateBalancingTransformer', 'FlatteningTransformer',
           'LogTransformer', 'MinMaxTransformer', 'NormalizationTransformer',
           'PowerTransformer', 'Transformer', 'undo_grad_transforms',
           'undo_transforms']
