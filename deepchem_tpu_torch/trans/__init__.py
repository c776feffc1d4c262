from deepchem_tpu_torch.trans.transformers import (NormalizationTransformer,
                                                   Transformer,
                                                   undo_transforms)

__all__ = ['NormalizationTransformer', 'Transformer', 'undo_transforms']
