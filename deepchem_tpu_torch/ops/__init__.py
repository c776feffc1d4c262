from deepchem_tpu_torch.ops.csr_segment import (
    csr_row_ptr, csr_segment_softmax, csr_segment_softmax_reference,
    edges_to_csr)
from deepchem_tpu_torch.ops.segment import (NEG, graph_pool, segment_softmax,
                                            segment_softmax_sorted,
                                            segment_sum)

__all__ = ['NEG', 'csr_row_ptr', 'csr_segment_softmax',
           'csr_segment_softmax_reference', 'edges_to_csr', 'graph_pool', 'segment_softmax',
           'segment_softmax_sorted', 'segment_sum']
