from deepchem_tpu_torch.ops.csr_segment import (
    csr_neighbor_sum_reference, csr_row_ptr, csr_segment_softmax,
    csr_segment_softmax_reference, csr_segment_sum,
    csr_segment_sum_reference, edges_to_csr, fused_gather_segment_sum)
from deepchem_tpu_torch.ops.coo import (CooCsr, coo_csr,
                                        dst_segment_max_sumgrad,
                                        dst_segment_sum, gather_neighbors_sum)
from deepchem_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_reference, flash_attention_bwd_dq,
    flash_attention_bwd_dq_reference, flash_attention_forward,
    flash_attention_reference)
from deepchem_tpu_torch.ops.nei_table import (build_neighbor_table,
                                              build_rev_slot, nei_gather,
                                              nei_max_incl_self, nei_sum,
                                              nei_sum_edges, take_src)
from deepchem_tpu_torch.ops.segment import (NEG, graph_max_pool, graph_pool,
                                            node_degrees, segment_max,
                                            segment_max_sumgrad, segment_mean,
                                            segment_softmax,
                                            segment_softmax_sorted,
                                            segment_sum)

__all__ = ['CooCsr', 'NEG', 'build_neighbor_table', 'build_rev_slot',
           'coo_csr', 'dst_segment_max_sumgrad', 'dst_segment_sum',
           'gather_neighbors_sum',
           'csr_neighbor_sum_reference',
           'csr_row_ptr', 'csr_segment_softmax',
           'csr_segment_softmax_reference',
           'csr_segment_sum', 'csr_segment_sum_reference', 'edges_to_csr',
           'flash_attention', 'flash_attention_bwd_dkv',
           'flash_attention_bwd_dkv_reference', 'flash_attention_bwd_dq',
           'flash_attention_bwd_dq_reference', 'flash_attention_forward',
           'flash_attention_reference', 'fused_gather_segment_sum',
           'graph_max_pool', 'graph_pool', 'nei_gather', 'nei_max_incl_self',
           'nei_sum',
           'nei_sum_edges', 'node_degrees', 'segment_max',
           'segment_max_sumgrad', 'segment_mean', 'segment_softmax',
           'segment_softmax_sorted', 'segment_sum', 'take_src']
