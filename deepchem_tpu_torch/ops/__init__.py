from deepchem_tpu_torch.ops.csr_segment import (
    csr_neighbor_sum_reference, csr_row_ptr, csr_segment_softmax,
    csr_segment_softmax_reference, csr_segment_sum,
    csr_segment_sum_reference, edges_to_csr, fused_gather_segment_sum)
from deepchem_tpu_torch.ops.coo import (N_CSR, CooCsr, coo_csr, coo_degrees,
                                        dst_segment_max_sumgrad,
                                        dst_segment_softmax, dst_segment_sum,
                                        gather_dst, graph_edge_row_ptr, gather_neighbors_max,
                                        gather_neighbors_sum, gather_src,
                                        permute_rows)
from deepchem_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_reference, flash_attention_bwd_dq,
    flash_attention_bwd_dq_reference, flash_attention_forward,
    flash_attention_reference)
from deepchem_tpu_torch.ops.nei_table import (build_neighbor_table,
                                              build_rev_slot, nei_gather,
                                              nei_max_incl_self, nei_sum,
                                              nei_sum_edges, take_src)
from deepchem_tpu_torch.ops.segment import (NEG, gather_graph_rows,
                                            gather_table_rows,
                                            graph_max_pool, graph_pool,
                                            node_degrees, segment_max,
                                            segment_max_sumgrad, segment_mean,
                                            segment_softmax,
                                            segment_softmax_sorted,
                                            segment_sum)

__all__ = ['CooCsr', 'NEG', 'N_CSR', 'build_neighbor_table',
           'build_rev_slot', 'coo_csr', 'coo_degrees',
           'dst_segment_max_sumgrad',
           'dst_segment_softmax', 'dst_segment_sum', 'gather_dst',
           'graph_edge_row_ptr', 'gather_neighbors_max',
           'gather_neighbors_sum', 'gather_src', 'permute_rows',
           'csr_neighbor_sum_reference',
           'csr_row_ptr', 'csr_segment_softmax',
           'csr_segment_softmax_reference',
           'csr_segment_sum', 'csr_segment_sum_reference', 'edges_to_csr',
           'flash_attention', 'flash_attention_bwd_dkv',
           'flash_attention_bwd_dkv_reference', 'flash_attention_bwd_dq',
           'flash_attention_bwd_dq_reference', 'flash_attention_forward',
           'flash_attention_reference', 'fused_gather_segment_sum',
           'gather_graph_rows', 'gather_table_rows',
           'graph_max_pool', 'graph_pool', 'nei_gather', 'nei_max_incl_self',
           'nei_sum',
           'nei_sum_edges', 'node_degrees', 'segment_max',
           'segment_max_sumgrad', 'segment_mean', 'segment_softmax',
           'segment_softmax_sorted', 'segment_sum', 'take_src']
