// Segment sum of CSR-sorted rows, forward.
//
// Replaces the TPU kernel deepchem_tpu/ops/pallas_segment.py
// :_csr_segment_sum_kernel (P3, called from csr_segment_sum).  For each node
// i it computes out[i, :] = sum of msgs[e, :] over e in
// [row_ptr[i], row_ptr[i+1]); an empty segment gives 0.  The TPU's grid
// constraint num_nodes % block_nodes == 0 is not carried.
//
// Bound on this card: memory bytes.  One add per input element; a call
// reads E*F*4 bytes of msgs and (N+1)*4 of row_ptr and writes N*F*4.  A
// PAGTN batch of 16 molecules hands it [6144, 32] (the aggregation) and
// [6144, 1] (the softmax backward's y*dy): ~0.9 MB and ~27 KB, 0.27 us and
// 8 ns at 3.35 TB/s.  At those shapes latency sets the time: padded edges
// all belong to the last (ghost) node, whose segment holds ~1.5k edges.
//
// Design.  One warp per node, and that warp alone writes the node's output
// row: no atomics and no shared memory, so the result is the same on every
// run.  A row is read as `cols` vectors: float4 (16-byte loads) when F % 4
// == 0 and both pointers are 16-byte aligned, else single floats.  The
// warp's lanes form 32/g groups of g lanes (g a power of two, g >= cols up
// to 32).  Within a group the lanes run across a row's vectors; the groups
// split the segment's edges (group k takes edges start+k, start+k+32/g,
// ...), each summing its edges in order.  A fixed xor-shuffle butterfly
// then merges the groups.  So F >= 128 (or F >= 32 without float4) gives
// one edge per step with every lane on features; F = 32 with float4 gives 4
// edges per step; F = 1 gives 32 edges per step and a full warp merge.
// The ghost segment is still walked by one warp; splitting long segments
// across a block is left to a later change.
//
// Inputs: msgs [E, F] float32 row-major, row_ptr [N+1] int32 non-decreasing
// with row_ptr[0] == 0.  Ranges are clamped to [0, E], so edges past
// row_ptr[N] are ignored and a bad row_ptr never reads outside msgs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_vec.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

// V is float or float4; cols = F / (sizeof(V) / 4) vectors a row; g lanes a
// group (a power of two, 1..32).
template <typename V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_segment_sum_kernel(const V* __restrict__ msgs,
                       const int* __restrict__ row_ptr, V* __restrict__ out,
                       int num_nodes, int num_edges, int cols, int g) {
  const int lane = threadIdx.x & 31;
  const int node = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (node >= num_nodes) return;  // whole warp leaves together
  const int start = min(max(row_ptr[node], 0), num_edges);
  const int end = min(max(row_ptr[node + 1], start), num_edges);
  const int groups = 32 / g;
  const int group = lane / g;
  const int64_t row = cols;

  for (int c0 = 0; c0 < cols; c0 += g) {  // uniform across the warp
    const int c = c0 + (lane & (g - 1));
    const bool active = c < cols;
    V acc = warp_vec::zero(V());
    if (active) {
#pragma unroll 4
      for (int e = start + group; e < end; e += groups) {
        warp_vec::add(acc, msgs[e * row + c]);
      }
    }
    acc = warp_vec::merge_groups(acc, g);
    if (active && group == 0) out[node * row + c] = acc;
  }
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError() as an int.
extern "C" int csr_segment_sum_f32(const float* msgs, const int* row_ptr,
                                   float* out, int num_nodes, int num_edges,
                                   int num_features, cudaStream_t stream) {
  const int blocks = (num_nodes + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const bool vec4 = num_features % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(msgs) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec4) {
    const int cols = num_features / 4;
    csr_segment_sum_kernel<float4>
        <<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
            reinterpret_cast<const float4*>(msgs), row_ptr,
            reinterpret_cast<float4*>(out), num_nodes, num_edges, cols,
            warp_vec::lanes_per_group(cols));
  } else {
    csr_segment_sum_kernel<float><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        msgs, row_ptr, out, num_nodes, num_edges, num_features,
        warp_vec::lanes_per_group(num_features));
  }
  return static_cast<int>(cudaGetLastError());
}
