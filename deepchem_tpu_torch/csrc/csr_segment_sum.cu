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
// all belong to the last (ghost) node, whose segment holds ~1.5k edges,
// and the edges one warp walks in order are a chain of dependent adds.
//
// Design.  A block of 8 warps owns 8 consecutive nodes, and each output
// row has one writer: no atomics, so the result is the same on every run.
// A row is read as `cols` vectors: float4 (16-byte loads) when F % 4 == 0
// and both pointers are 16-byte aligned, else single floats.  A warp's
// lanes form 32/g groups of g lanes (g a power of two, g >= cols up to
// 32).  Within a group the lanes run across a row's vectors; the groups
// split a range of edges (group k takes edges start+k, start+k+32/g, ...),
// each summing its edges in order, and a fixed xor-shuffle butterfly then
// merges the groups.  So F >= 128 (or F >= 32 without float4) gives one
// edge per step with every lane on features; F = 32 with float4 gives 4
// edges per step; F = 1 gives 32 edges per step and a full warp merge.
//   A segment of at most kSplitEdges edges is summed by its own warp.  A
// longer one (the ghost node's) is split across the whole block, once
// every warp is done with its own node: warp w sums the w-th of 8
// contiguous, equal ranges of the segment, and warp 0 adds the 8 partial
// rows from shared memory in warp order.  Every warp reads the block's 9
// row_ptr entries itself (one load, then shuffles), so the choice costs
// no barrier in a block without a long segment, and the host needs
// neither a sync nor a copy.  (Telling the block through shared memory
// and a barrier in every block cost 17 % on [32768, 512], whose segments
// are all short; PERF.md.)  A segment far longer than a block can walk
// quickly (tens of thousands of edges) is still one block's work;
// splitting it across blocks would take a second, fixed-order pass.
//
// Inputs: msgs [E, F] float32 row-major, row_ptr [N+1] int32 non-decreasing
// with row_ptr[0] == 0.  Ranges are clamped to [0, E], so edges past
// row_ptr[N] are ignored and a bad row_ptr never reads outside msgs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_vec.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
// Longest segment one warp sums alone; longer ones are split across the
// block.  At F = 32 a warp takes 4 edges a step, the block 32.
constexpr int kSplitEdges = 128;

// The sum of rows [start, end) at vector c of the row (the lane's column;
// `active` false past the row's end), merged across the warp's lane
// groups: every lane of group 0 ends with its column's sum.  All 32 lanes
// must call it.
template <typename V>
__device__ __forceinline__ V warp_range_sum(const V* __restrict__ msgs,
                                            int64_t row, int start, int end,
                                            int c, bool active, int g) {
  const int groups = 32 / g;
  const int group = (threadIdx.x & 31) / g;
  V acc = warp_vec::zero(V());
  if (active) {
#pragma unroll 4
    for (int e = start + group; e < end; e += groups) {
      warp_vec::add(acc, msgs[e * row + c]);
    }
  }
  return warp_vec::merge_groups(acc, g);
}

// V is float or float4; cols = F / (sizeof(V) / 4) vectors a row; g lanes a
// group (a power of two, 1..32).
template <typename V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_segment_sum_kernel(const V* __restrict__ msgs,
                       const int* __restrict__ row_ptr, V* __restrict__ out,
                       int num_nodes, int num_edges, int cols, int g) {
  __shared__ V part[kWarpsPerBlock][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int node0 = blockIdx.x * kWarpsPerBlock;
  const int nodes = min(kWarpsPerBlock, num_nodes - node0);
  const int64_t row = cols;
  const int c_lane = lane & (g - 1);
  const bool lead = lane < g;  // group 0, which holds the merged sums
  // Every warp reads the block's bounds, clamped to [0, E]: lane j holds
  // the start of node0 + j.  So each warp knows which of the block's
  // nodes are long without shared memory, and a block with none never
  // waits at a barrier.
  int bound = 0;
  if (lane <= nodes) bound = min(max(row_ptr[node0 + lane], 0), num_edges);
  unsigned long_nodes = 0;  // bit w: node0 + w is split across the block
  int start = 0, end = 0;
#pragma unroll
  for (int w = 0; w < kWarpsPerBlock; ++w) {
    const int s = __shfl_sync(warp_vec::kFullMask, bound, w);
    const int e = max(__shfl_sync(warp_vec::kFullMask, bound, w + 1), s);
    if (w < nodes && e - s > kSplitEdges) long_nodes |= 1u << w;
    if (w == warp) {
      start = s;
      end = e;
    }
  }
  if (warp < nodes && !(long_nodes >> warp & 1)) {  // uniform in the warp
    for (int c0 = 0; c0 < cols; c0 += g) {
      const int c = c0 + c_lane;
      const V acc = warp_range_sum(msgs, row, start, end, c, c < cols, g);
      if (lead && c < cols) out[(node0 + warp) * row + c] = acc;
    }
  }
  while (long_nodes != 0) {  // uniform across the block
    const int w = __ffs(long_nodes) - 1;
    long_nodes &= long_nodes - 1;
    const int s = __shfl_sync(warp_vec::kFullMask, bound, w);
    const int len = max(__shfl_sync(warp_vec::kFullMask, bound, w + 1), s) - s;
    const int ps = s + (int)((int64_t)len * warp / kWarpsPerBlock);
    const int pe = s + (int)((int64_t)len * (warp + 1) / kWarpsPerBlock);
    for (int c0 = 0; c0 < cols; c0 += g) {
      const int c = c0 + c_lane;
      const V acc = warp_range_sum(msgs, row, ps, pe, c, c < cols, g);
      __syncthreads();  // warp 0 is done reading the previous parts
      if (lead) part[warp][lane] = acc;
      __syncthreads();
      if (warp == 0 && lead && c < cols) {
        V sum = part[0][lane];
#pragma unroll
        for (int k = 1; k < kWarpsPerBlock; ++k) {
          warp_vec::add(sum, part[k][lane]);
        }
        out[(node0 + w) * row + c] = sum;
      }
    }
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
