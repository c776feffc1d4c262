// Fused gather and segment sum over CSR edge ranges, forward.
//
// Replaces the TPU kernel deepchem_tpu/ops/pallas_segment.py
// :_fused_gather_segment_kernel (P2, called from fused_gather_segment_sum).
// For each node i it computes out[i, :] = sum of h[src[e], :] over e in
// [row_ptr[i], row_ptr[i+1]) without writing the gathered messages to
// memory; an empty segment gives 0.  float32 only: the TPU kernel sums in
// the input's type, and a bf16 version is left to a later change.
//
// Bound on this card: memory bytes.  One add per gathered element.  The
// least traffic reads h once (N_h*F*4), src (E*4) and row_ptr ((N+1)*4) and
// writes out (N*F*4); when rows of h are not reused from cache each edge
// reads its row again, E*F*4.  At the bench's shapes (E = 2 N, F 64-512)
// the two differ by about 2x.
//
// Design: the layout of csrc/csr_segment_sum.cu (P3) with one more index
// load.  One warp per node writes the node's output row alone: no atomics,
// so the result is the same on every run.  The TPU kernel takes its indices
// by scalar prefetch; here the warp loads its segment's src indices itself,
// 32 at a time (one per lane, coalesced), and hands them round with
// __shfl_sync.  Lane groups of g lanes run across the gathered row's
// vectors (float4 when F % 4 == 0 and h and out are 16-byte aligned); the
// 32/g groups take alternate edges and are merged by a fixed xor-shuffle
// butterfly.  Each gathered row is read as one coalesced span per group.
// Indices are clamped to [0, N_h), so a bad src never reads outside h.
//
// Inputs: h [N_h, F] float32 row-major, src [E] int32 in CSR (dst-sorted)
// order, row_ptr [N+1] int32 non-decreasing with row_ptr[0] == 0.  Ranges
// are clamped to [0, E].

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_vec.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

// V is float or float4; cols vectors a row; g lanes a group (a power of
// two, 1..32).
template <typename V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_gather_segment_sum_kernel(const V* __restrict__ h,
                                const int* __restrict__ src,
                                const int* __restrict__ row_ptr,
                                V* __restrict__ out, int num_nodes,
                                int num_rows, int num_edges, int cols,
                                int g) {
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
    for (int base = start; base < end; base += 32) {
      const int n = min(32, end - base);
      int mine = lane < n ? src[base + lane] : 0;
      mine = min(max(mine, 0), num_rows - 1);
      // every lane runs every shuffle: j0 steps are uniform over the warp
      for (int j0 = 0; j0 < n; j0 += groups) {
        const int j = j0 + group;
        const int s = __shfl_sync(warp_vec::kFullMask, mine, j & 31);
        if (active && j < n) warp_vec::add(acc, h[s * row + c]);
      }
    }
    acc = warp_vec::merge_groups(acc, g);
    if (active && group == 0) out[node * row + c] = acc;
  }
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError() as an int.
extern "C" int fused_gather_segment_sum_f32(const float* h, const int* src,
                                            const int* row_ptr, float* out,
                                            int num_nodes, int num_rows,
                                            int num_edges, int num_features,
                                            cudaStream_t stream) {
  const int blocks = (num_nodes + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const bool vec4 = num_features % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec4) {
    const int cols = num_features / 4;
    fused_gather_segment_sum_kernel<float4>
        <<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
            reinterpret_cast<const float4*>(h), src, row_ptr,
            reinterpret_cast<float4*>(out), num_nodes, num_rows, num_edges,
            cols, warp_vec::lanes_per_group(cols));
  } else {
    fused_gather_segment_sum_kernel<float>
        <<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
            h, src, row_ptr, out, num_nodes, num_rows, num_edges,
            num_features, warp_vec::lanes_per_group(num_features));
  }
  return static_cast<int>(cudaGetLastError());
}
