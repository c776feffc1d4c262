// Fused gather and segment sum over CSR edge ranges, forward.
//
// Replaces the TPU kernel deepchem_tpu/ops/pallas_segment.py
// :_fused_gather_segment_kernel (P2, called from fused_gather_segment_sum).
// For each node i it computes out[i, :] = sum of h[src[e], :] over e in
// [row_ptr[i], row_ptr[i+1]) without writing the gathered messages to
// memory; an empty segment gives 0.  Two entries: float32 and bfloat16.
// The TPU kernel sums in the input's type, adding the edges of a segment
// in CSR order; the bfloat16 entry does the same (below), the float32 one
// adds them in another fixed order.
//
// Bound on this card: memory bytes.  One add per gathered element.  The
// least traffic reads h once (N_h*F*s, s = 4 or 2 bytes), src (E*4) and
// row_ptr ((N+1)*4) and writes out (N*F*s); when rows of h are not reused
// from cache each edge reads its row again, E*F*s.  At the bench's shapes
// (E = 2 N, F 64-512) the two differ by about 2x.
//
// float32 design: the layout of csrc/csr_segment_sum.cu (P3) with one more
// index load.  One warp per node writes the node's output row alone: no
// atomics, so the result is the same on every run.  The TPU kernel takes
// its indices by scalar prefetch; here the warp loads its segment's src
// indices itself, 32 at a time (one per lane, coalesced), and hands them
// round with __shfl_sync.  Lane groups of g lanes run across the gathered
// row's vectors (float4 when F % 4 == 0 and h and out are 16-byte
// aligned); the 32/g groups take alternate edges and are merged by a fixed
// xor-shuffle butterfly.  Each gathered row is read as one coalesced span
// per group.
//
// bfloat16 design: one lane group per node, so that a segment's edges are
// added one after another in CSR order, each add rounded to bfloat16 (an
// add in float32 rounded to nearest even, which for two bfloat16 operands
// is the correctly rounded bfloat16 sum): the result is bit for bit the
// TPU kernel's and the plain version's.  A group of g lanes (the least
// power of two >= the row's vectors, at most 32) covers a row in 16-byte
// units of 8 values when F % 8 == 0 and h and out are 16-byte aligned,
// else one value a lane; a warp holds 32/g nodes.  A lane issues the loads
// of 4 edges' units before it adds the first, so 4 rows are in flight.
//
// Indices are clamped to [0, N_h), so a bad src never reads outside h.
// Inputs: h [N_h, F] row-major, src [E] int32 in CSR (dst-sorted) order,
// row_ptr [N+1] int32 non-decreasing with row_ptr[0] == 0.  Ranges are
// clamped to [0, E].

#include <cuda_bf16.h>
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


// One bfloat16 value rounded from float32, back in float32.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A unit of a bfloat16 row: 8 values (uint4) or 1.
template <typename U>
struct Bf16Unit;

template <>
struct Bf16Unit<uint4> {
  static constexpr int kVals = 8;
  __device__ static void add(float (&acc)[8], uint4 v) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(p[k]);
      acc[2 * k] = round_bf16(acc[2 * k] + f.x);
      acc[2 * k + 1] = round_bf16(acc[2 * k + 1] + f.y);
    }
  }
  __device__ static uint4 pack(const float (&acc)[8]) {
    uint4 v;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      p[k] = __floats2bfloat162_rn(acc[2 * k], acc[2 * k + 1]);
    }
    return v;
  }
};

template <>
struct Bf16Unit<__nv_bfloat16> {
  static constexpr int kVals = 1;
  __device__ static void add(float (&acc)[1], __nv_bfloat16 v) {
    acc[0] = round_bf16(acc[0] + __bfloat162float(v));
  }
  __device__ static __nv_bfloat16 pack(const float (&acc)[1]) {
    return __float2bfloat16_rn(acc[0]);
  }
};

// U is uint4 (8 bfloat16) or __nv_bfloat16; cols units a row; g lanes a
// group (a power of two, 1..32), one node a group.
template <typename U>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_gather_segment_sum_bf16_kernel(const U* __restrict__ h,
                                     const int* __restrict__ src,
                                     const int* __restrict__ row_ptr,
                                     U* __restrict__ out, int num_nodes,
                                     int num_rows, int num_edges, int cols,
                                     int g) {
  using Unit = Bf16Unit<U>;
  constexpr int kAhead = 4;  // edges whose units are loaded before adding
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int node = warp * (32 / g) + lane / g;
  if (node >= num_nodes) return;  // no warp-wide collective below
  const int start = min(max(row_ptr[node], 0), num_edges);
  const int end = min(max(row_ptr[node + 1], start), num_edges);
  const int64_t row = cols;

  for (int c = lane & (g - 1); c < cols; c += g) {
    float acc[Unit::kVals];
#pragma unroll
    for (int k = 0; k < Unit::kVals; ++k) acc[k] = 0.f;
    int e = start;
    for (; e + kAhead <= end; e += kAhead) {
      U v[kAhead];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        const int s = min(max(src[e + j], 0), num_rows - 1);
        v[j] = h[s * row + c];
      }
#pragma unroll
      for (int j = 0; j < kAhead; ++j) Unit::add(acc, v[j]);
    }
    for (; e < end; ++e) {
      const int s = min(max(src[e], 0), num_rows - 1);
      Unit::add(acc, h[s * row + c]);
    }
    out[node * row + c] = Unit::pack(acc);
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

// The bfloat16 entry: h and out hold bfloat16 values.
extern "C" int fused_gather_segment_sum_bf16(const void* h, const int* src,
                                             const int* row_ptr, void* out,
                                             int num_nodes, int num_rows,
                                             int num_edges, int num_features,
                                             cudaStream_t stream) {
  const bool vec8 = num_features % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int cols = vec8 ? num_features / 8 : num_features;
  const int g = warp_vec::lanes_per_group(cols);
  const int nodes_per_block = kWarpsPerBlock * (32 / g);
  const int blocks = (num_nodes + nodes_per_block - 1) / nodes_per_block;
  if (vec8) {
    fused_gather_segment_sum_bf16_kernel<uint4>
        <<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
            static_cast<const uint4*>(h), src, row_ptr,
            static_cast<uint4*>(out), num_nodes, num_rows, num_edges, cols,
            g);
  } else {
    fused_gather_segment_sum_bf16_kernel<__nv_bfloat16>
        <<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
            static_cast<const __nv_bfloat16*>(h), src, row_ptr,
            static_cast<__nv_bfloat16*>(out), num_nodes, num_rows,
            num_edges, cols, g);
  }
  return static_cast<int>(cudaGetLastError());
}
