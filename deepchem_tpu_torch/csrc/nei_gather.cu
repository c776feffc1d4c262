// Neighbour-slot gather of the attention layers (GAT, AttentiveFP): K4's
// forward.
//
// Replaces the forward of the custom-VJP XLA op nei_gather of
// deepchem_tpu/ops/nei_table.py (:171-191), which the JAX package computes
// as jnp.take(x, table) times the slot mask, with no Pallas kernel:
//   out[i, j, c] = x[table[i, j], c] * real(j),
//   real(j) = 1 for j < deg[i] and 0 for a pad slot.
// A real slot's value is copied (x * 1 has the same bits, NaN aside); a pad
// slot's row is read and multiplied by 0: a signed zero, or NaN where the
// row is not finite, as the JAX op's mask gives.  Every one of the N * K * C
// outputs is written, pad slots' included.  Its backward (:194-211) is K1
// (nei_table.cu's nei_sum_kernel) over the cotangent [N * K, C] through the
// rows table * K + rev_slot, so it has no kernel of its own here.
//
// Bound on this card: memory bytes, almost all of them the stores.  At the
// attention layers' batch of 100 molecules (N = 2048 nodes, K = 10) the
// output is 2048 * 10 * C floats: 16.4 MB at AttentiveFP's C = 200 (about
// 4.9 us at 3.35 TB/s), 5.2 MB at GAT's C = 64 and 0.66 MB at its C = 8,
// where the launch sets the time.  The reads (each row of x once, the table
// and the degrees) add a tenth or less.
//
// Layout, as K1's: a group of 2^shift lanes (the least power of two >= the
// row's units, at most 32) holds one output row (i, j) and each lane every
// 2^shift-th unit of it, so that a warp's stores are contiguous.  A unit is
// a float4 where C is a multiple of 4 and x and out are 16-byte aligned,
// else one float; the C entry picks and counts its float4 launches
// (nei_gather_float4_launches).  Each output element has one writer; no
// atomics.
//
// Inputs: x [N, C] float32 row-major, table [N, K] int32 with every entry in
// [0, N) (pad slots' included), deg [N] int8 (clamped to [0, K]); out
// [N, K, C] float32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_vec.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float times_zero(float v) { return v * 0.f; }
__device__ __forceinline__ float4 times_zero(float4 v) {
  return make_float4(v.x * 0.f, v.y * 0.f, v.z * 0.f, v.w * 0.f);
}

// V is float or float4, cols = C / (floats in V).
template <typename V>
__global__ void __launch_bounds__(kThreads)
nei_gather_kernel(const V* __restrict__ x, const int* __restrict__ table,
                  const int8_t* __restrict__ deg, V* __restrict__ out,
                  int num_slots, int k, int cols, int shift) {
  const int slot = blockIdx.x * (kThreads >> shift) + (threadIdx.x >> shift);
  if (slot >= num_slots) return;
  const int node = slot / k;
  const int j = slot - node * k;
  const int t = table[slot];
  const int d = min(max(static_cast<int>(deg[node]), 0), k);
  const V* src = x + static_cast<int64_t>(t) * cols;
  V* dst = out + static_cast<int64_t>(slot) * cols;
  const int lanes = 1 << shift;
  if (j < d) {
    for (int c = threadIdx.x & (lanes - 1); c < cols; c += lanes) {
      dst[c] = src[c];
    }
  } else {
    for (int c = threadIdx.x & (lanes - 1); c < cols; c += lanes) {
      dst[c] = times_zero(src[c]);
    }
  }
}

template <typename V>
int nei_gather_launch(const float* x, const int* table, const int8_t* deg,
                      float* out, int num_nodes, int k, int num_features,
                      cudaStream_t stream) {
  const int cols = num_features / static_cast<int>(sizeof(V) / 4);
  int shift = 0;
  while ((1 << shift) < warp_vec::lanes_per_group(cols)) ++shift;
  const int num_slots = num_nodes * k;
  const int rows_per_block = kThreads >> shift;
  const int blocks = (num_slots + rows_per_block - 1) / rows_per_block;
  nei_gather_kernel<V><<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const V*>(x), table, deg, reinterpret_cast<V*>(out),
      num_slots, k, cols, shift);
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Launches that took the float4 path.
long long float4_launches = 0;

}  // namespace

// counts[0]: the float4 launches of K4's forward since the library was
// loaded; its other launches took one float a lane.
extern "C" void nei_gather_float4_launches(long long* counts) {
  counts[0] = float4_launches;
}

// Launches K4's forward on `stream`: out [num_nodes, k, num_features] from
// x [num_nodes, num_features]; returns cudaGetLastError() as an int.  It
// refuses (cudaErrorInvalidValue) sizes whose output int32 cannot index.
extern "C" int nei_gather_f32(const float* x, const int* table,
                              const int8_t* deg, float* out, int num_nodes,
                              int k, int num_features, cudaStream_t stream) {
  if (num_nodes < 0 || k < 1 || num_features < 1
      || static_cast<int64_t>(num_nodes) * k * num_features
             >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_nodes == 0) return static_cast<int>(cudaSuccess);
  if (num_features % 4 == 0 && aligned16(x) && aligned16(out)) {
    ++float4_launches;
    return nei_gather_launch<float4>(x, table, deg, out, num_nodes, k,
                                     num_features, stream);
  }
  return nei_gather_launch<float>(x, table, deg, out, num_nodes, k,
                                  num_features, stream);
}
