// Helpers shared by the sum kernels (csr_segment_sum.cu,
// fused_gather_segment_sum.cu, nei_table.cu): a row is read as float or
// float4 vectors by a group of lanes, and the warp-per-segment kernels merge
// lane groups with a fixed xor-shuffle butterfly.
#pragma once

#include <cuda_runtime.h>

namespace warp_vec {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float zero(float) { return 0.f; }
__device__ __forceinline__ float4 zero(float4) {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void add(float& a, float b) { a += b; }
__device__ __forceinline__ void add(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ float shfl_xor(float v, int offset) {
  return __shfl_xor_sync(kFullMask, v, offset);
}
__device__ __forceinline__ float4 shfl_xor(float4 v, int offset) {
  return make_float4(__shfl_xor_sync(kFullMask, v.x, offset),
                     __shfl_xor_sync(kFullMask, v.y, offset),
                     __shfl_xor_sync(kFullMask, v.z, offset),
                     __shfl_xor_sync(kFullMask, v.w, offset));
}

// Sums acc over the 32/g lane groups of g lanes (lanes that differ by a
// multiple of g), in the same order on every run; every lane ends with the
// sum.  All 32 lanes must call it.
template <typename V>
__device__ __forceinline__ V merge_groups(V acc, int g) {
  for (int offset = g; offset < 32; offset <<= 1) {
    add(acc, shfl_xor(acc, offset));
  }
  return acc;
}

// Lanes a group: the least power of two >= cols, at most 32.
inline int lanes_per_group(int cols) {
  int g = 1;
  while (g < cols && g < 32) g <<= 1;
  return g;
}

}  // namespace warp_vec
