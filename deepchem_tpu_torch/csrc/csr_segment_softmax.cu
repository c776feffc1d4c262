// Per-segment softmax of CSR-sorted logits, forward.
//
// Replaces the TPU kernel deepchem_tpu/ops/pallas_segment.py
// :_csr_segment_softmax_kernel (P1).  For each node i and head h it computes
// the softmax of logits[row_ptr[i]:row_ptr[i+1], h] as the TPU kernel does
// (:167-183): m is the segment max, NaN if a logit is NaN, and becomes 0
// where it is not finite; s = sum of exp(x - m), clamped to at least 1e-16
// by a max that keeps NaN; out = exp(x - m) / s.  So a segment with no
// finite logit and no +inf or NaN (all -inf) gives 0, and one with a +inf
// or a NaN logit has m = 0 and s = +inf, or NaN where a logit is NaN: its
// outputs are exp(x) / s, 0 or NaN.
//
// Bound on this card: memory bytes.  The work is a few flops per element; a
// call reads E*H*4 bytes of logits twice (the max/sum pass and the write
// pass; the second read mostly hits L2) and writes E*H*4 once.  A PAGTN
// predict batch (16 molecules of ~18 heavy atoms, complete graphs, padded to
// E = 6144 by the 2048-edge quantum, H = 1) moves ~74 KB, ~22 ns at
// 3.35 TB/s, so at that shape neither bandwidth nor flops set the time.
// Latency does: padded edges all belong to the last (ghost) node, whose
// segment holds ~1.5k edges.  One warp walking it 32 edges a step, a
// dependent load and expf each, took ~16 us (PERF.md); so a long segment is
// split across the block, and every pass keeps several loads in flight.
//
// Design.  A block of 8 warps owns 8 consecutive nodes.  A warp folds a
// range of edges into an online-softmax pair per lane (running max m, sum s
// rescaled to m), kUnroll edges a lane at a time: their loads are issued
// together, and the chunk's max is taken before its exponentials, so those
// are independent too.  A range of at most 32 edges (a real node's, in
// PAGTN) takes one edge a lane and no unrolled step, whose predicated-off
// work doubled the time of many short segments with H = 8 (PERF.md).  The
// warp merges its lanes' pairs with butterfly shuffles, so every lane ends
// with the same (m, s); a second pass writes exp(x - m) / max(s, 1e-16).
//   A +inf or NaN logit makes the TPU kernel's max not finite, so its m is
// 0, and its s = sum of exp(x) is exactly +inf, or NaN if a logit is NaN:
// the write pass runs with those, with no second pass over the segment.
// The online max tells such a segment by itself: it is taken by
// max.NaN.f32, which keeps a NaN where fmaxf would drop it (as JAX's
// jnp.maximum keeps it), so the merged max is NaN where a logit is NaN,
// else +inf where one is +inf.  (The sum beside it is then NaN, and
// unused.)  On finite logits max.NaN.f32 equals fmaxf, so they keep the
// bits of a max taken by fmaxf.
//   A segment of at most kSplitEdges edges is its own warp's work.  A
// longer one (the ghost node's) is split across the whole block, once every
// warp is done with its own node: warp w folds the w-th of 8 contiguous,
// equal parts, the 8 pairs are merged in warp order through shared memory
// (every warp merges them alike), and each warp writes its part.  Every
// warp reads the block's 9 row_ptr entries itself (one load, then
// shuffles), so a block without a long segment takes no barrier.  (P3 in
// csr_segment_sum.cu splits the same way.)  No atomics are used, and every
// sum is taken in a fixed order, so a repeat is bit-identical.  Nodes own
// disjoint output rows, so an empty segment writes nothing.  A segment
// whose logits are all equal (e.g. all masked to NEG) yields 1/count.
// Heads are walked one after another (H = 1 in PAGTN).
//
// Inputs: logits [E, H] float32 row-major, row_ptr [N+1] int32 non-decreasing
// with row_ptr[N] == E.  Ranges are clamped to [0, E] so a bad row_ptr can
// never write outside the output.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;
// Edges a lane loads at once, in each pass.
constexpr int kUnroll = 8;
// Longest segment one warp takes alone; longer ones are split across the
// block (as in P3).  The ghost segment's ~1.5k edges then take each warp
// one step of kUnroll edges a lane, in each pass.
constexpr int kSplitEdges = 128;

// The larger of a and b, NaN if either is NaN.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Merge the online-softmax pair (m2, s2) into (m, s).
__device__ __forceinline__ void merge_pair(float& m, float& s, float m2,
                                           float s2) {
  const float mn = max_nan(m, m2);
  if (mn == -INFINITY) {  // both sides saw no finite logit
    s = 0.f;
    return;
  }
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

// The online-softmax pair of head h over edges [start, end), merged across
// the warp: every lane returns the same (m, s); m is NaN where a logit is
// NaN, else +inf where one is +inf (s then means nothing).  All 32 lanes
// must call it.
__device__ __forceinline__ void warp_pair(const float* __restrict__ logits,
                                          int64_t stride, int h, int start,
                                          int end, float& m, float& s) {
  const int lane = threadIdx.x & 31;
  m = -INFINITY;
  s = 0.f;
  if (end - start <= 32) {  // warp-uniform: at most one edge a lane
    const int e = start + lane;
    if (e < end) {
      m = logits[e * stride + h];
      s = m == -INFINITY ? 0.f : 1.f;
    }
  }
  for (int base = start; end - start > 32 && base < end;
       base += 32 * kUnroll) {
    float x[kUnroll];
    float cmax = -INFINITY;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = base + lane + 32 * u;
      x[u] = e < end ? logits[e * stride + h] : -INFINITY;
      cmax = max_nan(cmax, x[u]);
    }
    const float mn = max_nan(m, cmax);
    if (mn == -INFINITY) continue;  // nothing finite yet: s stays 0
    float add = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add += expf(x[u] - mn);
    s = s * expf(m - mn) + add;
    m = mn;
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float m2 = __shfl_xor_sync(kFullMask, m, offset);
    const float s2 = __shfl_xor_sync(kFullMask, s, offset);
    merge_pair(m, s, m2, s2);
  }
}

// The max to shift by and the denominator from the merged pair, as the TPU
// kernel takes them: a max that is not finite becomes 0, and the sum is
// clamped to at least 1e-16 by a max that keeps NaN.  Where m is NaN or
// +inf, the sum of exp(x - 0) is NaN or +inf.
__device__ __forceinline__ float finish(float& m, float s) {
  float denom = fmaxf(s, 1e-16f);
  if (!isfinite(m)) {
    if (m != -INFINITY) denom = m == INFINITY ? INFINITY : NAN;
    m = 0.f;
  }
  return denom;
}

// out = exp(x - m) / denom over edges [start, end) of head h.
__device__ __forceinline__ void warp_write(const float* __restrict__ logits,
                                           float* __restrict__ out,
                                           int64_t stride, int h, int start,
                                           int end, float m, float denom) {
  const int lane = threadIdx.x & 31;
  if (end - start <= 32) {  // warp-uniform: at most one edge a lane
    const int e = start + lane;
    if (e < end) {
      out[e * stride + h] = expf(logits[e * stride + h] - m) / denom;
    }
    return;
  }
  for (int base = start; base < end; base += 32 * kUnroll) {
    float x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = base + lane + 32 * u;
      x[u] = e < end ? logits[e * stride + h] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = base + lane + 32 * u;
      if (e < end) out[e * stride + h] = expf(x[u] - m) / denom;
    }
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_segment_softmax_kernel(const float* __restrict__ logits,
                           const int* __restrict__ row_ptr,
                           float* __restrict__ out, int num_nodes,
                           int num_edges, int num_heads) {
  __shared__ float part_m[kWarpsPerBlock], part_s[kWarpsPerBlock];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int node0 = blockIdx.x * kWarpsPerBlock;
  const int nodes = min(kWarpsPerBlock, num_nodes - node0);
  const int64_t stride = num_heads;
  // Every warp reads the block's bounds, clamped to [0, E]: lane j holds
  // the start of node0 + j.  So each warp knows which of the block's nodes
  // are long without shared memory, and a block with none never waits at a
  // barrier.
  int bound = 0;
  if (lane <= nodes) bound = min(max(row_ptr[node0 + lane], 0), num_edges);
  unsigned long_nodes = 0;  // bit w: node0 + w is split across the block
  int start = 0, end = 0;
#pragma unroll
  for (int w = 0; w < kWarpsPerBlock; ++w) {
    const int s = __shfl_sync(kFullMask, bound, w);
    const int e = max(__shfl_sync(kFullMask, bound, w + 1), s);
    if (w < nodes && e - s > kSplitEdges) long_nodes |= 1u << w;
    if (w == warp) {
      start = s;
      end = e;
    }
  }
  if (warp < nodes && !(long_nodes >> warp & 1)) {  // uniform in the warp
    for (int h = 0; h < num_heads; ++h) {
      float m, s;
      warp_pair(logits, stride, h, start, end, m, s);
      const float denom = finish(m, s);
      warp_write(logits, out, stride, h, start, end, m, denom);
    }
  }
  while (long_nodes != 0) {  // uniform across the block
    const int w = __ffs(long_nodes) - 1;
    long_nodes &= long_nodes - 1;
    const int s0 = __shfl_sync(kFullMask, bound, w);
    const int len = max(__shfl_sync(kFullMask, bound, w + 1), s0) - s0;
    const int ps = s0 + (int)((int64_t)len * warp / kWarpsPerBlock);
    const int pe = s0 + (int)((int64_t)len * (warp + 1) / kWarpsPerBlock);
    for (int h = 0; h < num_heads; ++h) {
      float m, s;
      warp_pair(logits, stride, h, ps, pe, m, s);
      __syncthreads();  // every warp is done reading the previous pairs
      if (lane == 0) {
        part_m[warp] = m;
        part_s[warp] = s;
      }
      __syncthreads();
      m = part_m[0];
      s = part_s[0];
#pragma unroll
      for (int k = 1; k < kWarpsPerBlock; ++k) {
        merge_pair(m, s, part_m[k], part_s[k]);
      }
      const float denom = finish(m, s);
      warp_write(logits, out, stride, h, ps, pe, m, denom);
    }
  }
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError() as an int.
extern "C" int csr_segment_softmax_f32(const float* logits,
                                       const int* row_ptr, float* out,
                                       int num_nodes, int num_edges,
                                       int num_heads, cudaStream_t stream) {
  const int blocks = (num_nodes + kWarpsPerBlock - 1) / kWarpsPerBlock;
  csr_segment_softmax_kernel<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      logits, row_ptr, out, num_nodes, num_edges, num_heads);
  return static_cast<int>(cudaGetLastError());
}
