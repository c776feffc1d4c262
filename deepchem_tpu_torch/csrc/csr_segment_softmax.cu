// Per-segment softmax of CSR-sorted logits, forward.
//
// Replaces the TPU kernel deepchem_tpu/ops/pallas_segment.py
// :_csr_segment_softmax_kernel (P1).  For each node i and head h it computes
// the softmax of logits[row_ptr[i]:row_ptr[i+1], h]: a segment max of -inf
// (no finite logit) becomes 0, and the sum of exponentials is clamped to at
// least 1e-16, as on the TPU.
//
// Bound on this card: memory bytes.  The work is a few flops per element; a
// call reads E*H*4 bytes of logits twice (the max/sum pass and the write
// pass; the second read mostly hits L2) and writes E*H*4 once.  A PAGTN
// predict batch (16 molecules of ~18 heavy atoms, complete graphs, padded to
// E = 6144 by the 2048-edge quantum, H = 1) moves ~74 KB, ~22 ns at
// 3.35 TB/s, so at that shape neither bandwidth nor flops set the time.
// Latency does: padded edges all belong to the last (ghost) node, so one
// warp walks ~1.5k edges, 32 at a time, twice.  Splitting long segments
// across a block is left to a later change.
//
// Design.  One warp per destination node; its lanes stride over the node's
// edge range, so neighbouring lanes read neighbouring rows.  Each lane keeps
// an online-softmax pair (running max m, sum s rescaled to m); the warp
// merges the pairs with butterfly shuffles, so every lane ends with the same
// (m, s) and no shared memory or atomics are used: the result is
// deterministic.  A second pass writes exp(x - m) / max(s, 1e-16).  Nodes own
// disjoint output rows, so an empty segment writes nothing.  A segment whose
// logits are all equal (e.g. all masked to NEG) yields 1/count.
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

// Merge the online-softmax pair (m2, s2) into (m, s).
__device__ __forceinline__ void merge_pair(float& m, float& s, float m2,
                                           float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) {  // both sides saw no finite logit
    s = 0.f;
    return;
  }
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_segment_softmax_kernel(const float* __restrict__ logits,
                           const int* __restrict__ row_ptr,
                           float* __restrict__ out, int num_nodes,
                           int num_edges, int num_heads) {
  const int lane = threadIdx.x & 31;
  const int node = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (node >= num_nodes) return;  // whole warp leaves together
  const int start = min(max(row_ptr[node], 0), num_edges);
  const int end = min(max(row_ptr[node + 1], start), num_edges);
  const int64_t stride = num_heads;

  for (int h = 0; h < num_heads; ++h) {
    float m = -INFINITY;
    float s = 0.f;
    for (int e = start + lane; e < end; e += 32) {
      const float x = logits[e * stride + h];
      if (x > m) {
        s = s * expf(m - x) + 1.f;
        m = x;
      } else if (m != -INFINITY) {
        s += expf(x - m);
      }
    }
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      const float m2 = __shfl_xor_sync(kFullMask, m, offset);
      const float s2 = __shfl_xor_sync(kFullMask, s, offset);
      merge_pair(m, s, m2, s2);
    }
    if (!isfinite(m)) m = 0.f;
    const float denom = fmaxf(s, 1e-16f);
    for (int e = start + lane; e < end; e += 32) {
      out[e * stride + h] = expf(logits[e * stride + h] - m) / denom;
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
