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
// least traffic reads each row of h that an edge names once (R*F*s, s = 4
// or 2 bytes), src (E*4) and row_ptr ((N+1)*4) and writes out (N*F*s);
// when rows of h are not reused from cache each edge reads its row again,
// E*F*s.  At the bench's shapes (E = 2 N, F 64-512) the two differ by
// about 2x.  DMPNN's [4096, 300] edge sums (batch 100) need about 7.5 MB,
// 2.2 us at 3.35 TB/s.  Latency sets the time below a few MB: the COO
// callers that keep the ghost edges (ops/coo.py: every one runs from the
// last node into the last node) hand the kernel one segment of a few
// hundred to 1500 edges, and the edges one warp walks form a chain of
// round trips.
//
// float32 design.  A block of 8 warps owns 8 consecutive nodes, and each
// output row has one writer: no atomics, so the result is the same on
// every run.  A row is read as `cols` vectors: float4 (16-byte loads) when
// F % 4 == 0 and h and out are 16-byte aligned, else single floats.  A
// warp's lanes form 32/g groups of g lanes (g a power of two, g >= cols up
// to 32); a lane holds the U >= ceil(cols / g) vectors c, c + g, ... of
// its columns, at most 4 float4 or 16 floats, so a row of up to 512
// floats is summed in one walk of its segment's src in either layout (a
// wider row takes passes of 32 * U vectors, each walking src again).  The
// groups split a range of edges (group k takes edges k, k + 32/g, ...),
// each summing its edges in order, and a fixed xor-shuffle butterfly
// merges the groups.
//   Rows in flight: a warp loads 32 src indices at a time (one a lane,
// coalesced), fetching the next 32 while it sums these, and hands them
// round with __shfl_sync.  A lane issues the loads of kAhead edges' U
// vectors (Ahead, below) before it adds the first, so a step of the
// warp costs one round trip for up to 32 / g * kAhead edges, and a wide
// row's vectors are in flight together; each lane group still adds its
// edges in one fixed order.
//   Long segments: a segment of at most kSplitEdges edges is summed by its
// own warp.  A longer one (the ghost node's, a hub's) is split across the
// whole block, once every warp is done with its own node: warp w sums
// the w-th of 8 contiguous, equal ranges of the segment, and warp 0 adds
// the 8 partial rows (U * 32 vectors each, 16 KB at F 512) from shared
// memory in warp order.  Every warp reads the block's 9 row_ptr entries
// itself (one load, a shuffle and a ballot), so a block without a long
// segment never waits at a barrier.  A segment far longer than a block
// can walk quickly is still one block's work, bound by what one SM keeps
// in flight (PERF.md gives its times beside the library call's);
// splitting it across blocks would take a second, fixed-order pass.
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
// Longest segment one warp sums alone; longer ones are split across the
// block.  The same as P1's and P3's (csr_segment_softmax.cu,
// csr_segment_sum.cu).
constexpr int kSplitEdges = 128;
// Vectors a lane holds of a row at most: 4 float4 or 16 floats.
template <typename V>
struct MaxUnits {
  static constexpr int value = 16;
};
template <>
struct MaxUnits<float4> {
  static constexpr int value = 4;
};
// Edges whose loads a lane issues before its first add, by U (the vectors
// it holds of a row) up to 4: on a warp's own segment, mostly a few
// edges, and on a part of a split one, more than kSplitEdges / 8.  Rows
// in flight cost registers, and a kernel's register count sets its
// occupancy on every path.  Both tables were chosen by measurement on an
// H100 (scripts/bench_gather_sum.py; PERF.md).
constexpr int kAheadOwn[5] = {0, 4, 4, 5, 4};
constexpr int kAheadSplit[5] = {0, 6, 4, 5, 4};

// kAhead for U vectors a lane: the tables' entries up to 4; past 4
// (single floats only), 32 floats a lane in flight.
template <int U>
struct Ahead {
  static constexpr int own = U <= 4 ? kAheadOwn[U <= 4 ? U : 0] : 32 / U;
  static constexpr int split =
      U <= 4 ? kAheadSplit[U <= 4 ? U : 0] : 32 / U;
};

// The sum of h[src[e]] over e in [start, end) at the lane's vectors
// c_first, c_first + g, ... (those past the row's end, cols, are read at
// cols - 1 and never stored), merged across the warp's lane groups: every
// lane of group 0 ends with its columns' sums in acc.  All 32 lanes must
// call it.
template <int kAhead, typename V, int U>
__device__ __forceinline__ void warp_gather_sum(
    const V* __restrict__ h, const int* __restrict__ src, int64_t row,
    int num_rows, int start, int end, int c_first, int cols, int g,
    V (&acc)[U]) {
  const int lane = threadIdx.x & 31;
  const int groups = 32 / g;
  const int group = lane / g;
  int c[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    c[u] = min(c_first + u * g, cols - 1);
    acc[u] = warp_vec::zero(V());
  }
  int next = start + lane < end ? src[start + lane] : 0;
  for (int base = start; base < end; base += 32) {  // uniform in the warp
    const int n = min(32, end - base);
    const int mine = min(max(next, 0), num_rows - 1);
    if (base + 32 + lane < end) next = src[base + 32 + lane];
    for (int j0 = 0; j0 < n; j0 += groups * kAhead) {
      V v[kAhead][U];
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
        const int j = j0 + a * groups + group;
        const int s = __shfl_sync(warp_vec::kFullMask, mine, j & 31);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          v[a][u] = j < n ? h[s * row + c[u]] : warp_vec::zero(V());
        }
      }
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
#pragma unroll
        for (int u = 0; u < U; ++u) warp_vec::add(acc[u], v[a][u]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = warp_vec::merge_groups(acc[u], g);
}

// V is float or float4; cols vectors a row; g lanes a group (a power of
// two, 1..32); U vectors a lane, U * g >= cols unless U is
// MaxUnits<V>::value.
// Launched with kWarpsPerBlock * 32 threads.  (Under __launch_bounds__ of
// that size ptxas capped some instances at 40-64 registers and spilled;
// without it none spills, at the same speed.)
template <typename V, int U>
__global__ void fused_gather_segment_sum_kernel(const V* __restrict__ h,
                                const int* __restrict__ src,
                                const int* __restrict__ row_ptr,
                                V* __restrict__ out, int num_nodes,
                                int num_rows, int num_edges, int cols,
                                int g) {
  __shared__ V part[kWarpsPerBlock][U][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int node0 = blockIdx.x * kWarpsPerBlock;
  const int nodes = min(kWarpsPerBlock, num_nodes - node0);
  const int64_t row = cols;
  const int c_lane = lane & (g - 1);
  const bool lead = lane < g;  // group 0, which holds the merged sums
  // Every warp reads the block's bounds, clamped to [0, E]: lane j holds
  // the start of node0 + j and the length of its segment.  So each warp
  // knows which of the block's nodes are long without shared memory, and
  // a block with none never waits at a barrier.
  int bound = 0;
  if (lane <= nodes) bound = min(max(row_ptr[node0 + lane], 0), num_edges);
  const int len =
      max(__shfl_down_sync(warp_vec::kFullMask, bound, 1), bound) - bound;
  // bit w: node0 + w is split across the block
  unsigned long_nodes =
      __ballot_sync(warp_vec::kFullMask, lane < nodes && len > kSplitEdges);
  const int start = __shfl_sync(warp_vec::kFullMask, bound, warp);
  const int end = start + __shfl_sync(warp_vec::kFullMask, len, warp);
  if (warp < nodes && !(long_nodes >> warp & 1)) {  // uniform in the warp
    for (int c0 = 0; c0 < cols; c0 += U * g) {
      V acc[U];
      warp_gather_sum<Ahead<U>::own>(h, src, row, num_rows, start, end,
                                     c0 + c_lane, cols, g, acc);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = c0 + c_lane + u * g;
        if (lead && c < cols) out[(node0 + warp) * row + c] = acc[u];
      }
    }
  }
  while (long_nodes != 0) {  // uniform across the block
    const int w = __ffs(long_nodes) - 1;
    long_nodes &= long_nodes - 1;
    const int s = __shfl_sync(warp_vec::kFullMask, bound, w);
    const int n = __shfl_sync(warp_vec::kFullMask, len, w);
    const int ps = s + (int)((int64_t)n * warp / kWarpsPerBlock);
    const int pe = s + (int)((int64_t)n * (warp + 1) / kWarpsPerBlock);
    for (int c0 = 0; c0 < cols; c0 += U * g) {
      V acc[U];
      warp_gather_sum<Ahead<U>::split>(h, src, row, num_rows, ps, pe,
                                       c0 + c_lane, cols, g, acc);
      __syncthreads();  // warp 0 is done reading the previous parts
      if (lead) {
#pragma unroll
        for (int u = 0; u < U; ++u) part[warp][u][lane] = acc[u];
      }
      __syncthreads();
      if (warp == 0 && lead) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = c0 + c_lane + u * g;
          if (c >= cols) continue;
          V sum = part[0][u][lane];
#pragma unroll
          for (int k = 1; k < kWarpsPerBlock; ++k) {
            warp_vec::add(sum, part[k][u][lane]);
          }
          out[(node0 + w) * row + c] = sum;
        }
      }
    }
  }
}

template <typename V, int U>
void launch_units(const V* h, const int* src, const int* row_ptr, V* out,
                  int num_nodes, int num_rows, int num_edges, int cols,
                  int g, cudaStream_t stream) {
  const int blocks = (num_nodes + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fused_gather_segment_sum_kernel<V, U>
      <<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
          h, src, row_ptr, out, num_nodes, num_rows, num_edges, cols, g);
}

// Launches the float32 kernel with U >= ceil(cols / g) vectors a lane (1,
// 2, 3, 4, then 8, 12 or 16 single floats), at most MaxUnits<V>::value.
template <typename V>
void launch_f32(const V* h, const int* src, const int* row_ptr, V* out,
                int num_nodes, int num_rows, int num_edges, int cols,
                cudaStream_t stream) {
  const int g = warp_vec::lanes_per_group(cols);
  const int units = (cols + g - 1) / g;
#define P2_LAUNCH(U)                                                     \
  launch_units<V, U>(h, src, row_ptr, out, num_nodes, num_rows, num_edges, \
                     cols, g, stream)
  if (units <= 1) {
    P2_LAUNCH(1);
  } else if (units <= 2) {
    P2_LAUNCH(2);
  } else if (units <= 3) {
    P2_LAUNCH(3);
  } else if (MaxUnits<V>::value == 4 || units <= 4) {
    P2_LAUNCH(4);
  } else if constexpr (MaxUnits<V>::value == 16) {
    if (units <= 8) {
      P2_LAUNCH(8);
    } else if (units <= 12) {
      P2_LAUNCH(12);
    } else {
      P2_LAUNCH(16);
    }
  }
#undef P2_LAUNCH
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
  const bool vec4 = num_features % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec4) {
    launch_f32(reinterpret_cast<const float4*>(h), src, row_ptr,
               reinterpret_cast<float4*>(out), num_nodes, num_rows,
               num_edges, num_features / 4, stream);
  } else {
    launch_f32(h, src, row_ptr, out, num_nodes, num_rows, num_edges,
               num_features, stream);
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
