// Fused gather and segment sum over CSR edge ranges, forward.
//
// Replaces the TPU kernel deepchem_tpu/ops/pallas_segment.py
// :_fused_gather_segment_kernel (P2, called from fused_gather_segment_sum).
// For each node i it computes out[i, :] = sum of h[src[e], :] over e in
// [row_ptr[i], row_ptr[i+1]) without writing the gathered messages to
// memory; an empty segment gives 0.  Two entries: float32 and bfloat16
// (and, at the end, three that measure the bfloat16 kernel's bounds).
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
// bfloat16 design.  The TPU kernel keeps its sum in bfloat16 and adds a
// segment's edges in CSR order, each add rounded; so does this one, and
// nothing reassociates a column's adds: no split of a segment by edges, no
// tree, no float32 sum rounded once.  The result is bit for bit the plain
// version's.  An add is add.rn.bf16 on one value or on two at once, the
// correctly rounded sum, which the float32 add rounded by cvt.rn.bf16
// (the plain version's arithmetic on the card) also gives: the float32
// sum of two bfloat16 values loses nothing that a second rounding could
// see.  A row is read in units of W = 8, 4, 2 or 1 values,
// the widest that F and the alignment of h and out allow.  A group of g
// lanes owns a node (g a power of two; a lane holds U <= 4 units, so a row
// of up to 128 units is walked once), a warp 32/g consecutive nodes, a
// block of kBf16Warps warps kBf16Warps * 32/g: at the bench's N 2048, F
// 64 and 256, 128 and 512 blocks for 132 SMs.
//   Short segments.  The nodes of a warp have contiguous CSR ranges: the
// warp loads their src 32 at a time (one a lane, coalesced; a long
// segment between them is skipped), the next 32 in flight, and hands them
// to the groups by __shfl_sync.  A group issues the loads of up to kAhead
// edges' units (kAheadRegs registers a lane) before its first add, then
// adds them in CSR order, so a short segment costs three round trips:
// row_ptr, src, rows.  Only the units of edges and columns that are there
// are loaded: on this card a warp keeps few scattered loads in flight, so
// a load it wastes costs about as much as one it needs.
//   Long segments (over kSplitEdges edges) are bound by their order chain
// (the segment's length times the latency of one dependent add) and by
// how fast one SM fetches scattered rows, not by bytes.  Such a segment is
// summed by the whole block once its warps are done with their own nodes.
// The block's threads divide the row by columns, 4-byte words of two
// values (one value where W is 1), up to kLongUnits a thread, and each
// thread adds its columns over every edge in CSR order, one value at a
// time: a word's halves are two chains, since one add.rn.bf16 takes about
// half the latency of a packed add on an H100 (chip_smoke.bf16_add_ns).
// The block stages src in shared memory kIdxChunk indices at a time,
// coalesced, and copies the rows into a ring in shared memory, cp.async of
// a unit (16 or 8 bytes) where W >= 4, else of 4 bytes (where W is 1, the
// aligned word that holds the value), kRingStages - 1 batches of edges
// ahead of the adds.  Warps that add no column copy alone, so copies and
// adds overlap; where every warp adds, every warp also copies.  A barrier
// a batch hands the copies to the adds.  A block without a long segment
// passes one barrier at its end.
//
// Indices are clamped to [0, N_h), so a bad src never reads outside h.
// Inputs: h [N_h, F] row-major, src [E] int32 in CSR (dst-sorted) order,
// row_ptr [N+1] int32 non-decreasing with row_ptr[0] == 0.  Ranges are
// clamped to [0, E].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cstring>

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

// ------------------------------------------------------------ bfloat16

// Warps a block of the bfloat16 kernel.
constexpr int kBf16Warps = 4;
constexpr int kBf16Threads = kBf16Warps * 32;
// Values a unit of a row holds at most (8: 16-byte loads).
constexpr int kUnitValues = 8;
// Lanes a group at most before a lane holds more than one unit of its
// row: 32 while the kernel waits on round trips (few nodes), 16 from
// kWideNodes nodes on, where fewer instructions a row pay more than more
// loads in flight a node (measured on an H100: scripts/bench_gather_sum.py).
constexpr int kGroupLanes = 32;
constexpr int kWideNodes = 4096;
// Short segments: registers a lane spends on rows in flight (one unit a
// lane, then more), and the most edges whose loads it issues before
// adding.  A lane of several units keeps fewer edges in flight, and the
// kernel more warps (measured on an H100: scripts/bench_gather_sum.py).
constexpr int kAheadRegs = 32;
constexpr int kAheadRegsUnits = 24;
constexpr int kAheadMax = 8;
// Long segments: the ring's bytes and batches, src indices staged at a
// time, and columns (words, or values where W is 1) a thread holds.
constexpr int kRingBytes = 24576;
constexpr int kRingStages = 4;
constexpr int kIdxChunk = 256;
constexpr int kLongUnits = 2;
// Edges whose units a thread reads ahead of its adds (over its columns).
constexpr int kAddAhead = 8;
constexpr int kLongCols = kLongUnits * kBf16Threads;

__device__ __forceinline__ __nv_bfloat162 as_bf162(unsigned u) {
  __nv_bfloat162 r;
  memcpy(&r, &u, 4);
  return r;
}

__device__ __forceinline__ unsigned bits_of(__nv_bfloat162 v) {
  unsigned u;
  memcpy(&u, &v, 4);
  return u;
}

// a + b for two bfloat16 values a word, each rounded to nearest even
// (add.rn.bf16x2).  On an H100 it gives the plain version's bits, NaN
// included, as torch's float32 add rounded by cvt.rn.bf16 does, and is
// faster than that add in the kernel.
__device__ __forceinline__ unsigned add_bf16x2(unsigned a, unsigned b) {
  return bits_of(__hadd2(as_bf162(a), as_bf162(b)));
}

// a + b for one bfloat16 value each, rounded the same way (add.rn.bf16).
__device__ __forceinline__ __nv_bfloat16 add_bf16(__nv_bfloat16 a,
                                                  __nv_bfloat16 b) {
  return __hadd(a, b);
}

// The bfloat16 value in the low half of a word.
__device__ __forceinline__ __nv_bfloat16 low_bf16(unsigned w) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(w));
}

// A unit of W bfloat16 values as loaded (T) and as summed: kWords words of
// two values each, or one value in the low half where W is 1.
template <int W>
struct Bf16Unit;

template <>
struct Bf16Unit<8> {
  using T = uint4;
  static constexpr int kWords = 4;
  __device__ static void add(unsigned (&acc)[4], uint4 v) {
    acc[0] = add_bf16x2(acc[0], v.x);
    acc[1] = add_bf16x2(acc[1], v.y);
    acc[2] = add_bf16x2(acc[2], v.z);
    acc[3] = add_bf16x2(acc[3], v.w);
  }
  __device__ static uint4 pack(const unsigned (&acc)[4]) {
    return make_uint4(acc[0], acc[1], acc[2], acc[3]);
  }
};

template <>
struct Bf16Unit<4> {
  using T = uint2;
  static constexpr int kWords = 2;
  __device__ static void add(unsigned (&acc)[2], uint2 v) {
    acc[0] = add_bf16x2(acc[0], v.x);
    acc[1] = add_bf16x2(acc[1], v.y);
  }
  __device__ static uint2 pack(const unsigned (&acc)[2]) {
    return make_uint2(acc[0], acc[1]);
  }
};

template <>
struct Bf16Unit<2> {
  using T = unsigned;
  static constexpr int kWords = 1;
  __device__ static void add(unsigned (&acc)[1], unsigned v) {
    acc[0] = add_bf16x2(acc[0], v);
  }
  __device__ static unsigned pack(const unsigned (&acc)[1]) { return acc[0]; }
};

template <>
struct Bf16Unit<1> {
  using T = unsigned short;
  static constexpr int kWords = 1;
  __device__ static void add(unsigned (&acc)[1], unsigned short v) {
    acc[0] = __bfloat16_as_ushort(add_bf16(low_bf16(acc[0]), low_bf16(v)));
  }
  __device__ static unsigned short pack(const unsigned (&acc)[1]) {
    return static_cast<unsigned short>(acc[0]);
  }
};

// Edges whose loads a lane issues before adding, by W and U.
template <int W, int U>
struct Bf16Ahead {
  static constexpr int regs = U == 1 ? kAheadRegs : kAheadRegsUnits;
  static constexpr int value = regs / (U * Bf16Unit<W>::kWords) < kAheadMax
                                   ? regs / (U * Bf16Unit<W>::kWords)
                                   : kAheadMax;
};

__device__ __forceinline__ int clamp_edge(int e, int num_edges) {
  return min(max(e, 0), num_edges);
}

// cp.async of 16 bytes, around L1.
__device__ __forceinline__ void cp_async16(unsigned* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Block-wide: sidx[k & 1] = the clamped src of the segment's edges
// k * kIdxChunk ... (0 past its n edges).
__device__ __forceinline__ void stage_src(int (*sidx)[kIdxChunk],
                                          const int* __restrict__ src,
                                          int start, int n, int k,
                                          int num_rows) {
  for (int i = threadIdx.x; i < kIdxChunk; i += kBf16Threads) {
    const int e = k * kIdxChunk + i;
    sidx[k & 1][i] = e < n ? min(max(src[start + e], 0), num_rows - 1) : 0;
  }
}

// Address of unit q of row s (row units a row): a word of two values where
// W > 1, a value where W is 1.
template <int W>
__device__ __forceinline__ const void* long_unit(const void* h, int64_t row,
                                                 int s, int q) {
  if constexpr (W > 1) {
    return static_cast<const unsigned*>(h) + s * row + q;
  } else {
    return static_cast<const unsigned short*>(h) + s * row + q;
  }
}

// A long segment's ring in shared memory: kRingStages batches of rows,
// each row the 16-byte chunks that cover one pass of a row of h (its first
// unit `shift` bytes into the first chunk, where W < 8), and src staged
// kIdxChunk indices at a time.
struct LongRing {
  unsigned* words;
  int (*sidx)[kIdxChunk];
  unsigned char* shift;  // a ring row's shift, kRingStages * batch of them
};

// A thread's adds of the edges [e_begin, e_end) of a batch (its rows from
// ring row r0 on, stride words a row) to its kUnits columns t, t +
// kBf16Threads, ... (units: words where W > 1, values where W is 1), in
// CSR order, kAddAhead / kUnits edges at a time: the units of the next
// ones are read while these are added (past the batch, its last edge
// again, never added).  A word's two values are two chains.
template <int W, int kUnits>
__device__ __forceinline__ void add_batch(
    __nv_bfloat16 (&lo)[kLongUnits], __nv_bfloat16 (&hi)[kLongUnits],
    const LongRing& ring, int r0, int stride, int e_begin, int e_end,
    int cols, int t) {
  constexpr int kAhead = kAddAhead / kUnits;
  auto read = [&](unsigned (&v)[kAhead][kUnits], int e0) {
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int r = r0 + min(e0 + a, e_end - 1) - e_begin;
      const unsigned char* row =
          reinterpret_cast<const unsigned char*>(ring.words + r * stride) +
          (W < 8 ? ring.shift[r] : 0);
#pragma unroll
      for (int k = 0; k < kUnits; ++k) {
        const int q = min(t + k * kBf16Threads, cols - 1);
        if constexpr (W > 1) {
          v[a][k] = reinterpret_cast<const unsigned*>(row)[q];
        } else {
          v[a][k] = reinterpret_cast<const unsigned short*>(row)[q];
        }
      }
    }
  };
  unsigned cur[kAhead][kUnits], next[kAhead][kUnits];
  read(next, e_begin);
  for (int e0 = e_begin; e0 < e_end; e0 += kAhead) {
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
#pragma unroll
      for (int k = 0; k < kUnits; ++k) cur[a][k] = next[a][k];
    }
    read(next, e0 + kAhead);
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
#pragma unroll
      for (int k = 0; k < kUnits; ++k) {
        if (e0 + a >= e_end || t + k * kBf16Threads >= cols) continue;
        lo[k] = add_bf16(lo[k], low_bf16(cur[a][k]));
        if constexpr (W > 1) {
          hi[k] = add_bf16(hi[k], low_bf16(cur[a][k] >> 16));
        }
      }
    }
  }
}

// The block's sum of the n edges of one long segment into out row `node`:
// row units (words where W > 1, values where W is 1) a row.  All threads
// of the block call it.  The threads that add (a thread its own columns)
// and the threads that copy the rows in are apart where the row leaves
// warps without columns, so the copies of later batches go on while a
// batch is added.  Copies are 16-byte chunks, spread over the copying
// threads in row order.
template <int W>
__device__ void long_segment_sum(const void* __restrict__ h,
                                 const int* __restrict__ src,
                                 void* __restrict__ out, int node, int start,
                                 int n, int num_rows, int row,
                                 const LongRing& ring) {
  constexpr int kUnitBytes = W > 1 ? 4 : 2;
  const int t = threadIdx.x;
  for (int c0 = 0; c0 < row; c0 += kLongCols) {  // uniform
    const int cols = min(row - c0, kLongCols);
    // a ring row: the chunks of the pass's bytes, one more where its
    // first unit may lie inside a chunk
    const int chunks = (cols * kUnitBytes + 15) / 16 + (W < 8 ? 1 : 0);
    const int stride = 4 * chunks;
    // warps with no column to add copy alone, where there are any
    const int adders = (min(cols, kBf16Threads) + 31) / 32 * 32;
    const int first = adders < kBf16Threads ? adders : 0;
    const int copiers = kBf16Threads - first;
    // edges a batch: kRingStages batches fill the ring, and the edges
    // between the batch being added and the last one issued span at most
    // two chunks of src
    const int batch =
        max(min(kIdxChunk / kRingStages, kRingBytes / 16 / chunks /
                                             kRingStages), 1);
    const int batches = (n + batch - 1) / batch;
    // the sums of a word's low and high values, or of a value
    __nv_bfloat16 lo[kLongUnits], hi[kLongUnits];
#pragma unroll
    for (int k = 0; k < kLongUnits; ++k) lo[k] = hi[k] = low_bf16(0u);
    __syncthreads();  // the block is done with the ring
    stage_src(ring.sidx, src, start, n, 0, num_rows);
    stage_src(ring.sidx, src, start, n, 1, num_rows);
    __syncthreads();
    int next_chunk = 2;
    // this thread's copies of the rows of batch b into the ring: copy i
    // of the batch is chunk i % chunks of its row i / chunks
    auto issue = [&](int b) {
      const int e0 = b * batch;
      const int copies = max(min(n - e0, batch), 0) * chunks;
      const int r0 = (b % kRingStages) * batch;
      int r = (t - first) / chunks, k = (t - first) % chunks;
      for (int i = t - first; i < copies && t >= first; i += copiers) {
        const int e = e0 + r;
        const int s = ring.sidx[(e / kIdxChunk) & 1][e % kIdxChunk];
        const uintptr_t a = reinterpret_cast<uintptr_t>(
            long_unit<W>(h, row, s, c0));
        const int shift = static_cast<int>(a & 15);
        if (k == 0 && W < 8) ring.shift[r0 + r] = shift;
        if (16 * k < shift + cols * kUnitBytes) {  // a chunk the row needs
          cp_async16(ring.words + (r0 + r) * stride + 4 * k,
                       reinterpret_cast<const void*>((a & ~uintptr_t(15)) +
                                                     16 * k));
        }
        k += copiers % chunks;
        r += copiers / chunks + (k >= chunks);
        if (k >= chunks) k -= chunks;
      }
      cp_async_commit();
    };
    for (int b = 0; b < kRingStages - 1; ++b) issue(b);
    for (int b = 0; b < batches; ++b) {  // uniform
      cp_async_wait<kRingStages - 2>();  // this thread's copies of batch b
      __syncthreads();  // everyone's, and batch b - 1 is added
      const int p = (b + kRingStages - 1) * batch;
      if (p < n && (min(p + batch, n) - 1) / kIdxChunk >= next_chunk) {
        stage_src(ring.sidx, src, start, n, next_chunk, num_rows);
        __syncthreads();  // chunk next_chunk - 2 was read by no one
        ++next_chunk;
      }
      issue(b + kRingStages - 1);  // into the rows of batch b - 1
      if (t >= cols) continue;
      const int r0 = (b % kRingStages) * batch;
      const int e_end = min(b * batch + batch, n);
      if (cols <= kBf16Threads) {  // uniform: a column a thread
        add_batch<W, 1>(lo, hi, ring, r0, stride, b * batch, e_end, cols, t);
      } else {
        add_batch<W, kLongUnits>(lo, hi, ring, r0, stride, b * batch, e_end,
                                 cols, t);
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int k = 0; k < kLongUnits; ++k) {
      const int q = t + k * kBf16Threads;
      if (q >= cols) continue;
      if constexpr (W > 1) {
        static_cast<unsigned*>(out)[node * static_cast<int64_t>(row) + c0 +
                                    q] = __bfloat16_as_ushort(lo[k]) |
                                         __bfloat16_as_ushort(hi[k]) << 16;
      } else {
        static_cast<unsigned short*>(out)[node * static_cast<int64_t>(row) +
                                          c0 + q] = __bfloat16_as_ushort(lo[k]);
      }
    }
  }
}

// W values a unit (Bf16Unit<W>::T); cols units a row; g lanes a group, one
// node a group; U units a lane, U * g >= cols unless U is 4 (then passes of
// 4 * g units).  Launched with kBf16Threads threads.
template <int W, int U>
__global__ void fused_gather_segment_sum_bf16_kernel(
    const typename Bf16Unit<W>::T* __restrict__ h,
    const int* __restrict__ src, const int* __restrict__ row_ptr,
    typename Bf16Unit<W>::T* __restrict__ out, int num_nodes, int num_rows,
    int num_edges, int cols, int g) {
  using Unit = Bf16Unit<W>;
  using T = typename Unit::T;
  constexpr int kAhead = Bf16Ahead<W, U>::value;
  __shared__ __align__(16) unsigned ring[kRingBytes / 4];
  __shared__ int sidx[2][kIdxChunk];
  __shared__ unsigned char shift[kIdxChunk];
  __shared__ unsigned long_lanes[kBf16Warps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = 32 / g, group = lane / g, c_lane = lane & (g - 1);
  const int node0 = (blockIdx.x * kBf16Warps + warp) * groups;
  const int nodes = min(groups, num_nodes - node0);  // <= 0: none
  const int64_t row = cols;
  // lane j holds the bounds of node node0 + j, clamped as the plain
  // version clamps them
  int lo_bound = 0;
  if (lane <= nodes) lo_bound = clamp_edge(row_ptr[node0 + lane], num_edges);
  int hi_bound = __shfl_down_sync(warp_vec::kFullMask, lo_bound, 1);
  if (lane == 31 && nodes == 32) {
    hi_bound = clamp_edge(row_ptr[node0 + 32], num_edges);
  }
  const int start = __shfl_sync(warp_vec::kFullMask, lo_bound, group);
  const int end =
      max(__shfl_sync(warp_vec::kFullMask, hi_bound, group), start);
  const bool is_long = group < nodes && end - start > kSplitEdges;
  const bool is_short = group < nodes && !is_long;
  // the warp's short segments lie in [lo, hi)
  const int lo = __reduce_min_sync(warp_vec::kFullMask,
                                   is_short ? start : INT_MAX);
  const int hi = __reduce_max_sync(warp_vec::kFullMask, is_short ? end : 0);
  for (int c0 = 0; c0 < cols; c0 += U * g) {  // uniform in the warp
    int c[U];
    bool mine[U];
    unsigned acc[U][Unit::kWords];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      c[u] = c0 + c_lane + u * g;
      mine[u] = c[u] < cols;
#pragma unroll
      for (int k = 0; k < Unit::kWords; ++k) acc[u][k] = 0u;
    }
    int next = lane < hi - lo ? src[lo + lane] : 0;  // no overflow at INT_MAX
    for (int base = lo; base < hi;) {  // uniform in the warp
      const int idx = min(max(next, 0), num_rows - 1);
      // the next 32 edges start at the first one past these that a short
      // segment of the warp still has: a long segment between is skipped
      const int after = __reduce_min_sync(
          warp_vec::kFullMask,
          is_short && end > base + 32 ? max(start, base + 32) : INT_MAX);
      if (lane < hi - after) next = src[after + lane];
      // this group's edges in [base, base + 32): lanes first ... + cnt
      const int first = max(start, base) - base;
      const int cnt = is_short ? max(min(end, base + 32) - base - first, 0)
                               : 0;
      const int steps = __reduce_max_sync(warp_vec::kFullMask, cnt);
      for (int j0 = 0; j0 < steps; j0 += kAhead) {
        T v[kAhead][U];
#pragma unroll
        for (int a = 0; a < kAhead; ++a) {
          const int s =
              __shfl_sync(warp_vec::kFullMask, idx, (first + j0 + a) & 31);
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (j0 + a < cnt && mine[u]) v[a][u] = h[s * row + c[u]];
          }
        }
#pragma unroll
        for (int a = 0; a < kAhead; ++a) {
          if (j0 + a >= cnt) break;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (mine[u]) Unit::add(acc[u], v[a][u]);
          }
        }
      }
      base = after;
    }
    if (is_short) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (mine[u]) out[(node0 + group) * row + c[u]] = Unit::pack(acc[u]);
      }
    }
  }
  // lanes that lead a group whose segment is long
  const unsigned lead_long =
      __ballot_sync(warp_vec::kFullMask, is_long && c_lane == 0);
  if (lane == 0) long_lanes[warp] = lead_long;
  if (!__syncthreads_or(lead_long != 0)) return;  // uniform in the block
  // row in long_segment_sum's units: words where W > 1, else values
  const int long_row = W > 1 ? cols * (W / 2) : cols;
  for (int w = 0; w < kBf16Warps; ++w) {
    for (unsigned bits = long_lanes[w]; bits != 0; bits &= bits - 1) {
      const int node =
          (blockIdx.x * kBf16Warps + w) * groups + (__ffs(bits) - 1) / g;
      const int s = clamp_edge(row_ptr[node], num_edges);
      const int e = max(clamp_edge(row_ptr[node + 1], num_edges), s);
      long_segment_sum<W>(h, src, out, node, s, e - s, num_rows, long_row,
                          LongRing{ring, sidx, shift});
    }
  }
}

// How the bfloat16 entry launches for these arguments: W values a unit,
// cols units a row, U units a lane, g lanes a group, blocks.
struct Bf16Launch {
  int w, cols, units, g, blocks;
};

Bf16Launch bf16_launch(const void* h, const void* out, int num_nodes,
                       int num_features) {
  Bf16Launch l;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(out);
  l.w = kUnitValues;
  while (l.w > 1 && (num_features % l.w != 0 || align % (2 * l.w) != 0)) {
    l.w /= 2;
  }
  l.cols = num_features / l.w;
  const int lanes = num_nodes < kWideNodes ? kGroupLanes : kGroupLanes / 2;
  l.units = l.cols <= lanes ? 1 : l.cols <= 2 * lanes ? 2 : 4;
  l.g = warp_vec::lanes_per_group((l.cols + l.units - 1) / l.units);
  const int nodes_per_block = kBf16Warps * (32 / l.g);
  l.blocks = (num_nodes + nodes_per_block - 1) / nodes_per_block;
  return l;
}

template <int W>
void launch_bf16(const Bf16Launch& l, const void* h, const int* src,
                 const int* row_ptr, void* out, int num_nodes, int num_rows,
                 int num_edges, cudaStream_t stream) {
  using T = typename Bf16Unit<W>::T;
#define P2_BF16_LAUNCH(U)                                                   \
  fused_gather_segment_sum_bf16_kernel<W, U>                                \
      <<<l.blocks, kBf16Threads, 0, stream>>>(                              \
          static_cast<const T*>(h), src, row_ptr, static_cast<T*>(out),     \
          num_nodes, num_rows, num_edges, l.cols, l.g)
  if (l.units == 1) {
    P2_BF16_LAUNCH(1);
  } else if (l.units == 2) {
    P2_BF16_LAUNCH(2);
  } else {
    P2_BF16_LAUNCH(4);
  }
#undef P2_BF16_LAUNCH
}

__global__ void p2_empty_kernel() {}

// A dependent chain of 8 * steps of the kernel's adds in one thread, on a
// word of two values (pair) or one value.
template <bool kPair>
__global__ void p2_bf16_add_chain_kernel(const unsigned* in, unsigned* out,
                                         int steps) {
  unsigned v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = in[k];
  unsigned acc = 0u;
  __nv_bfloat16 one = low_bf16(0u);
  for (int i = 0; i < steps; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if constexpr (kPair) {
        acc = add_bf16x2(acc, v[k]);
      } else {
        one = add_bf16(one, low_bf16(v[k]));
      }
    }
  }
  out[0] = kPair ? acc : __bfloat16_as_ushort(one);
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
  const Bf16Launch l = bf16_launch(h, out, num_nodes, num_features);
  if (l.w == 8) {
    launch_bf16<8>(l, h, src, row_ptr, out, num_nodes, num_rows, num_edges,
                   stream);
  } else if (l.w == 4) {
    launch_bf16<4>(l, h, src, row_ptr, out, num_nodes, num_rows, num_edges,
                   stream);
  } else if (l.w == 2) {
    launch_bf16<2>(l, h, src, row_ptr, out, num_nodes, num_rows, num_edges,
                   stream);
  } else {
    launch_bf16<1>(l, h, src, row_ptr, out, num_nodes, num_rows, num_edges,
                   stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// For the bounds of the bfloat16 kernel (chip_smoke.py,
// scripts/p2_bf16_launch_floor.py): an empty kernel at the grid and block
// the bfloat16 entry takes for these arguments, and at any other.
extern "C" int fused_gather_segment_sum_bf16_empty(const void* h,
                                                   const void* out,
                                                   int num_nodes,
                                                   int num_features,
                                                   cudaStream_t stream) {
  const Bf16Launch l = bf16_launch(h, out, num_nodes, num_features);
  p2_empty_kernel<<<l.blocks, kBf16Threads, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int p2_empty_launch(int blocks, int threads, cudaStream_t stream) {
  p2_empty_kernel<<<blocks, threads, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}

// One thread adds in[0..7] over and over, 8 * steps dependent adds of the
// kernel's own (two values a word where pair, else one), into out[0]:
// the latency of one add is the time of a chain over its length.
extern "C" int p2_bf16_add_chain(const void* in, void* out, int steps,
                                 int pair, cudaStream_t stream) {
  if (pair) {
    p2_bf16_add_chain_kernel<true><<<1, 1, 0, stream>>>(
        static_cast<const unsigned*>(in), static_cast<unsigned*>(out), steps);
  } else {
    p2_bf16_add_chain_kernel<false><<<1, 1, 0, stream>>>(
        static_cast<const unsigned*>(in), static_cast<unsigned*>(out), steps);
  }
  return static_cast<int>(cudaGetLastError());
}
