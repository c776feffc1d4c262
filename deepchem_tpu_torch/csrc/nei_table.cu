// Neighbour-table aggregations of GraphConv: the masked sum (K1) and the
// max over a node and its neighbours with its winner and backward (K2).
//
// Replace the custom-VJP XLA ops of deepchem_tpu/ops/nei_table.py, which the
// JAX package computes as slot-by-slot gathers, with no Pallas kernel:
//   K1  _slot_sum / nei_sum (:75-100):
//         out[i] = sum over j < deg[i] of h[table[i, j]], in ascending j.
//       Its backward is the same sum of the cotangent: an undirected
//       molecular graph's table is its own transpose.
//   K2  nei_max_incl_self (:103-149), forward: best = h[i], winner = i;
//         for j < deg[i] in ascending order, h[table[i, j]] > best (strict)
//         takes it.  So self wins a tie, then the lowest slot.
//       backward: grad[m] = g[m] [winner[m] == m]
//                   + sum over j < deg[m] of g[t] [winner[t] == m],
//         t = table[m, j], added in that order.
// Slots j >= deg[i] are skipped, not multiplied by a zero mask, so their
// table entries are never read.
//
// Bound on this card: memory bytes.  At GraphConv's main path (batch 256 of
// Tox21-size molecules, about 4.6k real nodes padded to 5120, F = 75 and
// 64) a call reads h or g once from device memory ([5120, 64] f32, 1.3 MB;
// a row's later reads by its neighbours hit L2), the table (205 KB) and
// the degrees, and writes [5120, 64]: about 2.8 MB, 0.8 us at 3.35 TB/s
// (K2's forward also writes the winners, K2's backward reads them).  At
// that size one wave of warps covers the grid and latency sets the time:
// the longest chain of dependent loads in a warp.
//
// K2's forward (nei_max_fwd_kernel) keeps the first design: one warp per
// node, 8 nodes a block; lane j < deg reads table[i, j] once after deg[i];
// each slot's index is broadcast by a shuffle, and the lanes run across
// the row's features, 32 a step, with single-float loads.
//
// K1 (nei_sum_kernel) and K2's backward (nei_max_bwd_kernel) had the same
// design, and its chain held them back: deg, then the table entry, then
// the slots one feature step at a time (F = 75 walked its slots three
// times, F = 64 twice), 4-byte loads, and in the backward each g[t] load
// waited on its winner[t] load.  Their design now:
// - Two round trips, not a chain.  A lane reads deg[i] and the table
//   entries of the first kSlots slots together (the table is a dense
//   [N, K] allocation, so a pad slot's entry is read but never followed;
//   K2's backward also reads the node's own winner and g here), then issues
//   the rows of every real slot of the group (j < deg; for K2's backward
//   both winner[t] and g[t]) before the first add, and reads the next
//   group's entries while they are in flight.  Slots go kSlots a group,
//   unrolled and predicated on j < deg: one group covers a Tox21 atom.
// - Each lane owns all its features: a group of 2^shift lanes holds a
//   node and each lane up to kMaxUnits units of the row (one pass over the
//   slots unless the row has more than 32 * kMaxUnits units).  With F a
//   multiple of 4 and 16-byte-aligned rows a unit is a float4 (and an
//   int4 of winners): F = 64 is 16 lanes, two nodes a warp.  Otherwise a
//   unit is one float: F = 75 is 32 lanes holding features lane, lane +
//   32 and lane + 64.  Each C entry picks the path itself and counts its
//   float4 launches (nei_table_float4_launches).  At GraphConv's [5120,
//   64] the float4 path takes K1 1.72 us against one float's 2.16, and
//   K2's backward 2.41-2.47 against 2.62-2.71 (scripts/bench_nei_table.py,
//   H100 80GB HBM3 at 700 W); at 1000 nodes, or F = 4 or 32, one float a
//   lane is as fast or faster.
// - The same bits as the first design: each sum starts from 0.f and adds
//   its terms in slot order, only where real (the backward's self term is
//   an assignment, its slot terms `if (w == m) acc += g`), so a -0.0
//   keeps its bits.  Each output element has one writer; no atomics.
//
// Inputs: h (or g) [N, F] float32 row-major, table [N, K] int32, deg [N]
// int8, K <= 32.  deg is clamped to [0, K]; table entries of real slots
// must lie in [0, N).

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_vec.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kSlots = 4;     // slots whose row loads are issued together
constexpr int kMaxUnits = 4;  // units of a row a lane holds in one pass

struct Row {
  int node;   // this warp's node, or -1 past the last
  int deg;    // clamped real slots
  int slot;   // lane j < deg: table[node, j]
};

__device__ __forceinline__ Row warp_row(const int* __restrict__ table,
                                        const int8_t* __restrict__ deg,
                                        int num_nodes, int k) {
  const int lane = threadIdx.x & 31;
  Row r;
  r.node = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r.node >= num_nodes) {
    r.node = -1;
    return r;
  }
  r.deg = min(max(static_cast<int>(deg[r.node]), 0), k);
  r.slot = lane < r.deg ? table[static_cast<int64_t>(r.node) * k + lane] : 0;
  return r;
}

// The winners' unit beside a float unit (int) or a float4 unit (int4).
template <typename V> struct WinnerOf { using T = int; };
template <> struct WinnerOf<float4> { using T = int4; };

// acc = v where w == m, per element: the self term is an assignment.
__device__ __forceinline__ void set_if(float& acc, float v, int w, int m) {
  if (w == m) acc = v;
}
__device__ __forceinline__ void set_if(float4& acc, float4 v, int4 w, int m) {
  set_if(acc.x, v.x, w.x, m);
  set_if(acc.y, v.y, w.y, m);
  set_if(acc.z, v.z, w.z, m);
  set_if(acc.w, v.w, w.w, m);
}
// acc += v where w == m, per element; never acc += 0.
__device__ __forceinline__ void add_if(float& acc, float v, int w, int m) {
  if (w == m) acc += v;
}
__device__ __forceinline__ void add_if(float4& acc, float4 v, int4 w, int m) {
  add_if(acc.x, v.x, w.x, m);
  add_if(acc.y, v.y, w.y, m);
  add_if(acc.z, v.z, w.z, m);
  add_if(acc.w, v.w, w.w, m);
}

// src[s] = row[j0 + s] where j0 + s < limit, else 0.
__device__ __forceinline__ void slot_entries(const int* __restrict__ row,
                                             int j0, int limit,
                                             int (&src)[kSlots]) {
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    src[s] = j0 + s < limit ? row[j0 + s] : 0;
  }
}

// unit[i] = c0 + (i << shift), the lane's units of a pass, clamped to the
// row's last: a unit past it is read but never stored, so that loads and
// adds need no predicate of their own beside the slot's (a thread has 7
// predicate registers).
template <int C>
__device__ __forceinline__ void units_of(int c0, int shift, int cols,
                                         int (&unit)[C]) {
#pragma unroll
  for (int i = 0; i < C; ++i) unit[i] = min(c0 + (i << shift), cols - 1);
}

// K1.  V is float or float4, cols = F / (floats in V).  A group of
// 2^shift lanes holds a node; each lane holds units c0 + (i << shift),
// i < C, of a pass over the row.
template <typename V, int C>
__global__ void __launch_bounds__(kThreads)
nei_sum_kernel(const V* __restrict__ h, const int* __restrict__ table,
               const int8_t* __restrict__ deg, V* __restrict__ out,
               int num_nodes, int k, int cols, int shift) {
  const int node = blockIdx.x * (kThreads >> shift) + (threadIdx.x >> shift);
  if (node >= num_nodes) return;
  const int* row = table + static_cast<int64_t>(node) * k;
  // round trip 1: the degree and the first slots' entries (pad ones too)
  const int8_t dn = deg[node];
  int first[kSlots];
  slot_entries(row, 0, k, first);
  const int d = min(max(static_cast<int>(dn), 0), k);
  for (int c0 = threadIdx.x & ((1 << shift) - 1); c0 < cols;
       c0 += C << shift) {
    int unit[C];
    units_of(c0, shift, cols, unit);
    V acc[C];
#pragma unroll
    for (int i = 0; i < C; ++i) acc[i] = warp_vec::zero(V());
    int src[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) src[s] = first[s];
    for (int j0 = 0; j0 < d; j0 += kSlots) {
      V v[kSlots][C];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
#pragma unroll
        for (int i = 0; i < C; ++i) {
          if (j0 + s < d) v[s][i] = h[src[s] * cols + unit[i]];
        }
      }
      slot_entries(row, j0 + kSlots, d, src);
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
#pragma unroll
        for (int i = 0; i < C; ++i) {
          if (j0 + s < d) warp_vec::add(acc[i], v[s][i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < C; ++i) {
      if (c0 + (i << shift) < cols) out[node * cols + unit[i]] = acc[i];
    }
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
nei_max_fwd_kernel(const float* __restrict__ h, const int* __restrict__ table,
                   const int8_t* __restrict__ deg, float* __restrict__ out,
                   int* __restrict__ winner, int num_nodes, int k,
                   int num_features) {
  const Row r = warp_row(table, deg, num_nodes, k);
  if (r.node < 0) return;
  const int lane = threadIdx.x & 31;
  const int64_t F = num_features;
  for (int f0 = 0; f0 < num_features; f0 += 32) {
    const int f = f0 + lane;
    const bool active = f < num_features;
    float best = active ? h[r.node * F + f] : 0.f;
    int win = r.node;
    for (int j = 0; j < r.deg; ++j) {
      const int src = __shfl_sync(kFullMask, r.slot, j);
      if (active) {
        const float c = h[src * F + f];
        if (c > best) {  // strict: self, then the lowest slot, wins a tie
          best = c;
          win = src;
        }
      }
    }
    if (active) {
      out[r.node * F + f] = best;
      winner[r.node * F + f] = win;
    }
  }
}

// K2's backward, laid out as K1.  g's and winner[t]'s loads of a slot are
// independent: both are issued before the slot's test.
template <typename V, int C>
__global__ void __launch_bounds__(kThreads)
nei_max_bwd_kernel(const V* __restrict__ g, const int* __restrict__ table,
                   const int8_t* __restrict__ deg,
                   const typename WinnerOf<V>::T* __restrict__ winner,
                   V* __restrict__ grad, int num_nodes, int k, int cols,
                   int shift) {
  using W = typename WinnerOf<V>::T;
  const int node = blockIdx.x * (kThreads >> shift) + (threadIdx.x >> shift);
  if (node >= num_nodes) return;
  const int* row = table + static_cast<int64_t>(node) * k;
  // round trip 1: the degree and the first slots' entries (pad ones too)
  const int8_t dn = deg[node];
  int first[kSlots];
  slot_entries(row, 0, k, first);
  for (int c0 = threadIdx.x & ((1 << shift) - 1); c0 < cols;
       c0 += C << shift) {
    int unit[C];
    units_of(c0, shift, cols, unit);
    W ws[C];
    V gs[C];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      ws[i] = winner[node * cols + unit[i]];
      gs[i] = g[node * cols + unit[i]];
    }
    const int d = min(max(static_cast<int>(dn), 0), k);
    V acc[C];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      acc[i] = warp_vec::zero(V());
      set_if(acc[i], gs[i], ws[i], node);
    }
    int src[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) src[s] = first[s];
    for (int j0 = 0; j0 < d; j0 += kSlots) {
      W w[kSlots][C];
      V v[kSlots][C];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
#pragma unroll
        for (int i = 0; i < C; ++i) {
          if (j0 + s < d) {
            w[s][i] = winner[src[s] * cols + unit[i]];
            v[s][i] = g[src[s] * cols + unit[i]];
          }
        }
      }
      slot_entries(row, j0 + kSlots, d, src);
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
#pragma unroll
        for (int i = 0; i < C; ++i) {
          // t = src[s] took its max from this node: t names it in a slot
          if (j0 + s < d) add_if(acc[i], v[s][i], w[s][i], node);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < C; ++i) {
      if (c0 + (i << shift) < cols) grad[node * cols + unit[i]] = acc[i];
    }
  }
}

inline int blocks_for(int num_nodes) {
  return (num_nodes + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

// The grid of K1 and K2's backward for rows of `cols` units: lanes a node
// 2^shift (the least power of two >= cols, at most 32), units a lane C.
struct Layout {
  int shift, units, blocks;
};

inline Layout layout_for(int num_nodes, int cols) {
  Layout l{0, 0, 0};
  while ((1 << l.shift) < warp_vec::lanes_per_group(cols)) ++l.shift;
  const int lanes = 1 << l.shift;
  const int units = (cols + lanes - 1) / lanes;
  l.units = units < kMaxUnits ? units : kMaxUnits;
  const int nodes = kThreads >> l.shift;
  l.blocks = (num_nodes + nodes - 1) / nodes;
  return l;
}

template <typename V>
int nei_sum_launch(const float* h, const int* table, const int8_t* deg,
                   float* out, int num_nodes, int k, int num_features,
                   cudaStream_t stream) {
  const int cols = num_features / static_cast<int>(sizeof(V) / 4);
  const Layout l = layout_for(num_nodes, cols);
  const V* hv = reinterpret_cast<const V*>(h);
  V* ov = reinterpret_cast<V*>(out);
#define NEI_SUM_CASE(C)                                                     \
  case C:                                                                   \
    nei_sum_kernel<V, C><<<l.blocks, kThreads, 0, stream>>>(                \
        hv, table, deg, ov, num_nodes, k, cols, l.shift);                   \
    break;
  switch (l.units) {
    NEI_SUM_CASE(1)
    NEI_SUM_CASE(2)
    NEI_SUM_CASE(3)
    NEI_SUM_CASE(4)
  }
#undef NEI_SUM_CASE
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int nei_max_bwd_launch(const float* g, const int* table, const int8_t* deg,
                       const int* winner, float* grad, int num_nodes, int k,
                       int num_features, cudaStream_t stream) {
  using W = typename WinnerOf<V>::T;
  const int cols = num_features / static_cast<int>(sizeof(V) / 4);
  const Layout l = layout_for(num_nodes, cols);
  const V* gv = reinterpret_cast<const V*>(g);
  const W* wv = reinterpret_cast<const W*>(winner);
  V* ov = reinterpret_cast<V*>(grad);
#define NEI_MAX_BWD_CASE(C)                                                 \
  case C:                                                                   \
    nei_max_bwd_kernel<V, C><<<l.blocks, kThreads, 0, stream>>>(            \
        gv, table, deg, wv, ov, num_nodes, k, cols, l.shift);               \
    break;
  switch (l.units) {
    NEI_MAX_BWD_CASE(1)
    NEI_MAX_BWD_CASE(2)
    NEI_MAX_BWD_CASE(3)
    NEI_MAX_BWD_CASE(4)
  }
#undef NEI_MAX_BWD_CASE
  return static_cast<int>(cudaGetLastError());
}

// float4 rows need F a multiple of 4 and 16-byte-aligned data.
inline bool vec4_ok(int num_features, const void* a, const void* b,
                    const void* c = nullptr) {
  const auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  return num_features % 4 == 0 && !misaligned(a) && !misaligned(b)
         && !misaligned(c);
}

// Launches of K1 and of K2's backward that took the float4 path.
long long float4_launches[2] = {0, 0};

}  // namespace

// counts[0] and counts[1]: the float4 launches of K1 and of K2's backward
// since the library was loaded; their other launches took one float a lane.
extern "C" void nei_table_float4_launches(long long* counts) {
  counts[0] = float4_launches[0];
  counts[1] = float4_launches[1];
}

// Each launches its kernel on `stream`; returns cudaGetLastError() as an
// int.  K1 and K2's backward take float4 rows (and int4 winners) where F is
// a multiple of 4 and every pointer 16-byte aligned, else one float a unit.
extern "C" int nei_sum_f32(const float* h, const int* table,
                           const int8_t* deg, float* out, int num_nodes,
                           int k, int num_features, cudaStream_t stream) {
  if (vec4_ok(num_features, h, out)) {
    ++float4_launches[0];
    return nei_sum_launch<float4>(h, table, deg, out, num_nodes, k,
                                  num_features, stream);
  }
  return nei_sum_launch<float>(h, table, deg, out, num_nodes, k,
                               num_features, stream);
}

extern "C" int nei_max_fwd_f32(const float* h, const int* table,
                               const int8_t* deg, float* out, int* winner,
                               int num_nodes, int k, int num_features,
                               cudaStream_t stream) {
  nei_max_fwd_kernel<<<blocks_for(num_nodes), kWarpsPerBlock * 32, 0,
                       stream>>>(h, table, deg, out, winner, num_nodes, k,
                                 num_features);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nei_max_bwd_f32(const float* g, const int* table,
                               const int8_t* deg, const int* winner,
                               float* grad, int num_nodes, int k,
                               int num_features, cudaStream_t stream) {
  if (vec4_ok(num_features, g, grad, winner)) {
    ++float4_launches[1];
    return nei_max_bwd_launch<float4>(g, table, deg, winner, grad,
                                      num_nodes, k, num_features, stream);
  }
  return nei_max_bwd_launch<float>(g, table, deg, winner, grad, num_nodes, k,
                                   num_features, stream);
}
