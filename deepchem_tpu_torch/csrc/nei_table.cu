// Neighbour-table aggregations of GraphConv: the masked sum (K1) and the
// max over a node and its neighbours with its winner and backward (K2).
//
// Replace the custom-VJP XLA ops of deepchem_tpu/ops/nei_table.py, which the
// JAX package computes as slot-by-slot gathers, with no Pallas kernel:
//   K1  _slot_sum / nei_sum (:75-100):
//         out[i] = sum over every slot j < K of h[table[i, j]] * real(j), in
//         ascending j, real(j) = 1 for j < deg[i] and 0 for a pad slot.
//       A pad slot's row is read and added times 0: it adds a signed zero,
//       or NaN where the row is not finite, as the JAX op's mask does.
//       Its backward is the same sum of the cotangent: an undirected
//       molecular graph's table is its own transpose.
//       The rows h may have another count R than the table's N: a table
//       over edge ids sums edge rows [E, F] into nodes [N, F], as MPNN's
//       nei_sum_edges (:213-240) does forward and take_src (:242-263)
//       backward, each through its own table (incoming edges, outgoing).
//   K2  nei_max_incl_self (:103-149), forward: best = h[i], winner = i;
//         for every slot j in ascending order the candidate h[table[i, j]]
//         (a real slot) or NEG (a pad slot) takes it where it is strictly
//         greater, with winner table[i, j].  So self wins a tie, then the
//         lowest slot, a NaN never takes the max, and a node whose values
//         lie below NEG takes NEG from its first pad slot (later pad slots
//         cannot beat it).
//       backward: grad[m] = g[m] [winner[m] == m]
//                   + sum over j < deg[m] of g[t] [winner[t] == m],
//         t = table[m, j], added in that order.
// So K1 reads the rows of pad slots (the port's packer points them all at
// row 0, which stays in L1), K2's forward reads the entry of the first pad
// slot but not its row, and K2's backward neither.
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
// All three kernels share one design (K1 and K2's backward since the
// first redesign, K2's forward since the second).  The first design, one
// warp a node, a shuffle to broadcast each slot's index and one 4-byte
// load after another, slot after slot, held them back.  Now:
// - Two round trips, not a chain.  A lane reads deg[i] and the table
//   entries of the first kSlots slots together (the table is a dense
//   [N, K] allocation; K1 also reads entry kSlots, K2's forward the
//   node's own row, K2's backward its own winner and g), then issues the
//   rows of every real slot of the group (K2's backward: both winner[t]
//   and g[t]; K1: also the first pad slot's row) before the first add or
//   compare, and reads the next group's entries while they are in flight.
//   Slots go kSlots a group, unrolled and predicated on j < deg: one group
//   covers a Tox21 atom.
// - Each lane owns all its features: a group of 2^shift lanes holds a
//   node and each lane up to kMaxUnits units of the row (one pass over the
//   slots unless the row has more than 32 * kMaxUnits units).  With F a
//   multiple of 4 and 16-byte-aligned rows a unit is a float4 (and an
//   int4 of winners): F = 64 is 16 lanes, two nodes a warp.  Otherwise a
//   unit is one float: F = 75 is 32 lanes holding features lane, lane +
//   32 and lane + 64.  Each C entry picks the path itself and counts its
//   float4 launches (nei_table_float4_launches); float4 wins at
//   GraphConv's [5120, 64], one float at 1000 nodes or F = 4 to 32, so
//   both stay.  K2's forward compares element by element (never a vector
//   fmaxf, which drops NaN and the winner).
// - K1's pad slots: the first one's row (row 0 from the port's packer) is
//   read beside the real rows and added times 0 after them; the node's
//   lanes check the other pad entries together (one ballot), and a pad
//   row other than the first is added in a loop that the port's tables
//   never enter.  At GraphConv's F = 75 this costs 0.6 us a launch over
//   the real slots alone; adding every pad row in the slot loop cost 2.4,
//   and checking the pad entries one after another 1.2
//   (scripts/bench_nei_table.py, H100 80GB HBM3 at 700 W).
// - The JAX op's bits, signed zeros included.  K1's sums start from -0.f,
//   which leaves the first term as it is (-0 + a == a bit for bit for
//   every a, +0 and NaN included), as the JAX sum starts from its first
//   slot's term; then come the real slots in slot order and the pad terms,
//   each +-0 or NaN, whose order cannot change the result.  K2's backward
//   assigns the self term and adds a slot's term only where it hits (`if
//   (w == m) acc += g`); the JAX sum adds +0.0 for each of its K + 1 terms
//   that is not taken, which turns a -0 into +0 and leaves every other
//   value's bits as they are.  So the kernel adds one +0 unless the self
//   term and every one of the K slots were taken: it adds it wherever deg
//   < K (a pad slot is never taken), and where deg == K to a -0 alone
//   after reading the neighbours' winners again to tell (rare: every term
//   it took was -0).
//   The max copies the winning value.  Each output element has one
//   writer; no atomics.
//
// Inputs: h (or g) [N, F] float32 row-major (K1: [R, F], R >= 1), table
// [N, K] int32, deg [N] int8, K <= 32.  deg is clamped to [0, K]; every
// table entry, pad slots' included, must lie in [0, N) (K1: [0, R)).

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_vec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kNeg = -9e15f;  // the masking value of ops/segment.py
constexpr int kSlots = 4;     // slots whose row loads are issued together
constexpr int kMaxUnits = 4;  // units of a row a lane holds in one pass

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

// -0.f, per element: where K1's sums start.
__device__ __forceinline__ float neg_zero(float) { return -0.f; }
__device__ __forceinline__ float4 neg_zero(float4) {
  return make_float4(-0.f, -0.f, -0.f, -0.f);
}

// miss |= (w != m), per element.
__device__ __forceinline__ void note_miss(int& miss, int w, int m) {
  miss |= w != m;
}
__device__ __forceinline__ void note_miss(int4& miss, int4 w, int m) {
  note_miss(miss.x, w.x, m);
  note_miss(miss.y, w.y, m);
  note_miss(miss.z, w.z, m);
  note_miss(miss.w, w.w, m);
}
// acc += +0 where miss is set, per element: -0 becomes +0, nothing else
// changes.
__device__ __forceinline__ void add_zero_where(float& acc, int miss) {
  if (miss) acc += 0.f;
}
__device__ __forceinline__ void add_zero_where(float4& acc, int4 miss) {
  add_zero_where(acc.x, miss.x);
  add_zero_where(acc.y, miss.y);
  add_zero_where(acc.z, miss.z);
  add_zero_where(acc.w, miss.w);
}

// Whether an element is -0.
__device__ __forceinline__ bool has_neg_zero(float a) {
  return __float_as_uint(a) == 0x80000000u;
}
__device__ __forceinline__ bool has_neg_zero(float4 a) {
  return has_neg_zero(a.x) || has_neg_zero(a.y) || has_neg_zero(a.z)
         || has_neg_zero(a.w);
}

// acc += v * 0, per element: a pad slot's term, +-0 or NaN.
__device__ __forceinline__ void add_times_zero(float& acc, float v) {
  acc += v * 0.f;
}
__device__ __forceinline__ void add_times_zero(float4& acc, float4 v) {
  add_times_zero(acc.x, v.x);
  add_times_zero(acc.y, v.y);
  add_times_zero(acc.z, v.z);
  add_times_zero(acc.w, v.w);
}

__device__ __forceinline__ int splat(int, int v) { return v; }
__device__ __forceinline__ int4 splat(int4, int v) {
  return make_int4(v, v, v, v);
}
__device__ __forceinline__ float splat(float, float v) { return v; }
__device__ __forceinline__ float4 splat(float4, float v) {
  return make_float4(v, v, v, v);
}

// best, win = c, src where c > best (strict), per element: a NaN never
// takes the max, and a NaN best keeps it.
__device__ __forceinline__ void take_if_greater(float& best, int& win,
                                                float c, int src) {
  if (c > best) {
    best = c;
    win = src;
  }
}
__device__ __forceinline__ void take_if_greater(float4& best, int4& win,
                                                float4 c, int src) {
  take_if_greater(best.x, win.x, c.x, src);
  take_if_greater(best.y, win.y, c.y, src);
  take_if_greater(best.z, win.z, c.z, src);
  take_if_greater(best.w, win.w, c.w, src);
}

// Whether p holds on any lane of this lane's group of 2^shift lanes (the
// groups of a warp run in step; a group past the last node has returned).
__device__ __forceinline__ bool group_any(bool p, int shift) {
  const unsigned votes = __ballot_sync(__activemask(), p);
  const int lanes = 1 << shift;
  const int base = (threadIdx.x & 31) & ~(lanes - 1);
  const unsigned mine =
      lanes == 32 ? 0xffffffffu : ((1u << lanes) - 1) << base;
  return (votes & mine) != 0;
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
  const int lanes = 1 << shift;
  const int lane = threadIdx.x & (lanes - 1);
  // round trip 1: the degree and the first slots' entries (pad ones too)
  const int8_t dn = deg[node];
  int first[kSlots];
  slot_entries(row, 0, k, first);
  const int d = min(max(static_cast<int>(dn), 0), k);
  // The pad slots add their rows times 0 after the real ones: +-0 or NaN,
  // whose order cannot change the sum.  So
  // the first pad slot's row is added (loaded beside the real rows), then
  // each other row that a pad slot names, once.  Its entry t0 is among the
  // first kSlots + 1 read in round trip 1 unless deg > kSlots.  The port's
  // packer points every pad slot at row 0; the node's lanes split the
  // check of the other pad slots for another row (other).
  const int fifth = kSlots < k ? row[kSlots] : 0;
  int t0 = fifth;
#pragma unroll
  for (int s = kSlots - 1; s >= 0; --s) t0 = d == s ? first[s] : t0;
  if (d > kSlots) t0 = row[min(d, k - 1)];
  const int j1 = d + 1 + lane;
  bool other = (j1 < k ? row[j1] : t0) != t0;
  for (int j = j1 + lanes; j < k; j += lanes) other |= row[j] != t0;
  for (int c0 = lane; c0 < cols; c0 += C << shift) {
    int unit[C];
    units_of(c0, shift, cols, unit);
    V pad[C], acc[C];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      pad[i] = h[t0 * cols + unit[i]];
      acc[i] = neg_zero(V());
    }
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
    if (d < k) {
#pragma unroll
      for (int i = 0; i < C; ++i) add_times_zero(acc[i], pad[i]);
    }
    if (group_any(other, shift)) {
      for (int j = d + 1; j < k; ++j) {
        const int t = row[j];
        if (t != t0) {
#pragma unroll
          for (int i = 0; i < C; ++i) {
            add_times_zero(acc[i], h[t * cols + unit[i]]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < C; ++i) {
      if (c0 + (i << shift) < cols) out[node * cols + unit[i]] = acc[i];
    }
  }
}

// K2's forward, laid out as K1.  Round trip 1 also reads the node's own
// row; then the rows of a group's real slots are issued before its first
// compare.  The walk ends after the first pad slot (slot deg, where deg <
// K), which offers NEG and its entry without a load.
template <typename V, int C>
__global__ void __launch_bounds__(kThreads)
nei_max_fwd_kernel(const V* __restrict__ h, const int* __restrict__ table,
                   const int8_t* __restrict__ deg, V* __restrict__ out,
                   typename WinnerOf<V>::T* __restrict__ winner,
                   int num_nodes, int k, int cols, int shift) {
  using W = typename WinnerOf<V>::T;
  const int node = blockIdx.x * (kThreads >> shift) + (threadIdx.x >> shift);
  if (node >= num_nodes) return;
  const int* row = table + static_cast<int64_t>(node) * k;
  // round trip 1: the degree, the first slots' entries and the own row
  const int8_t dn = deg[node];
  int first[kSlots];
  slot_entries(row, 0, k, first);
  for (int c0 = threadIdx.x & ((1 << shift) - 1); c0 < cols;
       c0 += C << shift) {
    int unit[C];
    units_of(c0, shift, cols, unit);
    V best[C];
    W win[C];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      best[i] = h[node * cols + unit[i]];
      win[i] = splat(W(), node);
    }
    const int d = min(max(static_cast<int>(dn), 0), k);
    const int last = min(d + 1, k);  // the real slots and the first pad one
    int src[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) src[s] = first[s];
    for (int j0 = 0; j0 < last; j0 += kSlots) {
      V v[kSlots][C];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
#pragma unroll
        for (int i = 0; i < C; ++i) {
          if (j0 + s < d) v[s][i] = h[src[s] * cols + unit[i]];
        }
      }
      int next[kSlots];
      slot_entries(row, j0 + kSlots, last, next);
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
#pragma unroll
        for (int i = 0; i < C; ++i) {
          if (j0 + s < d) {
            take_if_greater(best[i], win[i], v[s][i], src[s]);
          } else if (j0 + s < last) {  // the first pad slot: NEG
            take_if_greater(best[i], win[i], splat(V(), kNeg), src[s]);
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kSlots; ++s) src[s] = next[s];
    }
#pragma unroll
    for (int i = 0; i < C; ++i) {
      if (c0 + (i << shift) < cols) {
        out[node * cols + unit[i]] = best[i];
        winner[node * cols + unit[i]] = win[i];
      }
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
    // JAX adds +0.0 for each term not taken: a pad slot never is, and
    // where every slot is real only a -0 can tell
#pragma unroll
    for (int i = 0; i < C; ++i) {
      if (d < k) {
        warp_vec::add(acc[i], warp_vec::zero(V()));
      } else if (has_neg_zero(acc[i])) {
        W miss = splat(W(), 0);
        note_miss(miss, ws[i], node);
        for (int j = 0; j < k; ++j) {
          note_miss(miss, winner[row[j] * cols + unit[i]], node);
        }
        add_zero_where(acc[i], miss);
      }
    }
#pragma unroll
    for (int i = 0; i < C; ++i) {
      if (c0 + (i << shift) < cols) grad[node * cols + unit[i]] = acc[i];
    }
  }
}

// The grid of K1 and K2 for rows of `cols` units: lanes a node
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
int nei_max_fwd_launch(const float* h, const int* table, const int8_t* deg,
                       float* out, int* winner, int num_nodes, int k,
                       int num_features, cudaStream_t stream) {
  using W = typename WinnerOf<V>::T;
  const int cols = num_features / static_cast<int>(sizeof(V) / 4);
  const Layout l = layout_for(num_nodes, cols);
  const V* hv = reinterpret_cast<const V*>(h);
  V* ov = reinterpret_cast<V*>(out);
  W* wv = reinterpret_cast<W*>(winner);
#define NEI_MAX_FWD_CASE(C)                                                 \
  case C:                                                                   \
    nei_max_fwd_kernel<V, C><<<l.blocks, kThreads, 0, stream>>>(            \
        hv, table, deg, ov, wv, num_nodes, k, cols, l.shift);               \
    break;
  switch (l.units) {
    NEI_MAX_FWD_CASE(1)
    NEI_MAX_FWD_CASE(2)
    NEI_MAX_FWD_CASE(3)
    NEI_MAX_FWD_CASE(4)
  }
#undef NEI_MAX_FWD_CASE
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

// Launches of K1, of K2's backward and of K2's forward that took the
// float4 path.
long long float4_launches[3] = {0, 0, 0};

}  // namespace

// counts[0], counts[1] and counts[2]: the float4 launches of K1, of K2's
// backward and of K2's forward since the library was loaded; their other
// launches took one float a lane.
extern "C" void nei_table_float4_launches(long long* counts) {
  for (int i = 0; i < 3; ++i) counts[i] = float4_launches[i];
}

// Each launches its kernel on `stream`; returns cudaGetLastError() as an
// int.  Each takes float4 rows (and int4 winners) where F is a multiple of
// 4 and every pointer 16-byte aligned, else one float a unit.
// nei_sum_f32 sums rows of h [num_rows, F] into out [num_nodes, F]; it
// refuses (cudaErrorInvalidValue) a source with no row, which a pad slot
// would read, and one whose elements int32 cannot index.
extern "C" int nei_sum_f32(const float* h, const int* table,
                           const int8_t* deg, float* out, int num_rows,
                           int num_nodes, int k, int num_features,
                           cudaStream_t stream) {
  if (num_rows < 1
      || static_cast<int64_t>(num_rows) * num_features >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  if (vec4_ok(num_features, h, out, winner)) {
    ++float4_launches[2];
    return nei_max_fwd_launch<float4>(h, table, deg, out, winner, num_nodes,
                                      k, num_features, stream);
  }
  return nei_max_fwd_launch<float>(h, table, deg, out, winner, num_nodes, k,
                                   num_features, stream);
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
