// Max readout over each graph's rows, forward and backward (K3).
//
// Replaces the custom-VJP XLA op deepchem_tpu/ops/segment.py
// segment_max_sumgrad as graph_pool(..., 'max') calls it (:173-236; the
// JAX package has no Pallas kernel for it).  Rows are graph-contiguous:
// graph b owns rows [row_ptr[b], row_ptr[b+1]), and rows past row_ptr[G]
// (the ghost slot) belong to no graph.  Per graph b and feature f, over the
// rows r of b whose mask is set (every row when there is no mask):
//   mx  = max x[r, f], NaN if one is NaN; 0 where that is not finite or
//         not above NEG / 2 (no valid row, or values as low as the masking
//         value)
//   sel = valid and x[r, f] >= mx
//   den = number of selected rows
//   num = sum over EVERY row r of b, masked ones included, of x[r, f] *
//         sel, in row order, so a non-finite row that is not selected
//         makes it NaN
//   out = num / den; 0 where den == 0
// so tied maxima share the result and an empty graph gives 0.  Backward,
// as the JAX op's stop_gradients make it (mx and den carry none):
//   dx[r, f] = t * sel on every row r of b, masked ones included, with
//   t = g[b, f] / den where den > 0 and 0 where den == 0,
// and 0 on the ghost rows.  An infinite or NaN t makes the rows that are
// not selected NaN, as in the JAX gradient.
//
// Bound on this card: memory bytes.  GraphConv's main path hands it
// x [5120, 128] f32 (about 4.6k real rows) and 256 graphs of 9 to 33 rows:
// the forward reads x once (2.4 MB of real rows) and writes out, mx and
// den (3 x 131 KB); the backward reads x, g, mx, den and writes dx: 2.6 to
// 2.9 MB, about 0.8 us at 3.35 TB/s.  At that size the launch, two
// dependent memory round trips (row_ptr, then the rows) and the
// instructions of the fold and the merge set the time.
//
// Forward design.  One block of 8 warps per real graph (no block for the
// ghost slot).  Lanes run across the features: a row group of 2^shift
// lanes (the least power of two >= the row's units, at most 32) covers a
// row, each lane up to kMaxUnits units, where a unit is a float4 when F is
// a multiple of 4 and x 16-byte aligned, else one float (the C entry picks
// and counts the path).  F = 128 is a float4 a lane, a warp a row; F = 75
// is 3 floats a lane.  The block's 256 >> shift row groups split the
// graph's rows into contiguous chunks in row order; a group issues the
// mask and x loads of up to R rows of its chunk at once, then folds them
// in row order, without a branch, into statistics per element: the strict
// running max (a masked row competing as -inf), how many rows equal it,
// and whether every row, valid or masked, was finite.  The chunks merge in
// group order through shared memory, one thread an element, with the same
// strict rule, so the merge equals one scan of the graph and keeps the
// first of tied values in row order (-0 and +0 keep their sign).  Then:
//   - every row finite and mx above NEG / 2: den = cnt and num is the sum
//     of cnt copies of mx from 0.f, added one by one as the row-order sum
//     adds them (each selected value equals mx, and the unselected rows
//     add +-0, which leaves it as it was);
//   - every row finite and no valid row above NEG / 2: mx = den = out = 0;
//   - a row not finite: the thread reads the element's rows again, one
//     after another, and takes every statistic from them (exact_element).
// On finite inputs above NEG this gives the bits of the first design (one
// thread a feature walking the rows twice, a mask load and a branch before
// each row).  At GraphConv's [5120, 128] with 256 graphs that is 256
// blocks of 256 threads: every one of the card's 132 SMs takes one or two,
// where a warp a graph in blocks of 8 warps (32 blocks) would have left
// 100 SMs idle.  Blocks of 4 warps, or 8 rows in flight a group, were
// slower there (scripts/bench_nei_table.py, H100 80GB HBM3 at 700 W).
//
// Backward design, on the forward's layout: one block of 8 warps per real
// graph, a row group of 2^shift lanes a row, C units a lane, a unit a
// float4 where F is a multiple of 4 and g, x, mx, den and dx are all
// 16-byte aligned, else one float (the C entry picks and counts the path).
// Two round trips: a group loads the bounds and its units' g, den and mx
// together, then issues the mask and x loads of R rows of its contiguous
// chunk at once, forms t = g / den while they are in flight, recomputes
// sel from them and stores dx = t * sel, a unit at a time.  Each element
// is that one product, so any layout gives the same bits.  kTailBlocks
// blocks after the G graph blocks write the zeros of the ghost rows, a
// unit a thread, striding over them.  (The first design, one block a
// graph of one thread a feature walking the rows one after another, a
// mask load and a compare before each store, and the ghost rows' zeros a
// float at a time from a block per 32 rows, took 3.78 us at GraphConv's
// [5120, 128] with 256 graphs; scripts/bench_nei_table.py, H100 80GB HBM3
// at 700 W.)
//
// Inputs: x [N, F] float32 row-major, row_ptr [G+1] int32 non-decreasing
// with row_ptr[0] == 0 (clamped to [0, N]), mask [N] float32 or null.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_vec.cuh"

namespace {

constexpr float kNeg = -9e15f;  // the masking value of ops/segment.py
constexpr int kPoolThreads = 256;  // a block: 8 warps a graph
constexpr int kMaxUnits = 4;       // units of a row a lane holds in a pass
constexpr int kTailBlocks = 16;    // backward blocks that zero the ghost rows

__device__ __forceinline__ bool valid(const float* __restrict__ mask,
                                      int64_t r) {
  return mask == nullptr || mask[r] > 0.f;
}

__device__ __forceinline__ void bounds(const int* __restrict__ row_ptr,
                                       int b, int num_rows, int* start,
                                       int* end) {
  *start = min(max(row_ptr[b], 0), num_rows);
  *end = max(min(max(row_ptr[b + 1], 0), num_rows), *start);
}

template <typename V> struct Width { static constexpr int n = 1; };
template <> struct Width<float4> { static constexpr int n = 4; };

__device__ __forceinline__ float elem(float v, int) { return v; }
__device__ __forceinline__ float elem(float4 v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// One element's running statistics over rows folded in row order.
struct Stats {
  float mx;     // strict running max of the valid rows, -inf before any
  int cnt;      // rows equal to mx (masked ones while mx is -inf)
  bool finite;  // every row so far finite, valid or not
};

// Folds row value v (valid where ok) into a, without a branch: lanes of a
// warp hold different features, whose compares go different ways.  A
// masked row competes as -inf, which only counts while nothing valid has
// been seen.
__device__ __forceinline__ void fold(Stats& a, float v, bool ok) {
  const float c = ok ? v : -INFINITY;
  const bool gt = c > a.mx;
  a.cnt = gt ? 1 : a.cnt + (c == a.mx);
  a.mx = gt ? c : a.mx;
  a.finite = a.finite && fabsf(v) <= 3.402823466e38f;
}

// out, mx and den of element f of graph b where a row is not finite:
// every statistic again from the rows, one after another.
__device__ __forceinline__ void exact_element(const float* __restrict__ x,
                              const float* __restrict__ mask, int start,
                              int end, int64_t f, int64_t F, float* out,
                              float* mx_out, float* den_out) {
  float mx = -INFINITY;
  int cnt = 0, pos = 0;
  bool nan = false, bad = false;  // a valid NaN; a non-finite row not taken
  for (int r = start; r < end; ++r) {
    const float v = x[r * F + f];
    if (valid(mask, r)) {
      if (v > mx) {
        mx = v;
        cnt = 1;
      } else if (v == mx) {
        ++cnt;
      }
      pos += v >= 0.f;
      nan = nan || v != v;
      bad = bad || v == -INFINITY;
    } else {
      bad = bad || !isfinite(v);
    }
  }
  float num = 0.f, den = 0.f;
  if (nan || mx == INFINITY) {  // mx resets to 0: the rows >= 0 are taken
    den = static_cast<float>(pos);
    num = nan || bad ? NAN : INFINITY;
    mx = 0.f;
  } else if (mx > 0.5f * kNeg) {
    den = static_cast<float>(cnt);
    for (int q = 0; q < cnt; ++q) num += mx;
    if (bad) num = NAN;
  } else {
    mx = 0.f;
  }
  *out = den > 0.f ? num / fmaxf(den, 1.f) : 0.f;
  *mx_out = mx;
  *den_out = den;
}

// K3's forward.  V is float or float4, cols = F / (floats in V), a row
// group of 2^shift lanes a row, C units a lane, R rows issued at once.
template <typename V, int C, int R>
__global__ void __launch_bounds__(kPoolThreads)
graph_max_pool_fwd_kernel(const V* __restrict__ x,
                          const int* __restrict__ row_ptr,
                          const float* __restrict__ mask,
                          float* __restrict__ out, float* __restrict__ mx_out,
                          float* __restrict__ den_out, int num_rows,
                          int cols, int shift) {
  constexpr int kW = Width<V>::n;
  constexpr int kElems = kPoolThreads * C * kW;  // group x element of a pass
  constexpr int kNonFinite = 1 << 31;            // flag beside s_cnt's count
  __shared__ float s_mx[kElems];
  __shared__ int s_cnt[kElems];
  const int b = blockIdx.x;
  int start, end;
  bounds(row_ptr, b, num_rows, &start, &end);
  const int groups = kPoolThreads >> shift;
  const int group = threadIdx.x >> shift;
  const int lane = threadIdx.x & ((1 << shift) - 1);
  const int per = (end - start + groups - 1) / groups;
  const int r0 = min(start + group * per, end);
  const int r1 = min(r0 + per, end);
  const int pass_units = C << shift;
  const int pass_elems = pass_units * kW;
  const int F = cols * kW;
  for (int c0 = 0; c0 < cols; c0 += pass_units) {
    int unit[C];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      unit[i] = min(c0 + lane + (i << shift), cols - 1);
    }
    Stats st[C][kW];
#pragma unroll
    for (int i = 0; i < C; ++i) {
#pragma unroll
      for (int e = 0; e < kW; ++e) st[i][e] = Stats{-INFINITY, 0, true};
    }
    for (int r = r0; r < r1; r += R) {
      float m[R];
      V v[R][C];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if (r + q < r1) {
          m[q] = mask == nullptr ? 1.f : mask[r + q];
#pragma unroll
          for (int i = 0; i < C; ++i) v[q][i] = x[(r + q) * cols + unit[i]];
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if (r + q < r1) {
#pragma unroll
          for (int i = 0; i < C; ++i) {
#pragma unroll
            for (int e = 0; e < kW; ++e) {
              fold(st[i][e], elem(v[q][i], e), m[q] > 0.f);
            }
          }
        }
      }
    }
    // this group's statistics, by element of the pass
#pragma unroll
    for (int i = 0; i < C; ++i) {
#pragma unroll
      for (int e = 0; e < kW; ++e) {
        const int k = group * pass_elems + (lane + (i << shift)) * kW + e;
        s_mx[k] = st[i][e].mx;
        s_cnt[k] = st[i][e].cnt | (st[i][e].finite ? 0 : kNonFinite);
      }
    }
    __syncthreads();
    // merge the groups in row order, one thread an element
    for (int el = threadIdx.x; el < pass_elems; el += kPoolThreads) {
      const int f = c0 * kW + el;
      if (f >= F) break;
      float mx = -INFINITY;
      int cnt = 0, flags = 0;
      for (int g = 0; g < groups; ++g) {
        const int k = g * pass_elems + el;
        const float gm = s_mx[k];
        const int gc = s_cnt[k] & ~kNonFinite;
        cnt = gm > mx ? gc : cnt + (gm == mx ? gc : 0);
        mx = gm > mx ? gm : mx;
        flags |= s_cnt[k];
      }
      if (flags & kNonFinite) {
        exact_element(reinterpret_cast<const float*>(x), mask, start, end,
                      f, F, out + b * F + f, mx_out + b * F + f,
                      den_out + b * F + f);
        continue;
      }
      float num = 0.f, den = 0.f;
      if (mx > 0.5f * kNeg) {
        den = static_cast<float>(cnt);
        for (int q = 0; q < cnt; ++q) num += mx;
      } else {
        mx = 0.f;
      }
      out[b * F + f] = den > 0.f ? num / fmaxf(den, 1.f) : 0.f;
      mx_out[b * F + f] = mx;
      den_out[b * F + f] = den;
    }
    __syncthreads();
  }
}

// t = g / den where den > 0, else 0, per element.
__device__ __forceinline__ float share(float g, float den) {
  return den > 0.f ? g / fmaxf(den, 1.f) : 0.f;
}
__device__ __forceinline__ float4 share(float4 g, float4 den) {
  return make_float4(share(g.x, den.x), share(g.y, den.y),
                     share(g.z, den.z), share(g.w, den.w));
}

// t * sel, sel = 1 where the row is valid and v >= mx, else 0, per element.
__device__ __forceinline__ float grad_of(float t, float v, float mx,
                                         bool ok) {
  return t * (ok && v >= mx ? 1.f : 0.f);
}
__device__ __forceinline__ float4 grad_of(float4 t, float4 v, float4 mx,
                                          bool ok) {
  return make_float4(grad_of(t.x, v.x, mx.x, ok), grad_of(t.y, v.y, mx.y, ok),
                     grad_of(t.z, v.z, mx.z, ok),
                     grad_of(t.w, v.w, mx.w, ok));
}

// K3's backward, laid out as its forward: V is float or float4, cols = F /
// (floats in V), a row group of 2^shift lanes a row, C units a lane, R rows
// issued at once.
template <typename V, int C, int R>
__global__ void __launch_bounds__(kPoolThreads)
graph_max_pool_bwd_kernel(const V* __restrict__ g, const V* __restrict__ x,
                          const int* __restrict__ row_ptr,
                          const float* __restrict__ mask,
                          const V* __restrict__ mx_in,
                          const V* __restrict__ den_in, V* __restrict__ dx,
                          int num_graphs, int num_rows, int cols,
                          int shift) {
  const int b = blockIdx.x;
  if (b >= num_graphs) {  // the ghost rows past row_ptr[G]: zeros
    const int ghost = min(max(row_ptr[num_graphs], 0), num_rows);
    const int units = (num_rows - ghost) * cols;
    V* tail = dx + static_cast<int64_t>(ghost) * cols;
    for (int u = (b - num_graphs) * kPoolThreads + threadIdx.x; u < units;
         u += kTailBlocks * kPoolThreads) {
      tail[u] = warp_vec::zero(V());
    }
    return;
  }
  const int lane = threadIdx.x & ((1 << shift) - 1);
  int unit[C];
  V gv[C], dv[C], mx[C];
  // round trip 1: the bounds, and the first pass's g, den and mx, which
  // do not depend on them
  const int rp0 = row_ptr[b], rp1 = row_ptr[b + 1];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    unit[i] = min(lane + (i << shift), cols - 1);
    gv[i] = g[b * cols + unit[i]];
    dv[i] = den_in[b * cols + unit[i]];
    mx[i] = mx_in[b * cols + unit[i]];
  }
  const int start = min(max(rp0, 0), num_rows);
  const int end = max(min(max(rp1, 0), num_rows), start);
  const int groups = kPoolThreads >> shift;
  const int per = (end - start + groups - 1) / groups;
  const int r0 = min(start + (static_cast<int>(threadIdx.x) >> shift) * per,
                     end);
  const int r1 = min(r0 + per, end);
  for (int c0 = 0; c0 < cols; c0 += C << shift) {
    if (c0 > 0) {
#pragma unroll
      for (int i = 0; i < C; ++i) {
        unit[i] = min(c0 + lane + (i << shift), cols - 1);
        gv[i] = g[b * cols + unit[i]];
        dv[i] = den_in[b * cols + unit[i]];
        mx[i] = mx_in[b * cols + unit[i]];
      }
    }
    V t[C];
    for (int r = r0; r < r1; r += R) {
      // round trip 2: the mask and x of R rows
      float m[R];
      V v[R][C];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if (r + q < r1) {
          m[q] = mask == nullptr ? 1.f : mask[r + q];
#pragma unroll
          for (int i = 0; i < C; ++i) v[q][i] = x[(r + q) * cols + unit[i]];
        }
      }
      if (r == r0) {  // while the rows are in flight
#pragma unroll
        for (int i = 0; i < C; ++i) t[i] = share(gv[i], dv[i]);
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
#pragma unroll
        for (int i = 0; i < C; ++i) {
          if (r + q < r1 && c0 + lane + (i << shift) < cols) {
            dx[(r + q) * cols + unit[i]] =
                grad_of(t[i], v[q][i], mx[i], m[q] > 0.f);
          }
        }
      }
    }
  }
}

// The row group of K3's kernels for rows of `cols` units: 2^shift lanes
// (the least power of two >= cols, at most 32), `units` units a lane.
inline void row_group(int cols, int* shift, int* units) {
  *shift = 0;
  while ((1 << *shift) < cols && *shift < 5) ++*shift;
  const int lanes = 1 << *shift;
  const int u = (cols + lanes - 1) / lanes;
  *units = u < kMaxUnits ? u : kMaxUnits;
}

template <typename V>
int graph_max_pool_fwd_launch(const float* x, const int* row_ptr,
                              const float* mask, float* out, float* mx,
                              float* den, int num_graphs, int num_rows,
                              int num_features, cudaStream_t stream) {
  const int cols = num_features / static_cast<int>(sizeof(V) / 4);
  int shift, units;
  row_group(cols, &shift, &units);
  const V* xv = reinterpret_cast<const V*>(x);
#define GRAPH_MAX_FWD_CASE(C, R)                                            \
  case C:                                                                   \
    graph_max_pool_fwd_kernel<V, C, R><<<num_graphs, kPoolThreads, 0,       \
                                         stream>>>(                         \
        xv, row_ptr, mask, out, mx, den, num_rows, cols, shift);            \
    break;
  switch (units) {
    GRAPH_MAX_FWD_CASE(1, 4)
    GRAPH_MAX_FWD_CASE(2, 4)
    GRAPH_MAX_FWD_CASE(3, 4)
    GRAPH_MAX_FWD_CASE(4, 2)
  }
#undef GRAPH_MAX_FWD_CASE
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int graph_max_pool_bwd_launch(const float* g, const float* x,
                              const int* row_ptr, const float* mask,
                              const float* mx, const float* den, float* dx,
                              int num_graphs, int num_rows, int num_features,
                              cudaStream_t stream) {
  const int cols = num_features / static_cast<int>(sizeof(V) / 4);
  int shift, units;
  row_group(cols, &shift, &units);
  const V* gv = reinterpret_cast<const V*>(g);
  const V* xv = reinterpret_cast<const V*>(x);
  const V* mxv = reinterpret_cast<const V*>(mx);
  const V* denv = reinterpret_cast<const V*>(den);
  V* dxv = reinterpret_cast<V*>(dx);
#define GRAPH_MAX_BWD_CASE(C, R)                                            \
  case C:                                                                   \
    graph_max_pool_bwd_kernel<V, C, R><<<num_graphs + kTailBlocks,          \
                                         kPoolThreads, 0, stream>>>(        \
        gv, xv, row_ptr, mask, mxv, denv, dxv, num_graphs, num_rows, cols,  \
        shift);                                                             \
    break;
  switch (units) {
    GRAPH_MAX_BWD_CASE(1, 4)
    GRAPH_MAX_BWD_CASE(2, 4)
    GRAPH_MAX_BWD_CASE(3, 4)
    GRAPH_MAX_BWD_CASE(4, 4)
  }
#undef GRAPH_MAX_BWD_CASE
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Launches of the forward and of the backward that took the float4 path.
long long float4_launches[2] = {0, 0};

}  // namespace

// counts[0] and counts[1]: the forward's and the backward's float4
// launches since the library was loaded; their other launches took one
// float a unit.
extern "C" void graph_pool_float4_launches(long long* counts) {
  for (int i = 0; i < 2; ++i) counts[i] = float4_launches[i];
}

// Each launches its kernel on `stream`; returns cudaGetLastError() as an
// int.  The forward reads x as float4 rows where F is a multiple of 4 and
// x is 16-byte aligned, else one float a unit; it writes out, mx and den a
// float a thread, so their alignment does not matter.  The backward takes
// float4 units where F is a multiple of 4 and g, x, mx, den and dx are all
// 16-byte aligned, else one float a unit.
extern "C" int graph_max_pool_fwd_f32(const float* x, const int* row_ptr,
                                      const float* mask, float* out,
                                      float* mx, float* den, int num_graphs,
                                      int num_rows, int num_features,
                                      cudaStream_t stream) {
  if (num_features % 4 == 0 && aligned16(x)) {
    ++float4_launches[0];
    return graph_max_pool_fwd_launch<float4>(x, row_ptr, mask, out, mx, den,
                                             num_graphs, num_rows,
                                             num_features, stream);
  }
  return graph_max_pool_fwd_launch<float>(x, row_ptr, mask, out, mx, den,
                                          num_graphs, num_rows, num_features,
                                          stream);
}

extern "C" int graph_max_pool_bwd_f32(const float* g, const float* x,
                                      const int* row_ptr, const float* mask,
                                      const float* mx, const float* den,
                                      float* dx, int num_graphs,
                                      int num_rows, int num_features,
                                      cudaStream_t stream) {
  if (num_features % 4 == 0 && aligned16(g) && aligned16(x)
      && aligned16(mx) && aligned16(den) && aligned16(dx)) {
    ++float4_launches[1];
    return graph_max_pool_bwd_launch<float4>(g, x, row_ptr, mask, mx, den,
                                             dx, num_graphs, num_rows,
                                             num_features, stream);
  }
  return graph_max_pool_bwd_launch<float>(g, x, row_ptr, mask, mx, den, dx,
                                          num_graphs, num_rows, num_features,
                                          stream);
}
