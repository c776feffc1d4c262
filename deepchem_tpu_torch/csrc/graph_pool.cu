// Max readout over each graph's rows, forward and backward (K3).
//
// Replaces the custom-VJP XLA op deepchem_tpu/ops/segment.py
// segment_max_sumgrad as graph_pool(..., 'max') calls it (:173-236; the
// JAX package has no Pallas kernel for it).  Rows are graph-contiguous:
// graph b owns rows [row_ptr[b], row_ptr[b+1]), and rows past row_ptr[G]
// (the ghost slot) belong to no graph.  Per graph b and feature f, over the
// rows r of b whose mask is set (every row when there is no mask):
//   mx  = max x[r, f]; 0 where that is not finite or not above NEG / 2
//         (no valid row, or values as low as the masking value)
//   sel = x[r, f] >= mx
//   den = number of selected rows; out = (sum of selected x) / den, in row
//         order; 0 where den == 0
// so tied maxima share the result and an empty graph gives 0.  Backward,
// as the JAX op's stop_gradients make it (mx and den carry none):
//   dx[r, f] = g[b, f] / max(den, 1) where r is valid and selected, else 0,
// and 0 on the ghost rows.  Masked rows are skipped, not multiplied by 0.
//
// Bound on this card: memory bytes.  GraphConv's main path hands it
// x [5120, 128] f32 (about 4.6k real rows) and 256 graphs: the forward
// reads x once (2.4 MB of real rows) and writes out, mx and den (3 x 131
// KB); the backward reads x, g, mx, den and writes dx: 2.6 to 2.9 MB, about
// 0.8 us at 3.35 TB/s.  At that size the launch and each block's chain of
// ~18 dependent row reads set the time.
//
// Design.  Forward: one block per real graph, threads across the features
// (a block of up to 128 threads loops over wider rows); each thread walks
// its graph's rows twice, for the max and for the selected sum, so every
// output has one writer and its terms are added in row order: no atomics,
// the same bits on every run.  The ghost segment gets no block.  Backward:
// the same blocks recompute sel from x and the saved mx, and extra blocks
// after the G graph blocks write the zeros of the ghost rows, 32 rows each.
//
// Inputs: x [N, F] float32 row-major, row_ptr [G+1] int32 non-decreasing
// with row_ptr[0] == 0 (clamped to [0, N]), mask [N] float32 or null.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -9e15f;  // the masking value of ops/segment.py
constexpr int kMaxThreads = 128;
constexpr int kTailRows = 32;   // ghost rows zeroed by one backward block

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

__global__ void __launch_bounds__(kMaxThreads)
graph_max_pool_fwd_kernel(const float* __restrict__ x,
                          const int* __restrict__ row_ptr,
                          const float* __restrict__ mask,
                          float* __restrict__ out, float* __restrict__ mx_out,
                          float* __restrict__ den_out, int num_rows,
                          int num_features) {
  const int b = blockIdx.x;
  int start, end;
  bounds(row_ptr, b, num_rows, &start, &end);
  const int64_t F = num_features;
  for (int f = threadIdx.x; f < num_features; f += blockDim.x) {
    float mx = -INFINITY;
    for (int r = start; r < end; ++r) {
      if (!valid(mask, r)) continue;
      const float v = x[r * F + f];
      if (v > mx) mx = v;
    }
    if (!(isfinite(mx) && mx > 0.5f * kNeg)) mx = 0.f;
    float num = 0.f, den = 0.f;
    for (int r = start; r < end; ++r) {
      if (!valid(mask, r)) continue;
      const float v = x[r * F + f];
      if (v >= mx) {
        num += v;
        den += 1.f;
      }
    }
    out[b * F + f] = den > 0.f ? num / fmaxf(den, 1.f) : 0.f;
    mx_out[b * F + f] = mx;
    den_out[b * F + f] = den;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
graph_max_pool_bwd_kernel(const float* __restrict__ g,
                          const float* __restrict__ x,
                          const int* __restrict__ row_ptr,
                          const float* __restrict__ mask,
                          const float* __restrict__ mx_in,
                          const float* __restrict__ den_in,
                          float* __restrict__ dx, int num_graphs,
                          int num_rows, int num_features) {
  const int64_t F = num_features;
  const int b = blockIdx.x;
  if (b >= num_graphs) {  // the ghost rows past row_ptr[G]: zeros
    const int ghost = min(max(row_ptr[num_graphs], 0), num_rows);
    const int lo = max((b - num_graphs) * kTailRows, ghost);
    const int hi = min((b - num_graphs + 1) * kTailRows, num_rows);
    for (int r = lo; r < hi; ++r) {
      for (int f = threadIdx.x; f < num_features; f += blockDim.x) {
        dx[r * F + f] = 0.f;
      }
    }
    return;
  }
  int start, end;
  bounds(row_ptr, b, num_rows, &start, &end);
  for (int f = threadIdx.x; f < num_features; f += blockDim.x) {
    const float mx = mx_in[b * F + f];
    const float t = g[b * F + f] / fmaxf(den_in[b * F + f], 1.f);
    for (int r = start; r < end; ++r) {
      const float v = x[r * F + f];
      dx[r * F + f] = valid(mask, r) && v >= mx ? t : 0.f;
    }
  }
}

inline int threads_for(int num_features) {
  const int t = ((num_features + 31) / 32) * 32;
  return t < kMaxThreads ? (t > 0 ? t : 32) : kMaxThreads;
}

}  // namespace

// Each launches its kernel on `stream`; returns cudaGetLastError() as an int.
extern "C" int graph_max_pool_fwd_f32(const float* x, const int* row_ptr,
                                      const float* mask, float* out,
                                      float* mx, float* den, int num_graphs,
                                      int num_rows, int num_features,
                                      cudaStream_t stream) {
  graph_max_pool_fwd_kernel<<<num_graphs, threads_for(num_features), 0,
                              stream>>>(x, row_ptr, mask, out, mx, den,
                                        num_rows, num_features);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int graph_max_pool_bwd_f32(const float* g, const float* x,
                                      const int* row_ptr, const float* mask,
                                      const float* mx, const float* den,
                                      float* dx, int num_graphs,
                                      int num_rows, int num_features,
                                      cudaStream_t stream) {
  const int tail = (num_rows + kTailRows - 1) / kTailRows;
  graph_max_pool_bwd_kernel<<<num_graphs + tail, threads_for(num_features),
                              0, stream>>>(g, x, row_ptr, mask, mx, den, dx,
                                           num_graphs, num_rows,
                                           num_features);
  return static_cast<int>(cudaGetLastError());
}
