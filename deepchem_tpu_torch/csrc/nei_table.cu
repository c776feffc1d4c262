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
// that size latency sets the time: each warp's loads are a chain of up to
// deg dependent row reads.
//
// Design.  One warp per node, 8 nodes a block.  Lane j < deg reads
// table[i, j] once; each slot's index is broadcast by a shuffle, and the
// lanes run across the row's features, 32 a step (F = 75 takes three steps,
// the last with 11 lanes), with single-float loads so that any F and any
// row alignment work.  Each output element has one writer and its terms
// are added in slot order: no atomics, the same bits on every run.
//
// Inputs: h (or g) [N, F] float32 row-major, table [N, K] int32, deg [N]
// int8, K <= 32.  deg is clamped to [0, K]; table entries of real slots
// must lie in [0, N).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

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

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
nei_sum_kernel(const float* __restrict__ h, const int* __restrict__ table,
               const int8_t* __restrict__ deg, float* __restrict__ out,
               int num_nodes, int k, int num_features) {
  const Row r = warp_row(table, deg, num_nodes, k);
  if (r.node < 0) return;  // uniform in the warp
  const int lane = threadIdx.x & 31;
  const int64_t F = num_features;
  for (int f0 = 0; f0 < num_features; f0 += 32) {
    const int f = f0 + lane;
    const bool active = f < num_features;
    float acc = 0.f;
    for (int j = 0; j < r.deg; ++j) {
      const int src = __shfl_sync(kFullMask, r.slot, j);
      if (active) acc += h[src * F + f];
    }
    if (active) out[r.node * F + f] = acc;
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

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
nei_max_bwd_kernel(const float* __restrict__ g, const int* __restrict__ table,
                   const int8_t* __restrict__ deg,
                   const int* __restrict__ winner, float* __restrict__ grad,
                   int num_nodes, int k, int num_features) {
  const Row r = warp_row(table, deg, num_nodes, k);
  if (r.node < 0) return;
  const int lane = threadIdx.x & 31;
  const int64_t F = num_features;
  for (int f0 = 0; f0 < num_features; f0 += 32) {
    const int f = f0 + lane;
    const bool active = f < num_features;
    float acc = 0.f;
    if (active && winner[r.node * F + f] == r.node) acc = g[r.node * F + f];
    for (int j = 0; j < r.deg; ++j) {
      const int src = __shfl_sync(kFullMask, r.slot, j);
      // src's winner is this node: src names it in one of its own slots
      if (active && winner[src * F + f] == r.node) acc += g[src * F + f];
    }
    if (active) grad[r.node * F + f] = acc;
  }
}

inline int blocks_for(int num_nodes) {
  return (num_nodes + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

}  // namespace

// Each launches its kernel on `stream`; returns cudaGetLastError() as an int.
extern "C" int nei_sum_f32(const float* h, const int* table,
                           const int8_t* deg, float* out, int num_nodes,
                           int k, int num_features, cudaStream_t stream) {
  nei_sum_kernel<<<blocks_for(num_nodes), kWarpsPerBlock * 32, 0, stream>>>(
      h, table, deg, out, num_nodes, k, num_features);
  return static_cast<int>(cudaGetLastError());
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
  nei_max_bwd_kernel<<<blocks_for(num_nodes), kWarpsPerBlock * 32, 0,
                       stream>>>(g, table, deg, winner, grad, num_nodes, k,
                                 num_features);
  return static_cast<int>(cudaGetLastError());
}
