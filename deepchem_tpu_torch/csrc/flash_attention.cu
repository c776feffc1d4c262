// Flash attention (P4): forward, dK/dV backward and dQ backward.
//
// Replaces the stock Pallas TPU flash attention that
// deepchem_tpu/models/bert_encoder.py:flash_or_xla_attention calls with
// use_flash=True (jax.experimental.pallas.ops.tpu.flash_attention):
//   forward  _flash_attention_impl / _flash_attention_kernel,
//   dK, dV   _flash_attention_bwd_dkv / _flash_attention_dkv_kernel,
//   dQ       _flash_attention_bwd_dq / _flash_attention_dq_kernel.
// Layout [B, H, S, D] row-major, non-causal, no bias, no segment ids (no
// caller in the repository passes them).  With s = q.k * scale:
//   forward  o = sum_j p_j v_j / l,  p_j = exp(s_j - m),  m = max_j s_j,
//            l = sum_j p_j (f32); p is rounded to the input type before
//            the product with v, as the stock kernel does; m and l are
//            saved in f32 for the backward.
//   backward p = exp(s - m) * (1 / l), dp = dO.v, ds = (dp - di) * p *
//            scale with di = sum(o * dO) per row (f32, from the caller);
//            dV = p^T dO, dK = ds^T q, dQ = ds k, with p and ds rounded to
//            the input type before each product, as in the stock kernels.
// The TPU kernels need S to be a multiple of their 128-row blocks; these
// kernels take any S and mask the ragged tile.
//
// Bound on this card.  A call does 4*S*S*D flops per (batch, head) in the
// forward, 8 in dK/dV (it recomputes s and dp) and 6 in dQ, and moves
// 4..7 arrays of S*D.  At the encoder's shape (S = 128, D = 64) that is 32
// flops per byte: memory bound in bf16 (295 flops a byte balance the
// tensor cores against HBM) and near balance in f32 on the FMA units.
// From S of about 1k up, bf16 is bound by the tensor cores.
//
// Design.  A block owns 64 rows of one (batch, head): q rows in the
// forward and dQ kernels, k rows in dK/dV, so every output row has one
// writer, no atomics are used and a repeat is bit-identical.  It walks the
// other side in tiles of 64 rows through shared memory, carrying the sums
// in registers.  No S x S array is stored.
//   bf16: 4 warps, each owning 16 rows.  Products are mma.sync m16n8k16
//         (bf16 in, f32 accumulate).  The block's own rows are held as A
//         fragments; the score accumulator is turned into the next
//         product's A fragment in registers (after rounding to bf16), so
//         p and ds never touch shared memory.  Shared tiles are padded by
//         8 elements a row, which keeps every fragment load free of bank
//         conflicts.  The dK/dV kernel computes s^T = k q^T directly, so
//         it needs no transpose.
//   f32:  no tensor cores (TF32 would not keep f32's digits).  D/32
//         threads share a row, each holding 32 of its columns in
//         registers; a dot product is summed across them with one shuffle.
//         Tiles of the other side are read from shared memory by
//         broadcast.
// Both take D = 32 and D = 64; the entries return cudaErrorInvalidValue
// for any other D.  wgmma and TMA are left to a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;  // rows a block owns
constexpr int kTile = 64;  // rows of the other side a step
constexpr unsigned kFullMask = 0xffffffffu;

// ---------------------------------------------------------------- loads

// Rows [row0, row0 + 64) of a [seq, D] matrix into a shared tile with
// `Pad` extra elements a row; rows past seq are zero.  16-byte vectors.
template <typename T, int D, int Pad>
__device__ __forceinline__ void load_tile(T (*dst)[D + Pad], const T* src,
                                          int row0, int seq) {
  constexpr int kVec = D * sizeof(T) / 16;  // 16-byte vectors a row
  constexpr int kPerVec = 16 / sizeof(T);
  for (int i = threadIdx.x; i < kTile * kVec; i += blockDim.x) {
    const int r = i / kVec;
    const int c = (i % kVec) * kPerVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seq) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(&dst[r][c]) = val;
  }
}

// m, 1/l and di of rows [row0, row0 + 64) into shared memory; rows past
// seq get 0, 1 and 0 (their p is masked to 0 by the caller).
__device__ __forceinline__ void load_stats(float* sm, float* slinv, float* sdi,
                                           const float* m, const float* l,
                                           const float* di, int row0,
                                           int seq) {
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
    const bool ok = row0 + i < seq;
    sm[i] = ok ? m[row0 + i] : 0.f;
    slinv[i] = ok ? 1.f / l[row0 + i] : 1.f;
    sdi[i] = ok ? di[row0 + i] : 0.f;
  }
}

// ------------------------------------------------ bf16: mma.sync m16n8k16
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 * g + t.
//   A 16x16 row-major: a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)
//                      a3 (g+8, 2t+8..)
//   B 16x8:            b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C 16x8 f32:        c0, c1 (g, 2t..2t+1)  c2, c3 (g+8, 2t..2t+1)
// The lower 16 bits of a register hold the element of lower index.

constexpr int kPad16 = 8;  // bf16 elements of padding a shared row
using bf16_t = uint16_t;   // raw bf16 bits in shared and global memory

template <int D>
using Tile16 = bf16_t[kTile][D + kPad16];

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const bf16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment: rows r0..r0+15, columns k0..k0+15 of a row-major tile.
template <int D>
__device__ __forceinline__ void frag_a(uint32_t a[4], const Tile16<D>& s,
                                       int r0, int k0, int g, int t) {
  a[0] = ld32(&s[r0 + g][k0 + 2 * t]);
  a[1] = ld32(&s[r0 + g + 8][k0 + 2 * t]);
  a[2] = ld32(&s[r0 + g][k0 + 2 * t + 8]);
  a[3] = ld32(&s[r0 + g + 8][k0 + 2 * t + 8]);
}

// B fragment whose n runs down the tile's rows: B[k][n] = s[n0 + n][k0 + k]
// (the tile is the right operand transposed, as k in q k^T).
template <int D>
__device__ __forceinline__ void frag_b_rows_n(uint32_t b[2],
                                              const Tile16<D>& s, int n0,
                                              int k0, int g, int t) {
  b[0] = ld32(&s[n0 + g][k0 + 2 * t]);
  b[1] = ld32(&s[n0 + g][k0 + 2 * t + 8]);
}

// B fragment whose k runs down the tile's rows: B[k][n] = s[k0 + k][n0 + n]
// (the tile is the right operand as stored, as v in p v).
template <int D>
__device__ __forceinline__ void frag_b_rows_k(uint32_t b[2],
                                              const Tile16<D>& s, int k0,
                                              int n0, int g, int t) {
  const int n = n0 + g;
  b[0] = (uint32_t)s[k0 + 2 * t][n] | ((uint32_t)s[k0 + 2 * t + 1][n] << 16);
  b[1] = (uint32_t)s[k0 + 2 * t + 8][n] |
         ((uint32_t)s[k0 + 2 * t + 9][n] << 16);
}

// The A fragment of columns 16kc..16kc+15 of a 16 x N f32 accumulator held
// as N/8 C fragments, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], float c[][4],
                                         int kc) {
  a[0] = pack_bf16(c[2 * kc][0], c[2 * kc][1]);
  a[1] = pack_bf16(c[2 * kc][2], c[2 * kc][3]);
  a[2] = pack_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1]);
  a[3] = pack_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3]);
}

// acc[0..N/8) += A (one 16 x 16 fragment) times rows k0..k0+15 of the
// tile `s`, as stored: a 16 x N product.
template <int D, int N>
__device__ __forceinline__ void mma_rows_k(float acc[][4],
                                           const uint32_t a[4],
                                           const Tile16<D>& s, int k0,
                                           int g, int t) {
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    uint32_t b[2];
    frag_b_rows_k<D>(b, s, k0, nt * 8, g, t);
    mma_bf16(acc[nt], a, b);
  }
}

// c[0..8) = A (16 x D, as D/16 fragments) times the transpose of the 64
// rows of `s`: a 16 x 64 product.
template <int D>
__device__ __forceinline__ void mma_rows_n(float c[kTile / 8][4],
                                           uint32_t a[D / 16][4],
                                           const Tile16<D>& s, int g,
                                           int t) {
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t b[2];
      frag_b_rows_n<D>(b, s, nt * 8, kc * 16, g, t);
      mma_bf16(c[nt], a[kc], b);
    }
  }
}

// Store a warp's 16 x D f32 accumulator as bf16 rows row0 + g, row0 + g + 8
// of `out` ([seq, D]); rows past seq are skipped.
template <int D>
__device__ __forceinline__ void store_rows_bf16(bf16_t* out,
                                                float acc[][4],
                                                int row0, int seq, int g,
                                                int t, float scale_a,
                                                float scale_b) {
  const int ra = row0 + g, rb = row0 + g + 8;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (ra < seq) {
      *reinterpret_cast<uint32_t*>(out + (size_t)ra * D + col) =
          pack_bf16(acc[nt][0] * scale_a, acc[nt][1] * scale_a);
    }
    if (rb < seq) {
      *reinterpret_cast<uint32_t*>(out + (size_t)rb * D + col) =
          pack_bf16(acc[nt][2] * scale_b, acc[nt][3] * scale_b);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFullMask, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFullMask, x, 1);
  return x + __shfl_xor_sync(kFullMask, x, 2);
}

template <int D>
__global__ void __launch_bounds__(128)
    flash_fwd_mma_kernel(const bf16_t* __restrict__ q,
                         const bf16_t* __restrict__ k,
                         const bf16_t* __restrict__ v,
                         bf16_t* __restrict__ o, float* __restrict__ m_out,
                         float* __restrict__ l_out, int seq, float scale) {
  __shared__ __align__(16) Tile16<D> sq;
  __shared__ __align__(16) Tile16<D> sk;
  __shared__ __align__(16) Tile16<D> sv;
  const size_t base = (size_t)blockIdx.x * seq * D;
  const int q0 = blockIdx.y * kRows;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;  // the warp's rows in the tile

  load_tile<bf16_t, D, kPad16>(sq, q + base, q0, seq);
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) frag_a<D>(qa[kc], sq, r0, kc * 16, g, t);

  float acc[D / 8][4] = {};
  float row_m[2] = {-INFINITY, -INFINITY}, row_l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile<bf16_t, D, kPad16>(sk, k + base, k0, seq);
    load_tile<bf16_t, D, kPad16>(sv, v + base, k0, seq);
    __syncthreads();
    float s[kTile / 8][4];
    mma_rows_n<D>(s, qa, sk, g, t);
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const float x = col < seq ? s[nt][e] * scale : -INFINITY;
        s[nt][e] = x;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // each tile holds a key < seq, so the new max is finite
      const float mn = fmaxf(row_m[i], quad_max(tile_max[i]));
      alpha[i] = expf(row_m[i] - mn);
      row_m[i] = mn;
    }
    float tile_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - row_m[e >> 1]);
        s[nt][e] = p;
        tile_sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      row_l[i] = row_l[i] * alpha[i] + quad_sum(tile_sum[i]);
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      uint32_t pa[4];
      acc_to_a(pa, s, kc);  // p rounded to bf16, as the stock kernel
      mma_rows_k<D, D>(acc, pa, sv, kc * 16, g, t);
    }
  }
  store_rows_bf16<D>(o + base, acc, q0 + r0, seq, g, t, 1.f / row_l[0],
                     1.f / row_l[1]);
  if (t == 0) {
    const size_t srow = (size_t)blockIdx.x * seq;
    const int ra = q0 + r0 + g, rb = ra + 8;
    if (ra < seq) {
      m_out[srow + ra] = row_m[0];
      l_out[srow + ra] = row_l[0];
    }
    if (rb < seq) {
      m_out[srow + rb] = row_m[1];
      l_out[srow + rb] = row_l[1];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(128)
    flash_dkv_mma_kernel(const bf16_t* __restrict__ q,
                         const bf16_t* __restrict__ k,
                         const bf16_t* __restrict__ v,
                         const bf16_t* __restrict__ dout,
                         const float* __restrict__ m,
                         const float* __restrict__ l,
                         const float* __restrict__ di,
                         bf16_t* __restrict__ dk, bf16_t* __restrict__ dv,
                         int seq, float scale) {
  __shared__ __align__(16) Tile16<D> sq;
  __shared__ __align__(16) Tile16<D> sdo;
  __shared__ float sm[kTile], slinv[kTile], sdi[kTile];
  const size_t base = (size_t)blockIdx.x * seq * D;
  const size_t srow = (size_t)blockIdx.x * seq;
  const int k0 = blockIdx.y * kRows;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;

  // the block's own k and v rows, as A fragments
  load_tile<bf16_t, D, kPad16>(sq, k + base, k0, seq);
  load_tile<bf16_t, D, kPad16>(sdo, v + base, k0, seq);
  __syncthreads();
  uint32_t ka[D / 16][4], va[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    frag_a<D>(ka[kc], sq, r0, kc * 16, g, t);
    frag_a<D>(va[kc], sdo, r0, kc * 16, g, t);
  }

  float dk_acc[D / 8][4] = {}, dv_acc[D / 8][4] = {};
  for (int q0 = 0; q0 < seq; q0 += kTile) {
    __syncthreads();
    load_tile<bf16_t, D, kPad16>(sq, q + base, q0, seq);
    load_tile<bf16_t, D, kPad16>(sdo, dout + base, q0, seq);
    load_stats(sm, slinv, sdi, m + srow, l + srow, di + srow, q0, seq);
    __syncthreads();
    // p^T: this warp's 16 keys against the tile's 64 queries
    float pt[kTile / 8][4];
    mma_rows_n<D>(pt, ka, sq, g, t);
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nt * 8 + 2 * t + (e & 1);
        pt[nt][e] = q0 + qi < seq
                        ? expf(pt[nt][e] * scale - sm[qi]) * slinv[qi]
                        : 0.f;
      }
    }
    // dV += p^T dO
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      uint32_t pa[4];
      acc_to_a(pa, pt, kc);
      mma_rows_k<D, D>(dv_acc, pa, sdo, kc * 16, g, t);
    }
    // dp^T = v dO^T, then ds^T = (dp^T - di) * p^T * scale
    float dst[kTile / 8][4];
    mma_rows_n<D>(dst, va, sdo, g, t);
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nt * 8 + 2 * t + (e & 1);
        dst[nt][e] = (dst[nt][e] - sdi[qi]) * pt[nt][e] * scale;
      }
    }
    // dK += ds^T q
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      uint32_t da[4];
      acc_to_a(da, dst, kc);
      mma_rows_k<D, D>(dk_acc, da, sq, kc * 16, g, t);
    }
  }
  store_rows_bf16<D>(dk + base, dk_acc, k0 + r0, seq, g, t, 1.f, 1.f);
  store_rows_bf16<D>(dv + base, dv_acc, k0 + r0, seq, g, t, 1.f, 1.f);
}

template <int D>
__global__ void __launch_bounds__(128)
    flash_dq_mma_kernel(const bf16_t* __restrict__ q,
                        const bf16_t* __restrict__ k,
                        const bf16_t* __restrict__ v,
                        const bf16_t* __restrict__ dout,
                        const float* __restrict__ m,
                        const float* __restrict__ l,
                        const float* __restrict__ di,
                        bf16_t* __restrict__ dq, int seq, float scale) {
  __shared__ __align__(16) Tile16<D> sk;
  __shared__ __align__(16) Tile16<D> sv;
  const size_t base = (size_t)blockIdx.x * seq * D;
  const size_t srow = (size_t)blockIdx.x * seq;
  const int q0 = blockIdx.y * kRows;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;

  // the block's own q and dO rows, as A fragments
  load_tile<bf16_t, D, kPad16>(sk, q + base, q0, seq);
  load_tile<bf16_t, D, kPad16>(sv, dout + base, q0, seq);
  __syncthreads();
  uint32_t qa[D / 16][4], doa[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    frag_a<D>(qa[kc], sk, r0, kc * 16, g, t);
    frag_a<D>(doa[kc], sv, r0, kc * 16, g, t);
  }
  float rm[2], rlinv[2], rdi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + r0 + g + 8 * i;
    rm[i] = r < seq ? m[srow + r] : 0.f;
    rlinv[i] = r < seq ? 1.f / l[srow + r] : 1.f;
    rdi[i] = r < seq ? di[srow + r] : 0.f;
  }

  float dq_acc[D / 8][4] = {};
  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();
    load_tile<bf16_t, D, kPad16>(sk, k + base, k0, seq);
    load_tile<bf16_t, D, kPad16>(sv, v + base, k0, seq);
    __syncthreads();
    float p[kTile / 8][4], ds[kTile / 8][4];
    mma_rows_n<D>(p, qa, sk, g, t);
    mma_rows_n<D>(ds, doa, sv, g, t);  // dp = dO v^T
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const int i = e >> 1;
        const float pe =
            col < seq ? expf(p[nt][e] * scale - rm[i]) * rlinv[i] : 0.f;
        ds[nt][e] = (ds[nt][e] - rdi[i]) * pe * scale;
      }
    }
    // dQ += ds k
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      uint32_t da[4];
      acc_to_a(da, ds, kc);
      mma_rows_k<D, D>(dq_acc, da, sk, kc * 16, g, t);
    }
  }
  store_rows_bf16<D>(dq + base, dq_acc, q0 + r0, seq, g, t, 1.f, 1.f);
}

// ------------------------------------------------------- f32: FMA units
//
// D/32 threads share a row (consecutive threads), each holding 32 of its
// columns; row_dot sums a dot product across them.

template <int D>
using Tile32 = float[kTile][D];

template <int D>
__device__ __forceinline__ float row_dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 32; e += 4) {
    const float4 x = *reinterpret_cast<const float4*>(b + e);
    s = fmaf(a[e], x.x, s);
    s = fmaf(a[e + 1], x.y, s);
    s = fmaf(a[e + 2], x.z, s);
    s = fmaf(a[e + 3], x.w, s);
  }
  if (D == 64) s += __shfl_xor_sync(kFullMask, s, 1);
  return s;
}

__device__ __forceinline__ void axpy32(float* y, float a, const float* x) {
#pragma unroll
  for (int e = 0; e < 32; e += 4) {
    const float4 v = *reinterpret_cast<const float4*>(x + e);
    y[e] = fmaf(a, v.x, y[e]);
    y[e + 1] = fmaf(a, v.y, y[e + 1]);
    y[e + 2] = fmaf(a, v.z, y[e + 2]);
    y[e + 3] = fmaf(a, v.w, y[e + 3]);
  }
}

// 32 floats of a row into registers (zeros past seq), and back.
__device__ __forceinline__ void load32(float* r, const float* src, bool ok) {
#pragma unroll
  for (int e = 0; e < 32; e += 4) {
    const float4 v = ok ? *reinterpret_cast<const float4*>(src + e)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    r[e] = v.x;
    r[e + 1] = v.y;
    r[e + 2] = v.z;
    r[e + 3] = v.w;
  }
}

__device__ __forceinline__ void store32(float* dst, const float* r,
                                        float scale) {
#pragma unroll
  for (int e = 0; e < 32; e += 4) {
    *reinterpret_cast<float4*>(dst + e) = make_float4(
        r[e] * scale, r[e + 1] * scale, r[e + 2] * scale, r[e + 3] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kRows * D / 32)
    flash_fwd_fma_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ m_out, float* __restrict__ l_out,
                         int seq, float scale) {
  constexpr int kChunk = 16;  // keys between two rescales of acc
  __shared__ __align__(16) Tile32<D> sk;
  __shared__ __align__(16) Tile32<D> sv;
  const size_t base = (size_t)blockIdx.x * seq * D;
  const int row = blockIdx.y * kRows + threadIdx.x / (D / 32);
  const int c0 = (threadIdx.x % (D / 32)) * 32;
  const bool live = row < seq;

  float qr[32], acc[32];
  load32(qr, q + base + (size_t)row * D + c0, live);
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  float row_m = -INFINITY, row_l = 0.f;
  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();
    load_tile<float, D, 0>(sk, k + base, k0, seq);
    load_tile<float, D, 0>(sv, v + base, k0, seq);
    __syncthreads();
    const int n = min(kTile, seq - k0);
    for (int j0 = 0; j0 < n; j0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float x = row_dot<D>(qr, &sk[j0 + jj][c0]) * scale;
        s[jj] = j0 + jj < n ? x : -INFINITY;
        cmax = fmaxf(cmax, s[jj]);
      }
      const float mn = fmaxf(row_m, cmax);  // finite: key j0 < n is live
      const float alpha = expf(row_m - mn);
      row_m = mn;
      float csum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        s[jj] = expf(s[jj] - row_m);
        csum += s[jj];
      }
      row_l = row_l * alpha + csum;
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) axpy32(acc, s[jj], &sv[j0 + jj][c0]);
    }
  }
  if (live) {
    store32(o + base + (size_t)row * D + c0, acc, 1.f / row_l);
    if (c0 == 0) {
      m_out[(size_t)blockIdx.x * seq + row] = row_m;
      l_out[(size_t)blockIdx.x * seq + row] = row_l;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kRows * D / 32)
    flash_dkv_fma_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ m,
                         const float* __restrict__ l,
                         const float* __restrict__ di,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int seq, float scale) {
  __shared__ __align__(16) Tile32<D> sq;
  __shared__ __align__(16) Tile32<D> sdo;
  __shared__ float sm[kTile], slinv[kTile], sdi[kTile];
  const size_t base = (size_t)blockIdx.x * seq * D;
  const size_t srow = (size_t)blockIdx.x * seq;
  const int row = blockIdx.y * kRows + threadIdx.x / (D / 32);
  const int c0 = (threadIdx.x % (D / 32)) * 32;
  const bool live = row < seq;

  float kr[32], vr[32], dk_acc[32], dv_acc[32];
  load32(kr, k + base + (size_t)row * D + c0, live);
  load32(vr, v + base + (size_t)row * D + c0, live);
#pragma unroll
  for (int e = 0; e < 32; ++e) dk_acc[e] = dv_acc[e] = 0.f;
  for (int q0 = 0; q0 < seq; q0 += kTile) {
    __syncthreads();
    load_tile<float, D, 0>(sq, q + base, q0, seq);
    load_tile<float, D, 0>(sdo, dout + base, q0, seq);
    load_stats(sm, slinv, sdi, m + srow, l + srow, di + srow, q0, seq);
    __syncthreads();
    const int n = min(kTile, seq - q0);
    for (int i = 0; i < n; ++i) {
      const float p =
          expf(row_dot<D>(kr, &sq[i][c0]) * scale - sm[i]) * slinv[i];
      axpy32(dv_acc, p, &sdo[i][c0]);
      const float ds = (row_dot<D>(vr, &sdo[i][c0]) - sdi[i]) * p * scale;
      axpy32(dk_acc, ds, &sq[i][c0]);
    }
  }
  if (live) {
    store32(dk + base + (size_t)row * D + c0, dk_acc, 1.f);
    store32(dv + base + (size_t)row * D + c0, dv_acc, 1.f);
  }
}

template <int D>
__global__ void __launch_bounds__(kRows * D / 32)
    flash_dq_fma_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ m,
                        const float* __restrict__ l,
                        const float* __restrict__ di,
                        float* __restrict__ dq, int seq, float scale) {
  __shared__ __align__(16) Tile32<D> sk;
  __shared__ __align__(16) Tile32<D> sv;
  const size_t base = (size_t)blockIdx.x * seq * D;
  const size_t srow = (size_t)blockIdx.x * seq;
  const int row = blockIdx.y * kRows + threadIdx.x / (D / 32);
  const int c0 = (threadIdx.x % (D / 32)) * 32;
  const bool live = row < seq;

  float qr[32], dor[32], dq_acc[32];
  load32(qr, q + base + (size_t)row * D + c0, live);
  load32(dor, dout + base + (size_t)row * D + c0, live);
#pragma unroll
  for (int e = 0; e < 32; ++e) dq_acc[e] = 0.f;
  const float rm = live ? m[srow + row] : 0.f;
  const float rlinv = live ? 1.f / l[srow + row] : 1.f;
  const float rdi = live ? di[srow + row] : 0.f;
  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();
    load_tile<float, D, 0>(sk, k + base, k0, seq);
    load_tile<float, D, 0>(sv, v + base, k0, seq);
    __syncthreads();
    const int n = min(kTile, seq - k0);
    for (int j = 0; j < n; ++j) {
      const float p = expf(row_dot<D>(qr, &sk[j][c0]) * scale - rm) * rlinv;
      const float ds = (row_dot<D>(dor, &sv[j][c0]) - rdi) * p * scale;
      axpy32(dq_acc, ds, &sk[j][c0]);
    }
  }
  if (live) store32(dq + base + (size_t)row * D + c0, dq_acc, 1.f);
}

// ---------------------------------------------------------------- launch

inline dim3 grid_of(int bh, int seq) {
  return dim3(bh, (seq + kRows - 1) / kRows);
}

}  // namespace

// Each entry launches one kernel on `stream` for `bh` = B*H slices of
// `seq` rows of `d` columns; `bf16` selects bfloat16 data (else float32).
// Returns cudaGetLastError() as an int, or cudaErrorInvalidValue for a d
// other than 32 and 64.

extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* m,
                                   float* l, int bh, int seq, int d,
                                   int bf16, float scale,
                                   cudaStream_t stream) {
  const dim3 grid = grid_of(bh, seq);
  using B = const bf16_t*;
  using F = const float*;
  if (bf16 && d == 64) {
    flash_fwd_mma_kernel<64><<<grid, 128, 0, stream>>>(
        (B)q, (B)k, (B)v, (bf16_t*)o, m, l, seq, scale);
  } else if (bf16 && d == 32) {
    flash_fwd_mma_kernel<32><<<grid, 128, 0, stream>>>(
        (B)q, (B)k, (B)v, (bf16_t*)o, m, l, seq, scale);
  } else if (!bf16 && d == 64) {
    flash_fwd_fma_kernel<64><<<grid, 128, 0, stream>>>(
        (F)q, (F)k, (F)v, (float*)o, m, l, seq, scale);
  } else if (!bf16 && d == 32) {
    flash_fwd_fma_kernel<32><<<grid, 64, 0, stream>>>(
        (F)q, (F)k, (F)v, (float*)o, m, l, seq, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attention_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* m, const float* l,
                                   const float* di, void* dk, void* dv,
                                   int bh, int seq, int d, int bf16,
                                   float scale, cudaStream_t stream) {
  const dim3 grid = grid_of(bh, seq);
  using B = const bf16_t*;
  using F = const float*;
  if (bf16 && d == 64) {
    flash_dkv_mma_kernel<64><<<grid, 128, 0, stream>>>(
        (B)q, (B)k, (B)v, (B)dout, m, l, di, (bf16_t*)dk, (bf16_t*)dv, seq,
        scale);
  } else if (bf16 && d == 32) {
    flash_dkv_mma_kernel<32><<<grid, 128, 0, stream>>>(
        (B)q, (B)k, (B)v, (B)dout, m, l, di, (bf16_t*)dk, (bf16_t*)dv, seq,
        scale);
  } else if (!bf16 && d == 64) {
    flash_dkv_fma_kernel<64><<<grid, 128, 0, stream>>>(
        (F)q, (F)k, (F)v, (F)dout, m, l, di, (float*)dk, (float*)dv, seq,
        scale);
  } else if (!bf16 && d == 32) {
    flash_dkv_fma_kernel<32><<<grid, 64, 0, stream>>>(
        (F)q, (F)k, (F)v, (F)dout, m, l, di, (float*)dk, (float*)dv, seq,
        scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attention_dq(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* m, const float* l,
                                  const float* di, void* dq, int bh,
                                  int seq, int d, int bf16, float scale,
                                  cudaStream_t stream) {
  const dim3 grid = grid_of(bh, seq);
  using B = const bf16_t*;
  using F = const float*;
  if (bf16 && d == 64) {
    flash_dq_mma_kernel<64><<<grid, 128, 0, stream>>>(
        (B)q, (B)k, (B)v, (B)dout, m, l, di, (bf16_t*)dq, seq, scale);
  } else if (bf16 && d == 32) {
    flash_dq_mma_kernel<32><<<grid, 128, 0, stream>>>(
        (B)q, (B)k, (B)v, (B)dout, m, l, di, (bf16_t*)dq, seq, scale);
  } else if (!bf16 && d == 64) {
    flash_dq_fma_kernel<64><<<grid, 128, 0, stream>>>(
        (F)q, (F)k, (F)v, (F)dout, m, l, di, (float*)dq, seq, scale);
  } else if (!bf16 && d == 32) {
    flash_dq_fma_kernel<32><<<grid, 64, 0, stream>>>(
        (F)q, (F)k, (F)v, (F)dout, m, l, di, (float*)dq, seq, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
