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
//            the product with v, as the stock kernel does (in f32, not at
//            all); m and l are saved in f32 for the backward.
//   backward p = exp(s - m) * (1 / l), dp = dO.v, ds = (dp - di) * p *
//            scale with di = sum(o * dO) per row (f32, from the caller);
//            dV = p^T dO, dK = ds^T q, dQ = ds k, with p and ds rounded to
//            the input type before each product, as in the stock kernels.
// The TPU kernels need S to be a multiple of their 128-row blocks; these
// kernels take any S and mask the ragged tile.
//
// Bound on this card.  A call does 4*S*S*D flops per (batch, head) in the
// forward, 8 in dK/dV (it recomputes s and dp) and 6 in dQ, and moves
// 4..7 arrays of S*D.  At the encoder's shape ([32, 12, 128, 64], bf16)
// that is 32 flops per byte: bound by bytes (295 flops a byte balance the
// tensor cores against HBM), 7.6 us for the forward, 11.4 for dK/dV and 9.6
// for dQ.  From S of about 1k up, bf16 is bound by the tensor cores: at
// [16, 12, 4096, 64] 0.83 ms for the forward, 1.67 for dK/dV and 1.25 for
// dQ.  In f32 every kernel runs on the tensor cores in three tf32 passes
// (below), so its products count three times at 494.7 TF/s: at the
// encoder's shape bytes bound them (the forward 50.7 MB, 15.1 us at 3.35
// TB/s, against 9.8 us of products; dK/dV 22.7 us, dQ 19.0 us); from S =
// 512 the products do (at S = 4096, dK/dV 10.0 ms, dQ 7.5 ms).
//
// Design.  Every output row has one writer: a block owns rows of one
// (batch, head) (q rows in the forward and dQ kernels, k rows in dK/dV)
// and walks the other side in tiles of 64 rows, carrying its sums in
// registers.  No atomics are used, so a repeat is bit-identical, and no
// S x S array is stored.
//   bf16, for Hopper (forward, dK/dV and dQ): warp-specialised blocks of
//         two consumer warpgroups (64 own rows each, 128 a block) and one
//         producer warp.  The producer loads the block's own rows once by
//         TMA, then streams the other side's 64-row tiles (forward and dQ:
//         k and v; dK/dV: q and dO) through a ring of 4 shared-memory
//         slots guarded by
//         mbarriers (full: the slot's TMA bytes have landed and each of
//         the producer's 32 lanes has arrived after storing its part of
//         the slot's statistics; empty: every consumer thread is done with
//         it).  Consumers run wgmma m64nNk16, bf16 in, f32 accumulate:
//           dK/dV  s^T = k q^T and dp^T = v dO^T (both operands K-major in
//                  shared memory, issued as one group); p^T = 2^(s^T scale
//                  log2 e - m log2 e) / l, 0 past seq; ds^T = p^T (dp^T -
//                  di) scale; p^T and ds^T rounded to bf16 in registers
//                  (the accumulator's fragment is the next A operand); then
//                  dV += p^T dO and dK += ds^T q as one group (A from
//                  registers, dO and q MN-major: trans-b).  The
//                  accumulator's columns are queries, so each thread reads
//                  m, 1/l and di of its 16 columns from the copy the
//                  producer writes beside the slot, loaded a tile ahead.
//           dQ     s = q k^T and dp = dO v^T; ds in registers (m, 1/l and
//                  di of the thread's two rows held in registers); dQ +=
//                  ds k (k MN-major).
//           fwd    s = q k^T; the online softmax in registers, the row max
//                  across the quad that holds a row; p = 2^(s scale log2 e
//                  - m log2 e) by one FMA and ex2.approx, o rescaled by
//                  alpha = 2^((m_old - m) log2 e); p rounded to bf16 as the
//                  A operand of o += p v (v MN-major); o / l, m and l
//                  written at the end.  Its blocks are numbered with the
//                  query tile fastest, so the blocks of one head run
//                  together and read its k and v from L2.
//         dK, dV, dQ and o stay in registers until the epilogue.  Tensor maps
//         are 3-D ([B*H, S, D], box [1, 64, D]), so a box past S is filled
//         with zeros rather than the next head's rows; the masks past S
//         stay, since a zero row gives a score of 0, not -inf (and, in the
//         backward, with m = 0 and 1/l = 1, p = 1).
//         Tiles are swizzled by the width of a row (128 B for D = 64, 64 B
//         for D = 32): a wgmma reads the same q or dO tile K-major (start
//         +32 B a k-step, 8-row atoms 16D bytes apart) and MN-major (start
//         +16 rows a k-step, the same 16D-byte stride between 8-row
//         groups along the reduction).
//         What the card showed (H100; PERF.md section 6 has the times of
//         each choice undone): ds and both bf16 fragments are made before
//         dV's and dK's products are issued, since otherwise dK/dV needs
//         more than the 168 registers a thread its launch allows and
//         ptxas serialises every wgmma (info C7512); the producer issues
//         a slot's copies before it stores the statistics, and loads them
//         a tile ahead, after its arrival, or their latency paces the
//         ring; p takes one FMA and ex2.approx, not expf.
//         Tiles by shape: one configuration for every S and D, two
//         consumer warpgroups a block and 4 slots.  One warpgroup a block
//         (two blocks an SM) wins only dK/dV at the encoder's shape and
//         small S with few heads, and loses from S = 512 up; 2 slots lose
//         a little from S = 512 up.  No setmaxnreg: the consumers fit
//         their 168 registers without spilling.
//         The forward keeps that configuration; PERF.md has its
//         alternatives measured.  SASS (cuobjdump, scripts/sass_counts.py):
//         dK/dV holds 16 HGMMA (12 at D = 32), dQ 12 (8), each with TMA
//         loads (UTMALDG) and no HMMA; the forward's counts are in PERF.md.
//   f32 forward (flash_fwd_tf32x3_kernel): the bf16 forward's blocks,
//         TMA ring and online softmax, with both products on the tensor
//         cores in three tf32 passes (3xTF32: each operand split into a
//         big and a small tf32, only small x small dropped), which keeps
//         f32's digits: s = q k^T by wgmma from q's and k's big and small
//         planes in shared memory, o += p v by mma.sync m16n8k8, since
//         wgmma takes tf32 operands only K-major and v is stored [keys,
//         D].  p is not rounded: it is split like any operand.
//   f32 backward (flash_dkv_tf32x3_kernel, flash_dq_tf32x3_kernel): the
//         bf16 backward's producer and ring, with the f32 forward's
//         arithmetic: s and dp by wgmma from big and small planes, the
//         products with an MN-major operand (dV, dK, dQ) by mma.sync from
//         the tile's planes, p and ds in f32 registers, split like any
//         operand.  Blocks of one consumer warpgroup (64 own rows) and
//         the producer warp, with 2 slots: shared memory binds (the
//         reasons are at the kernels).
// All take D = 32 and D = 64; the entries return cudaErrorInvalidValue for
// any other D.  The ring kernels return the error of a tensor map they
// cannot make or a launch the runtime refuses; no other kernel stands in.

#include <cuda.h>  // CUtensorMap and its enums; no driver call is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// ------------------------------------------ bf16: wgmma, TMA, an mbarrier ring

using bf16_t = uint16_t;  // raw bf16 bits in shared and global memory

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Max and sum over the 4 lanes of a quad, which hold one accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFullMask, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFullMask, x, 1);
  return x + __shfl_xor_sync(kFullMask, x, 2);
}

constexpr int kBox = 64;      // rows of a TMA box: one wgmma M (or N) tile
constexpr int kBoxCols = 32;  // floats a row of an f32 box: 128 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Raise the bytes the current phase waits for, without an arrival.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Wait until the phase of `parity` has completed.  A wait longer than 2^32
// cycles (about 2 s) traps, so a fault in the ring ends the launch with an
// error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) break;
    if (clock64() - start > (1ll << 32)) __trap();
  }
  __syncwarp();  // the .aligned wgmma instructions want the warp whole
}

// Box `row` of a [bh, seq, D] tensor map (rows row..row+63 of slice bh,
// from column `col` on) into shared memory, completing on `bar`; rows past
// seq arrive as zeros.
__device__ __forceinline__ void tma_load_rows(void* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int row, int bh,
                                              int col = 0) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(bh)
      : "memory");
}

// wgmma shared-memory matrix descriptor (PTX ISA, "Matrix Descriptor
// Format"): start address, leading and stride byte offsets in 16-byte
// units, and the swizzle.  Every tile is a TMA box of 64 rows of D bf16
// (2D bytes a row) written with a 2D-byte swizzle, 128 B for D = 64 and
// 64 B for D = 32, so an atom of 8 rows is 16D bytes.
template <int D>
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  constexpr uint64_t kLayout = D == 64 ? 1 : 2;  // 128-byte or 64-byte swizzle
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (kLayout << 62);
}

// The tile as a K-major operand (the reduction runs along its rows):
// k-step `ks` starts 16 columns, 32 bytes, into each row; 8-row atoms are
// 16D bytes apart; the leading offset is unused under a swizzle.
template <int D>
__device__ __forceinline__ uint64_t desc_k_major(const bf16_t* tile, int ks) {
  return gmma_desc<D>(smem_u32(tile) + 32 * ks, 16, 16 * D);
}

// The tile as an MN-major operand (the reduction runs down its rows; the
// `trans-b` form): k-step `ks` starts 16 rows down; 8-row groups along the
// reduction are 16D bytes apart (stride offset); the N = D columns are one
// swizzle atom wide, so the leading offset (the next atom along N) is
// never taken.
template <int D>
__device__ __forceinline__ uint64_t desc_mn_major(const bf16_t* tile, int ks) {
  return gmma_desc<D>(smem_u32(tile) + 32 * D * ks, kBox * 2 * D, 16 * D);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers at this point of the program, so that the compiler reads
// no accumulator before wgmma_wait_all.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (relative error about 2^-22, far
// below the bf16 rounding of p and ds that follows).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// p^T of a dK/dV tile in place: exp(s^T scale - m) / l as 2^(s^T scale2 -
// m2) * (1 / l), with scale2 = scale log2(e) and m2 = m log2(e); columns
// (queries) from `valid` on are 0 when Masked.
template <bool Masked>
__device__ __forceinline__ void probs_t(float (&pt)[32], const float* m2,
                                        const float* linv, float scale2,
                                        int t, int valid) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = 8 * j + 2 * t + (e & 1);
      const float p =
          exp2_approx(fmaf(pt[4 * j + e], scale2, -m2[qi])) * linv[qi];
      pt[4 * j + e] = !Masked || qi < valid ? p : 0.f;
    }
  }
}

// ds of a dQ tile in place, from s and dp: (dp - di) p scale with p as in
// probs_t over the thread's two rows; columns (keys) from `valid` on
// give 0 when Masked.
template <bool Masked>
__device__ __forceinline__ void grad_scores(float (&ds)[32],
                                            const float (&sc)[32],
                                            const float (&m2)[2],
                                            const float (&linv)[2],
                                            const float (&di)[2],
                                            float scale2, float scale, int t,
                                            int valid) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * t + (e & 1), i = e >> 1;
      float p = exp2_approx(fmaf(sc[4 * j + e], scale2, -m2[i])) * linv[i];
      if (Masked && col >= valid) p = 0.f;
      ds[4 * j + e] = (ds[4 * j + e] - di[i]) * p * scale;
    }
  }
}

// d (64 x 64, f32) = A B (+ d if accumulate): A 64 x 16 and B 16 x 64,
// both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) += A B: A 64 x 16 in registers (the mma.m16n8k16 A
// fragment, per warp), B 16 x 64 MN-major in shared memory (trans-b).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 32, f32) += A B: A 64 x 16 in registers (the mma.m16n8k16 A
// fragment, per warp), B 16 x 32 MN-major in shared memory (trans-b).
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The A fragment of columns 16kc..16kc+15 of a 64 x 64 wgmma accumulator,
// rounded to bf16.  Per warp the accumulator holds rows g and g + 8 of its
// 16 (lane = 4 g + t), columns 8j + 2t and 8j + 2t + 1 in c[4j..4j+3]: the
// mma.m16n8k16 C layout, which is also its A layout two columns at a time.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c)[32], int kc) {
  a[0] = pack_bf16(c[8 * kc + 0], c[8 * kc + 1]);
  a[1] = pack_bf16(c[8 * kc + 2], c[8 * kc + 3]);
  a[2] = pack_bf16(c[8 * kc + 4], c[8 * kc + 5]);
  a[3] = pack_bf16(c[8 * kc + 6], c[8 * kc + 7]);
}

// Store a warp's 16 x D rows of a wgmma accumulator as bf16 rows row0 + g
// and row0 + g + 8 of `out` ([seq, D]); rows past seq are skipped.
template <int D>
__device__ __forceinline__ void store_acc_bf16(bf16_t* out,
                                               const float (&acc)[D / 2],
                                               int row0, int seq, int g,
                                               int t) {
  const int ra = row0 + g, rb = row0 + g + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (ra < seq) {
      *reinterpret_cast<uint32_t*>(out + (size_t)ra * D + col) =
          pack_bf16(acc[4 * j], acc[4 * j + 1]);
    }
    if (rb < seq) {
      *reinterpret_cast<uint32_t*>(out + (size_t)rb * D + col) =
          pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

constexpr int kConsumers = 2;                  // warpgroups, 64 own rows each
constexpr int kOwnRows = kConsumers * kBox;    // rows a block owns
constexpr int kStages = 4;                     // slots of the ring
constexpr int kRingThreads = kConsumers * 128 + 32;  // and one producer warp

// Shared memory of the bf16 backward kernels.  `own`: the block's 128
// rows (dK/dV: k and v; dQ: q and dO).  `ring`: kStages tiles of 64 rows
// of the other side (dK/dV: q and dO; dQ: k and v), with the statistics of
// a q tile where the kernel needs them per column (dK/dV).  Every tile is a
// multiple of 1024 bytes from a 1024-byte aligned start, as the swizzle
// wants.  The constants and box accessors are what `produce` reads: a row
// is one box wide.
template <int D, bool Stats>
struct BwdSmem {
  static constexpr int kSlots = kStages, kOwnBoxes = kConsumers, kHalves = 1;
  static constexpr bool kStats = Stats;
  static constexpr uint32_t kBoxBytes = kBox * D * sizeof(bf16_t);
  bf16_t own0[kOwnRows * D];
  bf16_t own1[kOwnRows * D];
  bf16_t ring0[kStages][kBox * D];
  bf16_t ring1[kStages][kBox * D];
  float stats[Stats ? kStages : 1][3][kBox];  // m log2(e), 1/l, di
  uint64_t own_full, full[kStages], empty[kStages];
  // box c of own tensor i (0: own0, 1: own1), and tensor i of slot s
  __device__ bf16_t* own_box(int i, int c, int) {
    return (i ? own1 : own0) + c * kBox * D;
  }
  __device__ bf16_t* ring_box(int i, int s, int) {
    return i ? ring1[s] : ring0[s];
  }
};

template <typename Smem>
__device__ __forceinline__ Smem& ring_smem() {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  return *reinterpret_cast<Smem*>(smem_raw + pad);
}

// Barriers: own_full takes the TMA bytes of the block's own rows; full[s]
// the slot's TMA bytes and the 32 producer lanes, each arriving after its
// stores (of the statistics, in dK/dV); empty[s] every one of the
// `consumers` consumer threads.
template <typename Smem>
__device__ __forceinline__ void init_barriers(
    Smem& sm, int consumers = kConsumers * 128) {
  constexpr int kSlots = sizeof(sm.full) / sizeof(sm.full[0]);
  if (threadIdx.x == 0) {
    mbar_init(&sm.own_full, 1);
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&sm.full[s], 32);
      mbar_init(&sm.empty[s], consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// m, l and di of rows row0 + lane and row0 + lane + 32 of one (batch,
// head), or 0, 1 and 0 past seq: six independent loads.
__device__ __forceinline__ void fetch_stats(float (&st)[2][3],
                                            const float* __restrict__ m,
                                            const float* __restrict__ l,
                                            const float* __restrict__ di,
                                            int row0, int seq, int lane) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int r = row0 + lane + 32 * k;
    const bool ok = r < seq;
    st[k][0] = ok ? m[r] : 0.f;
    st[k][1] = ok ? l[r] : 1.f;
    st[k][2] = ok ? di[r] : 0.f;
  }
}

// The producer warp of a backward block (slice bh).  Lane 0 loads the
// block's own rows once (own_a into own tensor 0, own_b into 1: Smem::
// kOwnBoxes boxes of 64 rows from own_row0), then every 64-row tile of the
// other side (ring_a, ring_b) through the Smem::kSlots slots of the ring;
// a row is Smem::kHalves boxes wide (kBoxCols floats each in f32, one box
// in bf16).  With Smem::kStats, the 32 lanes write m log2(e), 1/l and di
// of the tile's rows beside it, loaded a tile ahead so that their latency
// is not on the ring's path.
template <typename Smem>
__device__ __forceinline__ void produce(Smem& sm, const CUtensorMap* own_a,
                                        const CUtensorMap* own_b,
                                        const CUtensorMap* ring_a,
                                        const CUtensorMap* ring_b,
                                        const float* m, const float* l,
                                        const float* di, int bh,
                                        int own_row0, int seq) {
  constexpr int kSlots = Smem::kSlots, kHalves = Smem::kHalves;
  constexpr uint32_t kBoxBytes = Smem::kBoxBytes;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    mbar_arrive_expect_tx(&sm.own_full,
                          2 * Smem::kOwnBoxes * kHalves * kBoxBytes);
#pragma unroll
    for (int c = 0; c < Smem::kOwnBoxes; ++c) {
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf) {
        tma_load_rows(sm.own_box(0, c, hf), own_a, &sm.own_full,
                      own_row0 + c * kBox, bh, hf * kBoxCols);
        tma_load_rows(sm.own_box(1, c, hf), own_b, &sm.own_full,
                      own_row0 + c * kBox, bh, hf * kBoxCols);
      }
    }
  }
  const size_t srow = (size_t)bh * seq;
  const int tiles = (seq + kBox - 1) / kBox;
  float st[2][3];  // the statistics of the next tile
  if constexpr (Smem::kStats) {
    fetch_stats(st, m + srow, l + srow, di + srow, 0, seq, lane);
  }
  for (int it = 0; it < tiles; ++it) {
    const int s = it % kSlots, row0 = it * kBox;
    mbar_wait(&sm.empty[s], ((it / kSlots) & 1) ^ 1);  // slot released
    if (lane == 0) {
      mbar_expect_tx(&sm.full[s], 2 * kHalves * kBoxBytes);
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf) {
        tma_load_rows(sm.ring_box(0, s, hf), ring_a, &sm.full[s], row0, bh,
                      hf * kBoxCols);
        tma_load_rows(sm.ring_box(1, s, hf), ring_b, &sm.full[s], row0, bh,
                      hf * kBoxCols);
      }
    }
    if constexpr (Smem::kStats) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        sm.stats[s][0][lane + 32 * k] = st[k][0] * kLog2e;
        sm.stats[s][1][lane + 32 * k] = 1.f / st[k][1];
        sm.stats[s][2][lane + 32 * k] = st[k][2];
      }
    }
    // every lane releases its own stores of the statistics, then loads the
    // next tile's
    mbar_arrive(&sm.full[s]);
    if constexpr (Smem::kStats) {
      if (it + 1 < tiles) {
        fetch_stats(st, m + srow, l + srow, di + srow, row0 + kBox, seq,
                    lane);
      }
    }
  }
}

// dK and dV.  Block (b*h, key tile of 128 rows): two consumer warpgroups
// of 64 keys each, then the producer warp.
template <int D>
__global__ void __launch_bounds__(kRingThreads, 1)
    flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ m,
                           const float* __restrict__ l,
                           const float* __restrict__ di,
                           bf16_t* __restrict__ dk, bf16_t* __restrict__ dv,
                           int seq, float scale) {
  auto& sm = ring_smem<BwdSmem<D, true>>();
  init_barriers(sm);
  const int key0 = blockIdx.y * kOwnRows;
  const float scale2 = scale * kLog2e;
  if (threadIdx.x >= kConsumers * 128) {
    produce(sm, &tm_k, &tm_v, &tm_q, &tm_do, m, l, di, blockIdx.x, key0,
            seq);
  } else {
    const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const bf16_t* own_k = sm.own0 + wg * kBox * D;
    const bf16_t* own_v = sm.own1 + wg * kBox * D;
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(&sm.own_full, 0);
    const int tiles = (seq + kBox - 1) / kBox;
    for (int it = 0; it < tiles; ++it) {
      const int s = it % kStages, q0 = it * kBox;
      mbar_wait(&sm.full[s], (it / kStages) & 1);
      const bf16_t* tq = sm.ring0[s];
      const bf16_t* tdo = sm.ring1[s];
      // s^T = k q^T and dp^T = v dO^T: the warpgroup's 64 keys against the
      // tile's 64 queries, all operands K-major, issued together
      float pt[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        wgmma_ss_n64(pt, desc_k_major<D>(own_k, ks), desc_k_major<D>(tq, ks),
                     ks);
      }
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        wgmma_ss_n64(dpt, desc_k_major<D>(own_v, ks),
                     desc_k_major<D>(tdo, ks), ks);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(pt);
      fence_regs(dpt);
      // p^T: the accumulator's columns are queries, whose statistics the
      // producer put beside the tile
      const float* st_di = sm.stats[s][2];
      if (q0 + kBox <= seq) {
        probs_t<false>(pt, sm.stats[s][0], sm.stats[s][1], scale2, t, kBox);
      } else {
        probs_t<true>(pt, sm.stats[s][0], sm.stats[s][1], scale2, t,
                      seq - q0);
      }
      // ds^T = (dp^T - di) p^T scale; then p and ds rounded to bf16 in
      // registers, so that only dK, dV and the bf16 fragments stay live
      // while dV += p^T dO and dK += ds^T q run (dO and q read MN-major)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + 2 * t + (e & 1);
          dpt[4 * j + e] =
              (dpt[4 * j + e] - st_di[qi]) * pt[4 * j + e] * scale;
        }
      }
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        acc_to_a(pa[kc], pt, kc);
        acc_to_a(da[kc], dpt, kc);
      }
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        wgmma_rs(dv_acc, pa[kc], desc_mn_major<D>(tdo, kc));
        wgmma_rs(dk_acc, da[kc], desc_mn_major<D>(tq, kc));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      mbar_arrive(&sm.empty[s]);  // this thread is done with the slot
    }
    const size_t base = (size_t)blockIdx.x * seq * D;
    const int row0 = key0 + wg * kBox + warp * 16;
    store_acc_bf16<D>(dk + base, dk_acc, row0, seq, g, t);
    store_acc_bf16<D>(dv + base, dv_acc, row0, seq, g, t);
  }
}

// dQ.  Block (b*h, query tile of 128 rows): two consumer warpgroups of 64
// queries each, then the producer warp.  `unused` keeps the dK/dV
// kernel's signature.
template <int D>
__global__ void __launch_bounds__(kRingThreads, 1)
    flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ m,
                          const float* __restrict__ l,
                          const float* __restrict__ di,
                          bf16_t* __restrict__ dq, bf16_t* __restrict__ unused,
                          int seq, float scale) {
  auto& sm = ring_smem<BwdSmem<D, false>>();
  init_barriers(sm);
  const int qblk0 = blockIdx.y * kOwnRows;
  const float scale2 = scale * kLog2e;
  if (threadIdx.x >= kConsumers * 128) {
    produce(sm, &tm_q, &tm_do, &tm_k, &tm_v, m, l, di, blockIdx.x, qblk0,
            seq);
  } else {
    const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const size_t srow = (size_t)blockIdx.x * seq;
    const int row0 = qblk0 + wg * kBox + warp * 16;
    float rm2[2], rlinv[2], rdi[2];  // rows row0 + g and row0 + g + 8
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + g + 8 * i;
      rm2[i] = r < seq ? m[srow + r] * kLog2e : 0.f;
      rlinv[i] = r < seq ? 1.f / l[srow + r] : 1.f;
      rdi[i] = r < seq ? di[srow + r] : 0.f;
    }
    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
    const bf16_t* own_q = sm.own0 + wg * kBox * D;
    const bf16_t* own_do = sm.own1 + wg * kBox * D;
    mbar_wait(&sm.own_full, 0);
    const int tiles = (seq + kBox - 1) / kBox;
    for (int it = 0; it < tiles; ++it) {
      const int s = it % kStages, k0 = it * kBox;
      mbar_wait(&sm.full[s], (it / kStages) & 1);
      const bf16_t* tk = sm.ring0[s];
      const bf16_t* tv = sm.ring1[s];
      // s = q k^T and dp = dO v^T, all operands K-major, issued together
      float sc[32], ds[32];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        wgmma_ss_n64(sc, desc_k_major<D>(own_q, ks), desc_k_major<D>(tk, ks),
                     ks);
      }
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        wgmma_ss_n64(ds, desc_k_major<D>(own_do, ks), desc_k_major<D>(tv, ks),
                     ks);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(ds);
      if (k0 + kBox <= seq) {
        grad_scores<false>(ds, sc, rm2, rlinv, rdi, scale2, scale, t, kBox);
      } else {
        grad_scores<true>(ds, sc, rm2, rlinv, rdi, scale2, scale, t,
                          seq - k0);
      }
      // dQ += ds k: ds rounded to bf16 in registers, k read MN-major
      uint32_t da[4][4];
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) acc_to_a(da[kc], ds, kc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        wgmma_rs(dq_acc, da[kc], desc_mn_major<D>(tk, kc));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq_acc);
      mbar_arrive(&sm.empty[s]);
    }
    store_acc_bf16<D>(dq + (size_t)blockIdx.x * seq * D, dq_acc, row0, seq, g,
                      t);
  }
  (void)unused;
}

// ------------------------------------------------------------ bf16 forward

// Shared memory of the forward: the block's 128 query rows, and a ring of
// kStages slots, each a 64-row k tile and its v tile.
template <int D>
struct FwdSmem {
  bf16_t q[kOwnRows * D];
  bf16_t k[kStages][kBox * D];
  bf16_t v[kStages][kBox * D];
  uint64_t own_full, full[kStages], empty[kStages];
};

// One key tile of the online softmax, for the thread's two rows.  In place,
// the raw scores q.k become p = 2^(s scale log2(e) - m log2(e)), with m the
// running row max of s scale in natural units (what the backward reads;
// keys from `valid` on count as -inf when Masked); alpha = 2^((m_old - m)
// log2(e)) rescales what was summed before, and lsum, the thread's share
// of l, is rescaled and takes the tile's p.
template <bool Masked>
__device__ __forceinline__ void online_softmax(float (&sc)[32],
                                               float (&mx)[2],
                                               float (&lsum)[2],
                                               float (&alpha)[2],
                                               float scale, int t,
                                               int valid) {
  float tmax[2] = {mx[0], mx[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * t + (e & 1);
      const float x =
          Masked && col >= valid ? -INFINITY : sc[4 * j + e] * scale;
      sc[4 * j + e] = x;
      tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
    }
  }
  float m2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // each tile holds a key < seq, so the new max is finite
    const float mn = quad_max(tmax[i]);
    alpha[i] = exp2_approx((mx[i] - mn) * kLog2e);  // 0 on the first tile
    mx[i] = mn;
    m2[i] = mn * kLog2e;
  }
  float tsum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_approx(fmaf(sc[4 * j + e], kLog2e, -m2[e >> 1]));
      sc[4 * j + e] = p;
      tsum[e >> 1] += p;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) lsum[i] = fmaf(lsum[i], alpha[i], tsum[i]);
}

// The forward.  Block (query tile of 128 rows, b*h), flattened with the
// query tile fastest, so that the blocks of one head run together and share
// its k and v in L2: two consumer warpgroups of 64 queries each, then the
// producer warp.
template <int D>
__global__ void __launch_bounds__(kRingThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           bf16_t* __restrict__ o, float* __restrict__ m_out,
                           float* __restrict__ l_out, int seq, float scale) {
  constexpr uint32_t kTileBytes = kBox * D * sizeof(bf16_t);
  auto& sm = ring_smem<FwdSmem<D>>();
  init_barriers(sm);
  const int q_tiles = (seq + kOwnRows - 1) / kOwnRows;
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kOwnRows;
  const int tiles = (seq + kBox - 1) / kBox;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= kConsumers * 128) {
    // the producer: q once, then every k and v tile through the ring; lane
    // 0 issues the copies, and all 32 lanes arrive on full[s]
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.own_full, kConsumers * kTileBytes);
#pragma unroll
      for (int c = 0; c < kConsumers; ++c) {
        tma_load_rows(sm.q + c * kBox * D, &tm_q, &sm.own_full,
                      q0 + c * kBox, bh);
      }
    }
    for (int it = 0; it < tiles; ++it) {
      const int s = it % kStages;
      mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);  // slot released
      if (lane == 0) {
        mbar_expect_tx(&sm.full[s], 2 * kTileBytes);
        tma_load_rows(sm.k[s], &tm_k, &sm.full[s], it * kBox, bh);
        tma_load_rows(sm.v[s], &tm_v, &sm.full[s], it * kBox, bh);
      }
      mbar_arrive(&sm.full[s]);
    }
    return;
  }
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int g = lane >> 2, t = lane & 3;
  const bf16_t* own_q = sm.q + wg * kBox * D;
  float o_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
  float mx[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
  mbar_wait(&sm.own_full, 0);
  for (int it = 0; it < tiles; ++it) {
    const int s = it % kStages, k0 = it * kBox;
    mbar_wait(&sm.full[s], (it / kStages) & 1);
    // s = q k^T: the warpgroup's 64 queries against the tile's 64 keys,
    // both operands K-major
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      wgmma_ss_n64(sc, desc_k_major<D>(own_q, ks),
                   desc_k_major<D>(sm.k[s], ks), ks);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    float alpha[2];
    if (k0 + kBox <= seq) {
      online_softmax<false>(sc, mx, lsum, alpha, scale, t, kBox);
    } else {
      online_softmax<true>(sc, mx, lsum, alpha, scale, t, seq - k0);
    }
    // o = o alpha + p v: p rounded to bf16 in registers, as the stock
    // kernel rounds it, and v read MN-major
    uint32_t pa[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) acc_to_a(pa[kc], sc, kc);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o_acc[4 * j] *= alpha[0];
      o_acc[4 * j + 1] *= alpha[0];
      o_acc[4 * j + 2] *= alpha[1];
      o_acc[4 * j + 3] *= alpha[1];
    }
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      wgmma_rs(o_acc, pa[kc], desc_mn_major<D>(sm.v[s], kc));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o_acc);
    mbar_arrive(&sm.empty[s]);  // this thread is done with the slot
  }
  // o = acc / l, and the statistics m and l of rows row0 + g, row0 + g + 8
  float l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = quad_sum(lsum[i]);
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o_acc[4 * j] *= inv0;
    o_acc[4 * j + 1] *= inv0;
    o_acc[4 * j + 2] *= inv1;
    o_acc[4 * j + 3] *= inv1;
  }
  const int row0 = q0 + wg * kBox + warp * 16;
  store_acc_bf16<D>(o + (size_t)bh * seq * D, o_acc, row0, seq, g, t);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + g + 8 * i;
      if (r < seq) {
        m_out[(size_t)bh * seq + r] = mx[i];
        l_out[(size_t)bh * seq + r] = l[i];
      }
    }
  }
}

// ----------------------------------- f32 forward: 3xTF32, tensor cores
//
// Each f32 operand x is split into two tf32 values, big = tf32(x) and small
// = tf32(x - big), and a product a b is summed as a_small b_big + a_big
// b_small + a_big b_big in an f32 accumulator: three tf32 passes (3xTF32)
// on the tensor cores.  Only terms of about 2^-22 of a b are dropped
// (a_small b_small, small's own rounding), so the result keeps f32's digits
// (one tf32 pass keeps about 11 bits).  torch's allow_tf32 flags do not
// reach this kernel; its precision is fixed here.
//   k and v are TMA boxes of 64 rows by 32 floats (one 128-byte line a
// row), written with the 128-byte swizzle: float4 chunk c of row r lands at
// chunk c ^ (r mod 8).  The fragment loads below are 16-byte loads that
// touch 32 distinct banks in each quarter warp.

// x rounded to tf32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero; f32 bits with the low 13 zero), in two integer operations of
// full rate: half a tf32 ulp added to the magnitude, the low bits cleared.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, two tf32 values: big rounded to nearest, small (exact
// in f32 as x - big) truncated to tf32, one AND, which moves the product
// by at most 2^-22 of it, as the dropped small x small does.  (Rounding
// small as well kept the same accuracy and cost 4-6 % of the kernel's
// time on the H100; PERF.md.)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

// d += a b: A 16 x 8 (row), B 8 x 8 (col), tf32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four f32 values (an A fragment's a0..a3) split into big and small tf32.
__device__ __forceinline__ void split_a(const float (&x)[4],
                                        uint32_t (&big)[4],
                                        uint32_t (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(x[i], big[i], small[i]);
}

// d += a b in three tf32 passes, the small terms first, from the big and
// small parts of A (ab, as) and of the thread's two B elements (b0b, b1b;
// b0s, b1s).
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           uint32_t b0b, uint32_t b1b,
                                           uint32_t b0s, uint32_t b1s) {
  mma_tf32(d, as, b0b, b1b);
  mma_tf32(d, ab, b0s, b1s);
  mma_tf32(d, ab, b0b, b1b);
}

// The same with B's two elements in f32, split here.
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], float b0,
                                           float b1) {
  uint32_t b0b, b0s, b1b, b1s;
  split_tf32(b0, b0b, b0s);
  split_tf32(b1, b1b, b1s);
  mma_3xtf32(d, ab, as, b0b, b1b, b0s, b1s);
}

// Float4 chunk c (floats 4c..4c+3) of row r of a swizzled 64 x 32 box.
__device__ __forceinline__ float4 box_chunk(const float* box, int r, int c) {
  return *reinterpret_cast<const float4*>(box + r * kBoxCols +
                                          ((c ^ (r & 7)) << 2));
}

// Shared memory of the f32 forward: the block's 128 query rows and a ring
// of kStages slots, each a 64-row k tile and its v tile; every tile is D/32
// boxes of 64 x 32 floats (8 KB, 1024-byte aligned, as the swizzle wants).
constexpr int kF32Stages = 3;  // with q's and k's small planes, 4 slots
                               // would pass the 227 KB a block may hold
template <int D>
struct F32FwdSmem {
  float q[kConsumers][D / kBoxCols][kBox * kBoxCols];   // q's big part
  float qs[kConsumers][D / kBoxCols][kBox * kBoxCols];  // q's small part
  float k[kF32Stages][D / kBoxCols][kBox * kBoxCols];   // k's big part
  float ks[kF32Stages][D / kBoxCols][kBox * kBoxCols];  // k's small part
  float v[kF32Stages][D / kBoxCols][kBox * kBoxCols];
  uint64_t own_full, full[kF32Stages], empty[kF32Stages];
};

// Split n float4s at `x` in place into big (tf32, rounded), with small,
// x - big truncated to tf32, into `small`: this thread's share of the
// Threads consumer threads (threads 0 .. Threads - 1 of the block).
template <int Threads = kConsumers * 128>
__device__ __forceinline__ void split_planes(float4* x, float4* small,
                                             int n) {
  for (int i = threadIdx.x; i < n; i += Threads) {
    const float v[4] = {x[i].x, x[i].y, x[i].z, x[i].w};
    uint32_t b[4], l[4];
    split_a(v, b, l);
    x[i] = make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]),
                       __uint_as_float(b[2]), __uint_as_float(b[3]));
    small[i] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                           __uint_as_float(l[2]), __uint_as_float(l[3]));
  }
  // the stores reach wgmma's reads (the async proxy), then every consumer
  // has split its share
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(Threads) : "memory");
}

// The tf32 tile (a 64 x 32 box of k, 128-byte swizzle) as a K-major wgmma
// operand at k-step kk of its 4 (8 floats, 32 bytes, each): 8-row atoms
// 1024 bytes apart; the leading offset is unused under the swizzle.
__device__ __forceinline__ uint64_t desc_tf32(const float* box, int kk) {
  return gmma_desc<64>(smem_u32(box) + 32 * kk, 16, 1024);
}

// d (64 x 64, f32) (+)= A B, tf32: A 64 x 8 and B 8 x 64, both K-major in
// shared memory; d is overwritten when `accumulate` is 0.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The f32 forward.  Blocks, ring (3 slots) and online softmax as in the
// bf16 forward (flash_fwd_wgmma_kernel): two consumer warpgroups of 64
// query rows, 16 a warp.  Fragment layout (lane = 4 g + t): the
// accumulator of a 16 x 8 product holds rows g and g + 8, columns 2t and
// 2t + 1; the A fragment rows g and g + 8 at reduction slots t and t + 4;
// the B fragment column g at slots t and t + 4.
//   s = q k^T   wgmma m64n64k8, tf32, both operands K-major in shared
//               memory: q (once) and each k tile split once a block, each
//               consumer thread its share, big written back in place and
//               small into a plane beside it.  The accumulator is laid out
//               as the bf16 forward's, and the same online_softmax runs on
//               it.
//   o += p v    mma.sync m16n8k8, since wgmma takes tf32 only K-major and v
//               is [keys, D].  The reduction order is free: the k-step j
//               (keys 8j..8j+7) maps slot t to key 8j + 2t and slot t + 4
//               to 8j + 2t + 1, so p's A fragment is the accumulator's four
//               values of n-block j, reordered, with no shuffle; B column g
//               of the n-block (hf, c) is output column 32 hf + 4g + c, so
//               lane g reads chunk g of the two key rows as float4s and
//               splits them.  The thread's o then holds columns 32 hf + 8t
//               .. + 7 of its two rows, stored as float4s.  Each tile's p v
//               sums in a fresh accumulator and is added to o by an FMA
//               with the rescale: summed over every tile in the tensor
//               cores' accumulator, o drifted to 7.5e-6 of max(1, |o|) at S
//               = 4096, f32's plain matmul 0.4e-6 (H100, PERF.md).
// p is split after the online softmax, unnormalised, and o is divided by l
// at the end.  What the card showed (H100; PERF.md has the times): s on
// mma.sync too, with k split by every warp, took 8 % longer at the
// encoder's shape and 20 % at S = 4096; persistent blocks walking the
// (b*h, query tile) items gained 12 % up to S = 128 and lost 2-4 % from
// S = 2048, so blocks stay one an item.
template <int D>
__global__ void __launch_bounds__(kRingThreads, 1)
    flash_fwd_tf32x3_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            float* __restrict__ o, float* __restrict__ m_out,
                            float* __restrict__ l_out, int seq, float scale) {
  constexpr int kHalves = D / kBoxCols;
  constexpr uint32_t kBoxBytes = kBox * kBoxCols * sizeof(float);
  auto& sm = ring_smem<F32FwdSmem<D>>();
  init_barriers(sm);
  const int q_tiles = (seq + kOwnRows - 1) / kOwnRows;
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kOwnRows;
  const int tiles = (seq + kBox - 1) / kBox;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= kConsumers * 128) {
    // the producer: q once, then every k and v tile through the ring; lane
    // 0 issues the copies, and all 32 lanes arrive on full[s]
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.own_full, kConsumers * kHalves * kBoxBytes);
#pragma unroll
      for (int c = 0; c < kConsumers; ++c) {
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf) {
          tma_load_rows(sm.q[c][hf], &tm_q, &sm.own_full, q0 + c * kBox, bh,
                        hf * kBoxCols);
        }
      }
    }
    for (int it = 0; it < tiles; ++it) {
      const int s = it % kF32Stages;
      mbar_wait(&sm.empty[s], ((it / kF32Stages) & 1) ^ 1);  // released
      if (lane == 0) {
        mbar_expect_tx(&sm.full[s], 2 * kHalves * kBoxBytes);
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf) {
          tma_load_rows(sm.k[s][hf], &tm_k, &sm.full[s], it * kBox, bh,
                        hf * kBoxCols);
          tma_load_rows(sm.v[s][hf], &tm_v, &sm.full[s], it * kBox, bh,
                        hf * kBoxCols);
        }
      }
      mbar_arrive(&sm.full[s]);
    }
    return;
  }
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int g = lane >> 2, t = lane & 3;
  // q split once a block, big in place and small beside it, for wgmma to
  // read from shared memory
  constexpr int kTileVecs = kHalves * kBox * kBoxCols / 4;  // float4s a tile
  mbar_wait(&sm.own_full, 0);
  split_planes(reinterpret_cast<float4*>(&sm.q[0][0][0]),
               reinterpret_cast<float4*>(&sm.qs[0][0][0]),
               kConsumers * kTileVecs);
  float o_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
  float mx[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
  for (int it = 0; it < tiles; ++it) {
    const int s = it % kF32Stages, k0 = it * kBox;
    mbar_wait(&sm.full[s], (it / kF32Stages) & 1);
    // the tile's k split once a block, as q
    split_planes(reinterpret_cast<float4*>(&sm.k[s][0][0]),
                 reinterpret_cast<float4*>(&sm.ks[s][0][0]), kTileVecs);
    // s = q k^T: the warpgroup's 64 queries against the tile's 64 keys,
    // three wgmma passes a k-step, small terms first
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      const uint64_t qb = desc_tf32(sm.q[wg][ks / 4], ks % 4);
      const uint64_t ql = desc_tf32(sm.qs[wg][ks / 4], ks % 4);
      const uint64_t kb = desc_tf32(sm.k[s][ks / 4], ks % 4);
      const uint64_t kl = desc_tf32(sm.ks[s][ks / 4], ks % 4);
      wgmma_tf32(sc, ql, kb, ks);
      wgmma_tf32(sc, qb, kl, 1);
      wgmma_tf32(sc, qb, kb, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    float alpha[2];
    if (k0 + kBox <= seq) {
      online_softmax<false>(sc, mx, lsum, alpha, scale, t, kBox);
    } else {
      online_softmax<true>(sc, mx, lsum, alpha, scale, t, seq - k0);
    }
    float o_t[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_t[i] = 0.f;
    // o += p v, p unnormalised in f32, split like any operand
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t pb[4], ps[4];
      const float pa[4] = {sc[4 * j], sc[4 * j + 2], sc[4 * j + 1],
                           sc[4 * j + 3]};
      split_a(pa, pb, ps);
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf) {
        const float4 ve = box_chunk(sm.v[s][hf], 8 * j + 2 * t, g);
        const float4 vo = box_chunk(sm.v[s][hf], 8 * j + 2 * t + 1, g);
        float* acc = o_t + 16 * hf;
        mma_3xtf32(acc, pb, ps, ve.x, vo.x);
        mma_3xtf32(acc + 4, pb, ps, ve.y, vo.y);
        mma_3xtf32(acc + 8, pb, ps, ve.z, vo.z);
        mma_3xtf32(acc + 12, pb, ps, ve.w, vo.w);
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o_acc[4 * j] = fmaf(o_acc[4 * j], alpha[0], o_t[4 * j]);
      o_acc[4 * j + 1] = fmaf(o_acc[4 * j + 1], alpha[0], o_t[4 * j + 1]);
      o_acc[4 * j + 2] = fmaf(o_acc[4 * j + 2], alpha[1], o_t[4 * j + 2]);
      o_acc[4 * j + 3] = fmaf(o_acc[4 * j + 3], alpha[1], o_t[4 * j + 3]);
    }
    mbar_arrive(&sm.empty[s]);  // this thread is done with the slot
  }
  // o = acc / l, and the statistics m and l of rows row0 + g, row0 + g + 8
  float l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = quad_sum(lsum[i]);
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  const int row0 = q0 + wg * kBox + warp * 16;
  float* ob = o + (size_t)bh * seq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    if (r >= seq) continue;
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf) {
      const float* acc = o_acc + 16 * hf + 2 * i;  // n-blocks 4hf..4hf+3
      float* dst = ob + (size_t)r * D + hf * kBoxCols + 8 * t;
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[0] * inv[i], acc[4] * inv[i], acc[8] * inv[i],
                      acc[12] * inv[i]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(acc[1] * inv[i], acc[5] * inv[i], acc[9] * inv[i],
                      acc[13] * inv[i]);
    }
    if (t == 0) {
      m_out[(size_t)bh * seq + r] = mx[i];
      l_out[(size_t)bh * seq + r] = l[i];
    }
  }
}

// ---------------------------------- f32 backward: 3xTF32, tensor cores
//
// The bf16 backward's blocks, producer and ring (produce) with the f32
// forward's arithmetic: every product in three tf32 passes, from operands
// split once a block into big planes (in place) and small planes in shared
// memory.  Products whose operands are both K-major run on wgmma m64n64k8
// (dK/dV: s^T = k q^T, dp^T = v dO^T; dQ: s = q k^T, dp = dO v^T); those
// whose B is MN-major (dV += p^T dO, dK += ds^T q, dQ += ds k) on mma.sync
// m16n8k8, with A the wgmma accumulator (p^T, ds^T or ds, in f32, not
// rounded: split like any operand) and B read from the tile's planes, which
// are already split.
//   Shared memory binds the layout: the own rows' planes take 64 KB a
// consumer warpgroup (64 rows) at D = 64 and one ring slot (two tiles,
// each in two planes) 64 KB, against the 227 KB a block may hold: one
// warpgroup and 2 slots, or two and 1 slot, 193 KB either way.  Both
// kernels take one warpgroup and 2 slots, a block of 160 threads, whose
// consumers may hold 255 registers: dK/dV keeps dK, dV, s^T, dp^T and a
// tile's fresh accumulator live (238 registers at D = 64), dQ takes 183.
// Two warpgroups (kOwnBoxes = 2, kSlots = 1) made dQ 11-21 % faster at the
// encoder's and the crossover shapes, but a block of 288 threads caps a
// thread at 168 registers and dQ spilled 12-28 bytes (H100, PERF.md).
// Blocks are numbered with the own tile fastest, so a head's blocks run
// together and share its streamed tiles in L2.

// Shared memory of the f32 backward kernels: the block's own rows (dK/dV:
// k and v; dQ: q and dO) and the ring's tiles (dK/dV: q and dO; dQ: k and
// v), each 64 rows of D/32 boxes of 64 x 32 floats (128-byte swizzle),
// with a small plane beside each; and, with Stats (dK/dV), m log2(e), 1/l
// and di of each slot's queries.
template <int D, bool Stats>
struct F32BwdSmem {
  static constexpr int kOwnBoxes = 1;  // consumer warpgroups
  static constexpr int kSlots = 2;
  static constexpr int kConsumerThreads = kOwnBoxes * 128;
  static constexpr int kThreads = kConsumerThreads + 32;  // and the producer
  static constexpr int kOwnRows = kOwnBoxes * kBox;
  static constexpr int kHalves = D / kBoxCols;
  static constexpr bool kStats = Stats;
  static constexpr uint32_t kBoxBytes = kBox * kBoxCols * sizeof(float);
  using Tile = float[kHalves][kBox * kBoxCols];  // 64 rows of D floats
  Tile own[2][kOwnBoxes], own_s[2][kOwnBoxes];   // big (in place), small
  Tile ring[kSlots][2], ring_s[kSlots][2];
  float stats[Stats ? kSlots : 1][3][kBox];      // m log2(e), 1/l, di
  uint64_t own_full, full[kSlots], empty[kSlots];
  __device__ float* own_box(int i, int c, int hf) { return own[i][c][hf]; }
  __device__ float* ring_box(int i, int s, int hf) { return ring[s][i][hf]; }
};

// d (+)= A B^T over k-step kk (8 columns) of two 64 x 32 boxes, A's (a, as)
// and B's (b, bs) big and small planes, in three tf32 passes, the small
// terms first; d is overwritten when `accumulate` is 0.
__device__ __forceinline__ void wgmma_3xtf32(float (&d)[32], const float* a,
                                             const float* as, const float* b,
                                             const float* bs, int kk,
                                             int accumulate) {
  const uint64_t ab = desc_tf32(a, kk), bb = desc_tf32(b, kk);
  wgmma_tf32(d, desc_tf32(as, kk), bb, accumulate);
  wgmma_tf32(d, ab, desc_tf32(bs, kk), 1);
  wgmma_tf32(d, ab, bb, 1);
}

// Store a warp's 16 x D rows of an f32 accumulator of mma.sync n-blocks
// laid out as the f32 kernels keep it (n-block (hf, c) of the thread's
// rows in acc[16 hf + 4 c ..]: columns 32 hf + 8 t + c and 32 hf + 8 t + 4
// + c) as rows row0 + g + 8 i of `out` ([seq, D]); rows past seq are
// skipped.  Two float4 stores a row and half.
template <int D>
__device__ __forceinline__ void store_rows_f32(float* out,
                                               const float (&acc)[D / 2],
                                               int row0, int seq, int g,
                                               int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    if (r >= seq) continue;
#pragma unroll
    for (int hf = 0; hf < D / kBoxCols; ++hf) {
      const float* a = acc + 16 * hf + 2 * i;
      float* dst = out + (size_t)r * D + hf * kBoxCols + 8 * t;
      *reinterpret_cast<float4*>(dst) = make_float4(a[0], a[4], a[8], a[12]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(a[1], a[5], a[9], a[13]);
    }
  }
}

// out += A B for one 64-row tile of B, in three tf32 passes by mma.sync
// m16n8k8: A the warp's 16 x 64 wgmma accumulator a (rows g and g + 8,
// columns 8j + 2t and 8j + 2t + 1 in a[4j..4j+3]), B the tile's [64, D]
// rows from their big and small planes (bb, bs: D/32 swizzled boxes).  The
// reduction order is free, so k-step j (rows 8j..8j+7) maps slot t to row
// 8j + 2t and slot t + 4 to 8j + 2t + 1: A's fragment is a's four values of
// n-block j, reordered, with no shuffle.  B column g of the n-block (hf, c)
// is output column 32 hf + 4 g + c, so lane g reads chunk g of the two rows
// as float4s, free of bank conflicts, from each plane.  The tile's products
// are summed in a fresh accumulator and then added to out (laid out as
// store_rows_f32 reads it): summed over every tile in the tensor cores'
// accumulator, the f32 forward's o drifted to 7.5e-6 of max(1, |o|) at S =
// 4096 (H100, PERF.md).
template <int D>
__device__ __forceinline__ void add_rows_3xtf32(
    float (&out)[D / 2], const float (&a)[32],
    const float (*bb)[kBox * kBoxCols], const float (*bs)[kBox * kBoxCols],
    int t, int g) {
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t ab[4], as[4];
    const float aj[4] = {a[4 * j], a[4 * j + 2], a[4 * j + 1],
                         a[4 * j + 3]};
    split_a(aj, ab, as);
    const int r = 8 * j + 2 * t;
#pragma unroll
    for (int hf = 0; hf < D / kBoxCols; ++hf) {
      const float4 be = box_chunk(bb[hf], r, g);
      const float4 bo = box_chunk(bb[hf], r + 1, g);
      const float4 se = box_chunk(bs[hf], r, g);
      const float4 so = box_chunk(bs[hf], r + 1, g);
      float* d = acc + 16 * hf;
      mma_3xtf32(d, ab, as, __float_as_uint(be.x), __float_as_uint(bo.x),
                 __float_as_uint(se.x), __float_as_uint(so.x));
      mma_3xtf32(d + 4, ab, as, __float_as_uint(be.y), __float_as_uint(bo.y),
                 __float_as_uint(se.y), __float_as_uint(so.y));
      mma_3xtf32(d + 8, ab, as, __float_as_uint(be.z), __float_as_uint(bo.z),
                 __float_as_uint(se.z), __float_as_uint(so.z));
      mma_3xtf32(d + 12, ab, as, __float_as_uint(be.w),
                 __float_as_uint(bo.w), __float_as_uint(se.w),
                 __float_as_uint(so.w));
    }
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) out[i] += acc[i];
}

// dK and dV in f32.  Block (b*h, key tile of 64 rows), flattened with the
// key tile fastest: one consumer warpgroup, then the producer warp.
//   s^T = k q^T, dp^T = v dO^T   wgmma, three passes a k-step
//   p^T = exp(s^T scale - m) / l (0 for queries past seq: the producer
//         wrote m = 0 and 1/l = 1 there), ds^T = (dp^T - di) p^T scale
//   dV += p^T dO, dK += ds^T q   mma.sync (add_rows_3xtf32)
template <int D>
__global__ void __launch_bounds__(F32BwdSmem<D, true>::kThreads, 1)
    flash_dkv_tf32x3_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do,
                            const float* __restrict__ m,
                            const float* __restrict__ l,
                            const float* __restrict__ di,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int seq, float scale) {
  using Smem = F32BwdSmem<D, true>;
  constexpr int kTileVecs = D * kBox / 4;  // float4s a tile
  constexpr int kThreads = Smem::kConsumerThreads;
  auto& sm = ring_smem<Smem>();
  init_barriers(sm, kThreads);
  const int own_tiles = (seq + Smem::kOwnRows - 1) / Smem::kOwnRows;
  const int bh = blockIdx.x / own_tiles;
  const int key0 = (blockIdx.x % own_tiles) * Smem::kOwnRows;
  if (threadIdx.x >= kThreads) {
    produce(sm, &tm_k, &tm_v, &tm_q, &tm_do, m, l, di, bh, key0, seq);
    return;
  }
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float scale2 = scale * kLog2e;
  // k and v split once a block, big in place and small beside it
  mbar_wait(&sm.own_full, 0);
  split_planes<kThreads>(reinterpret_cast<float4*>(&sm.own[0][0][0][0]),
                         reinterpret_cast<float4*>(&sm.own_s[0][0][0][0]),
                         2 * Smem::kOwnBoxes * kTileVecs);
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const int tiles = (seq + kBox - 1) / kBox;
  for (int it = 0; it < tiles; ++it) {
    const int s = it % Smem::kSlots, q0 = it * kBox;
    mbar_wait(&sm.full[s], (it / Smem::kSlots) & 1);
    // the tile's q and dO split once a block, as k and v
    split_planes<kThreads>(reinterpret_cast<float4*>(&sm.ring[s][0][0][0]),
                           reinterpret_cast<float4*>(&sm.ring_s[s][0][0][0]),
                           2 * kTileVecs);
    // s^T and dp^T: the warpgroup's 64 keys against the tile's 64 queries
    float pt[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      wgmma_3xtf32(pt, sm.own[0][wg][ks / 4], sm.own_s[0][wg][ks / 4],
                   sm.ring[s][0][ks / 4], sm.ring_s[s][0][ks / 4], ks % 4, ks);
    }
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      wgmma_3xtf32(dpt, sm.own[1][wg][ks / 4], sm.own_s[1][wg][ks / 4],
                   sm.ring[s][1][ks / 4], sm.ring_s[s][1][ks / 4], ks % 4,
                   ks);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(pt);
    fence_regs(dpt);
    // p^T: the accumulator's columns are queries, whose statistics the
    // producer put beside the tile
    const float* st_di = sm.stats[s][2];
    if (q0 + kBox <= seq) {
      probs_t<false>(pt, sm.stats[s][0], sm.stats[s][1], scale2, t, kBox);
    } else {
      probs_t<true>(pt, sm.stats[s][0], sm.stats[s][1], scale2, t,
                    seq - q0);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * t + (e & 1);
        dpt[4 * j + e] = (dpt[4 * j + e] - st_di[qi]) * pt[4 * j + e] * scale;
      }
    }
    add_rows_3xtf32<D>(dv_acc, pt, sm.ring[s][1], sm.ring_s[s][1], t, g);
    add_rows_3xtf32<D>(dk_acc, dpt, sm.ring[s][0], sm.ring_s[s][0], t, g);
    mbar_arrive(&sm.empty[s]);  // this thread is done with the slot
  }
  const size_t base = (size_t)bh * seq * D;
  const int row0 = key0 + wg * kBox + warp * 16;
  store_rows_f32<D>(dk + base, dk_acc, row0, seq, g, t);
  store_rows_f32<D>(dv + base, dv_acc, row0, seq, g, t);
}

// dQ in f32.  Block (b*h, query tile of 64 rows), flattened with the query
// tile fastest: one consumer warpgroup, then the producer warp.
//   s = q k^T, dp = dO v^T   wgmma, three passes a k-step
//   ds = (dp - di) p scale, p = exp(s scale - m) / l (0 for keys past seq),
//        with m, 1/l and di of the thread's two rows in registers
//   dQ += ds k               mma.sync (add_rows_3xtf32)
// `unused` keeps the dK/dV kernel's signature.
template <int D>
__global__ void __launch_bounds__(F32BwdSmem<D, false>::kThreads, 1)
    flash_dq_tf32x3_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ m,
                           const float* __restrict__ l,
                           const float* __restrict__ di,
                           float* __restrict__ dq, float* __restrict__ unused,
                           int seq, float scale) {
  using Smem = F32BwdSmem<D, false>;
  constexpr int kTileVecs = D * kBox / 4;
  constexpr int kThreads = Smem::kConsumerThreads;
  auto& sm = ring_smem<Smem>();
  init_barriers(sm, kThreads);
  const int own_tiles = (seq + Smem::kOwnRows - 1) / Smem::kOwnRows;
  const int bh = blockIdx.x / own_tiles;
  const int qblk0 = (blockIdx.x % own_tiles) * Smem::kOwnRows;
  if (threadIdx.x >= kThreads) {
    produce(sm, &tm_q, &tm_do, &tm_k, &tm_v, m, l, di, bh, qblk0, seq);
    return;
  }
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float scale2 = scale * kLog2e;
  const size_t srow = (size_t)bh * seq;
  const int row0 = qblk0 + wg * kBox + warp * 16;
  float rm2[2], rlinv[2], rdi[2];  // rows row0 + g and row0 + g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    rm2[i] = r < seq ? m[srow + r] * kLog2e : 0.f;
    rlinv[i] = r < seq ? 1.f / l[srow + r] : 1.f;
    rdi[i] = r < seq ? di[srow + r] : 0.f;
  }
  // q and dO split once a block, big in place and small beside it
  mbar_wait(&sm.own_full, 0);
  split_planes<kThreads>(reinterpret_cast<float4*>(&sm.own[0][0][0][0]),
                         reinterpret_cast<float4*>(&sm.own_s[0][0][0][0]),
                         2 * Smem::kOwnBoxes * kTileVecs);
  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
  const int tiles = (seq + kBox - 1) / kBox;
  for (int it = 0; it < tiles; ++it) {
    const int s = it % Smem::kSlots, k0 = it * kBox;
    mbar_wait(&sm.full[s], (it / Smem::kSlots) & 1);
    // the tile's k and v split once a block, as q and dO
    split_planes<kThreads>(reinterpret_cast<float4*>(&sm.ring[s][0][0][0]),
                           reinterpret_cast<float4*>(&sm.ring_s[s][0][0][0]),
                           2 * kTileVecs);
    // s and dp: the warpgroup's 64 queries against the tile's 64 keys
    float sc[32], ds[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      wgmma_3xtf32(sc, sm.own[0][wg][ks / 4], sm.own_s[0][wg][ks / 4],
                   sm.ring[s][0][ks / 4], sm.ring_s[s][0][ks / 4], ks % 4, ks);
    }
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      wgmma_3xtf32(ds, sm.own[1][wg][ks / 4], sm.own_s[1][wg][ks / 4],
                   sm.ring[s][1][ks / 4], sm.ring_s[s][1][ks / 4], ks % 4,
                   ks);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(ds);
    if (k0 + kBox <= seq) {
      grad_scores<false>(ds, sc, rm2, rlinv, rdi, scale2, scale, t, kBox);
    } else {
      grad_scores<true>(ds, sc, rm2, rlinv, rdi, scale2, scale, t,
                        seq - k0);
    }
    add_rows_3xtf32<D>(dq_acc, ds, sm.ring[s][0], sm.ring_s[s][0], t, g);
    mbar_arrive(&sm.empty[s]);
  }
  store_rows_f32<D>(dq + srow * D, dq_acc, row0, seq, g, t);
  (void)unused;
}

// ------------------------------------------------ host side

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// links no libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn tensor_map_encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// A [bh, seq, d] tensor as a TMA map of [1, 64, w] boxes: bf16 rows whole
// (w = d) and swizzled by their width (128 B for d = 64, 64 B for d = 32),
// or f32 rows in boxes of w = 32 floats, one 128-byte swizzle line.  The map
// is 3-D, so a box past seq is filled with zeros instead of the next
// slice's rows.
int make_rows_map(CUtensorMap* map, const void* ptr, int bh, int seq, int d,
                  bool f32) {
  const EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t esize = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)seq, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * esize,
                                 (cuuint64_t)seq * d * esize};
  const cuuint32_t box[3] = {(cuuint32_t)(f32 ? kBoxCols : d),
                             (cuuint32_t)kBox, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      f32 || d == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A map of each of the N [bh, seq, d] tensors at `src`.
template <int N>
int make_maps(CUtensorMap (&maps)[N], const void* const (&src)[N], int bh,
              int seq, int d, bool f32 = false) {
  for (int i = 0; i < N; ++i) {
    const int err = make_rows_map(&maps[i], src[i], bh, seq, d, f32);
    if (err != 0) return err;
  }
  return 0;
}

// Raise `kernel`'s dynamic shared-memory limit to `bytes` once a device
// (bit `dev` of `set`, one `set` a kernel); two threads racing here both
// set it, which is harmless.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<uint64_t>& set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(set.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    set.fetch_or(bit, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

// The dK/dV (Dkv) or dQ kernel from tensor maps of q, k, v and dO, bf16
// or f32 (F32): out0 = dk, out1 = dv, or out0 = dq.
template <int D, bool Dkv, bool F32>
int launch_bwd(const CUtensorMap (&maps)[4], const float* m, const float* l,
               const float* di, void* out0, void* out1, int bh, int seq,
               float scale, cudaStream_t stream) {
  using Smem = std::conditional_t<F32, F32BwdSmem<D, Dkv>, BwdSmem<D, Dkv>>;
  using Out = std::conditional_t<F32, float, bf16_t>;
  constexpr int kSmem = (int)sizeof(Smem) + 1024;
  const auto kernel = [] {
    if constexpr (F32) {
      return Dkv ? flash_dkv_tf32x3_kernel<D> : flash_dq_tf32x3_kernel<D>;
    } else {
      return Dkv ? flash_dkv_wgmma_kernel<D> : flash_dq_wgmma_kernel<D>;
    }
  }();
  static std::atomic<uint64_t> set{0};
  const cudaError_t err = allow_smem(kernel, kSmem, set);
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (F32) {
    const long long blocks =
        (long long)bh * ((seq + Smem::kOwnRows - 1) / Smem::kOwnRows);
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    kernel<<<(unsigned)blocks, Smem::kThreads, kSmem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], m, l, di, (Out*)out0,
        (Out*)out1, seq, scale);
  } else {
    const dim3 grid(bh, (seq + kOwnRows - 1) / kOwnRows);
    kernel<<<grid, kRingThreads, kSmem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], m, l, di, (Out*)out0,
        (Out*)out1, seq, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

using BwdLaunch = int (*)(const CUtensorMap (&)[4], const float*,
                          const float*, const float*, void*, void*, int, int,
                          float, cudaStream_t);

// The dK/dV (dkv) or dQ kernel, bf16 or f32, for D = 32 or 64.
int flash_bwd(bool dkv, const void* q, const void* k, const void* v,
              const void* dout, const float* m, const float* l,
              const float* di, void* out0, void* out1, int bh, int seq,
              int d, bool bf16, float scale, cudaStream_t stream) {
  // [d == 64][dkv][f32]
  static constexpr BwdLaunch kLaunch[2][2][2] = {
      {{launch_bwd<32, false, false>, launch_bwd<32, false, true>},
       {launch_bwd<32, true, false>, launch_bwd<32, true, true>}},
      {{launch_bwd<64, false, false>, launch_bwd<64, false, true>},
       {launch_bwd<64, true, false>, launch_bwd<64, true, true>}}};
  CUtensorMap maps[4];
  const int err = make_maps(maps, {q, k, v, dout}, bh, seq, d, !bf16);
  if (err != 0) return err;
  return kLaunch[d == 64][dkv][!bf16](maps, m, l, di, out0, out1, bh, seq,
                                       scale, stream);
}

// The forward from tensor maps of q, k and v: the bf16 kernel (F32 false)
// or the f32 one.
template <int D, bool F32>
int launch_fwd(const CUtensorMap (&maps)[3], void* o, float* m, float* l,
               int bh, int seq, float scale, cudaStream_t stream) {
  using Smem = std::conditional_t<F32, F32FwdSmem<D>, FwdSmem<D>>;
  using Out = std::conditional_t<F32, float, bf16_t>;
  constexpr int kSmem = (int)sizeof(Smem) + 1024;
  const auto kernel = [] {
    if constexpr (F32) {
      return flash_fwd_tf32x3_kernel<D>;
    } else {
      return flash_fwd_wgmma_kernel<D>;
    }
  }();
  static std::atomic<uint64_t> set{0};
  const cudaError_t err = allow_smem(kernel, kSmem, set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (long long)bh * ((seq + kOwnRows - 1) / kOwnRows);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<(unsigned)blocks, kRingThreads, kSmem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<Out*>(o), m, l, seq, scale);
  return static_cast<int>(cudaGetLastError());
}

// The forward, bf16 or f32: two consumer warpgroups a block and 4 slots, at
// every S and D (PERF.md has the bf16 alternatives' times).
int flash_fwd(const void* q, const void* k, const void* v, void* o, float* m,
              float* l, int bh, int seq, int d, bool bf16, float scale,
              cudaStream_t stream) {
  CUtensorMap maps[3];
  const int err = make_maps(maps, {q, k, v}, bh, seq, d, !bf16);
  if (err != 0) return err;
  if (bf16) {
    return d == 64
               ? launch_fwd<64, false>(maps, o, m, l, bh, seq, scale, stream)
               : launch_fwd<32, false>(maps, o, m, l, bh, seq, scale, stream);
  }
  return d == 64 ? launch_fwd<64, true>(maps, o, m, l, bh, seq, scale, stream)
                 : launch_fwd<32, true>(maps, o, m, l, bh, seq, scale, stream);
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
  if (d != 64 && d != 32) return static_cast<int>(cudaErrorInvalidValue);
  return flash_fwd(q, k, v, o, m, l, bh, seq, d, bf16 != 0, scale, stream);
}

extern "C" int flash_attention_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* m, const float* l,
                                   const float* di, void* dk, void* dv,
                                   int bh, int seq, int d, int bf16,
                                   float scale, cudaStream_t stream) {
  if (d != 64 && d != 32) return static_cast<int>(cudaErrorInvalidValue);
  return flash_bwd(true, q, k, v, dout, m, l, di, dk, dv, bh, seq, d,
                   bf16 != 0, scale, stream);
}

extern "C" int flash_attention_dq(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* m, const float* l,
                                  const float* di, void* dq, int bh,
                                  int seq, int d, int bf16, float scale,
                                  cudaStream_t stream) {
  if (d != 64 && d != 32) return static_cast<int>(cudaErrorInvalidValue);
  return flash_bwd(false, q, k, v, dout, m, l, di, dq, nullptr, bh, seq, d,
                   bf16 != 0, scale, stream);
}
