#!/usr/bin/env python3
"""The rate of ``mma.sync.m16n8k8`` with tf32 operands on the card: the
instruction that P4's float32 forward (``flash_fwd_tf32x3_kernel``) runs for
both of its products.

    python3 scripts/mma_tf32_rate.py

A kernel whose warps issue only independent m16n8k8 tf32 products (8
accumulators a warp, operands in registers, no memory traffic in the loop)
is compiled with the package's nvcc flags into ``build/mma_tf32_rate/`` and
timed with CUDA events, in two layouts: many warps an SM (16 blocks of 4
warps on each of the card's SMs), and the forward's own, 8 warps an SM (one
block of 8 warps on each SM).  Prints the card's name and power limit,
then one JSON line: TF/s of tf32 products in each layout, and the share of
the dense tf32 peak (494.7 TF/s, which wgmma reaches).
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
OUT = REPO / 'build' / 'mma_tf32_rate'
TF32_PEAK = 494.7e12
ITERS = 4096

SOURCE = r'''
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void mma_loop(float* out, int iters) {
  uint32_t a[4], b0 = threadIdx.x * 0x2000u + 0x3f800000u, b1 = b0 ^ 0x4000u;
  for (int i = 0; i < 4; ++i) a[i] = (threadIdx.x + i) * 0x2000u + 0x3c000000u;
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int mma_rate(float* out, int blocks, int threads, int iters,
                        cudaStream_t stream) {
  mma_loop<<<blocks, threads, 0, stream>>>(out, iters);
  return (int)cudaGetLastError();
}
'''


def main() -> int:
    import torch
    from deepchem_tpu_torch.kernels import build
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib_path = OUT / 'mma_rate.cu', OUT / 'mma_rate.so'
    src.write_text(SOURCE)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, '-o', str(lib_path),
                    str(src)], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib_path)).mma_rate
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for name, blocks, threads in (('16_blocks_of_4_warps_an_sm',
                                   16 * sms, 128),
                                  ('8_warps_an_sm', sms, 256)):
        out = torch.empty(blocks * threads, device='cuda')
        for _ in range(3):
            if fn(out.data_ptr(), blocks, threads, ITERS, stream):
                raise RuntimeError('launch failed')
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            fn(out.data_ptr(), blocks, threads, ITERS, stream)
        end.record()
        end.synchronize()
        sec = start.elapsed_time(end) / 5 * 1e-3
        flops = blocks * threads // 32 * ITERS * 8 * 2 * 16 * 8 * 8
        res[name] = {'tf_per_s': flops / sec / 1e12,
                     'share_of_tf32_peak': flops / sec / TF32_PEAK}
    print(json.dumps({'mma_sync_m16n8k8_tf32': res}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
