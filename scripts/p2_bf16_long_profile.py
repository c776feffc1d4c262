#!/usr/bin/env python3
"""Where a long segment's time goes in P2's bfloat16 kernel
(``fused_gather_segment_sum_bf16_kernel``): SM cycles of each batch of its
block-wide path, from ``clock64`` in thread 0, on one card.

    python3 scripts/p2_bf16_long_profile.py

It builds a copy of ``deepchem_tpu_torch/csrc/fused_gather_segment_sum.cu``
with ``clock64`` reads around the four steps of a batch (waiting for this
thread's copies, the barrier, issuing the copies of a later batch, adding
this batch) and a ``__device__`` array they are written to, into
``build/p2_bf16_long_profile/``, runs it on ``chip_smoke.p2_long_inputs``
(a hub of 2000 edges at F 64, 4096 edge rows at F 300) and prints, per
input, the batches, the median cycles a batch and of each step, and the
first iterations.  Thread 0 adds a column, so the copying it times is its
own (none where warps with no column copy alone).  The card's name and
power limit come first.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / 'scripts'))
OUT = REPO / 'build' / 'p2_bf16_long_profile'
CSRC = REPO / 'deepchem_tpu_torch' / 'csrc'

# (anchor in the source, text put after it)
PROBES = [
    ('namespace {\n', '__device__ long long g_clock[4096][5];\n'),
    ('    for (int b = 0; b < batches; ++b) {  // uniform\n',
     '      const long long c0_ = clock64();\n'),
    ('      cp_async_wait<kRingStages - 2>();  // this thread\'s copies of '
     'batch b\n', '      const long long c1_ = clock64();\n'),
    ('      __syncthreads();  // everyone\'s, and batch b - 1 is added\n',
     '      const long long c2_ = clock64();\n'),
    ('      issue(b + kRingStages - 1);  // into the rows of batch b - 1\n',
     '      const long long c3_ = clock64();\n'
     '      if (t == 0 && b < 4096) {\n'
     '        g_clock[b][0] = c0_; g_clock[b][1] = c1_;\n'
     '        g_clock[b][2] = c2_; g_clock[b][3] = c3_;\n'
     '      }\n'),
    ('        add_batch<W, kLongUnits>(lo, hi, ring, r0, stride, b * batch, '
     'e_end,\n                                 cols, t);\n      }\n',
     '      if (t == 0 && b < 4096) g_clock[b][4] = clock64();\n'),
]


def instrumented() -> str:
    text = (CSRC / 'fused_gather_segment_sum.cu').read_text()
    for anchor, probe in PROBES:
        if text.count(anchor) != 1:
            raise SystemExit(f'p2_bf16_long_profile: anchor not found '
                             f'once: {anchor!r}')
        text = text.replace(anchor, anchor + probe)
    return text + ('\nextern "C" int p2_clock_read(void* dst) {\n'
                   '  return static_cast<int>(cudaMemcpyFromSymbol(\n'
                   '      dst, g_clock, sizeof(g_clock)));\n}\n')


def main() -> int:
    import numpy as np
    import torch
    from bench_nei_table import card
    from chip_smoke import p2_long_inputs
    from deepchem_tpu_torch.kernels import build
    if not torch.cuda.is_available():
        print('p2_bf16_long_profile: no CUDA device', file=sys.stderr)
        return 1
    print(card(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / 'p2.cu').write_text(instrumented())
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, '-I', str(CSRC),
                        '-o', str(OUT / 'p2.so'), str(OUT / 'p2.cu')],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit((r.stdout + r.stderr)[-4000:])
    lib = ctypes.CDLL(str(OUT / 'p2.so'))
    fn = lib.fused_gather_segment_sum_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    dev = torch.device('cuda', 0)
    for name, (h, src, rp) in p2_long_inputs(dev).items():
        h = h.to(torch.bfloat16)
        N, (Nh, F), E = rp.shape[0] - 1, h.shape, src.shape[0]
        out = h.new_empty((N, F))
        for _ in range(3):
            fn(h.data_ptr(), src.data_ptr(), rp.data_ptr(), out.data_ptr(),
               N, Nh, E, F, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        clocks = np.zeros((4096, 5), np.int64)
        lib.p2_clock_read(ctypes.c_void_p(clocks.ctypes.data))
        clocks = clocks[clocks[:, 4] > 0]
        steps = np.median(np.diff(clocks, axis=1), axis=0)
        print(f'{name}: {len(clocks)} batches, SM cycles a batch (median) '
              f'{int(np.median(np.diff(clocks[:, 0])))}: wait '
              f'{int(steps[0])}, barrier {int(steps[1])}, copies issued '
              f'{int(steps[2])}, adds {int(steps[3])}; first batches '
              f'{np.diff(clocks[:13, 0]).tolist()}', flush=True)
    print(card(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
