#!/usr/bin/env python3
"""The launch floor of P2's bfloat16 kernel
(``fused_gather_segment_sum_bf16_kernel``): an empty kernel at the grid the
kernel takes at the four smaller shapes of ``scripts/bench_pallas_csr.py``,
beside the kernel itself, on one card.

    python3 scripts/p2_bf16_launch_floor.py [--calls 20]

At each shape (``chip_smoke.P2_BENCH_SHAPES``: N nodes, E edges, F
features) the kernel takes rows of F / 8 uint4 units, a group of the least
power of two at or above them (at most 32) lanes a node, 8 warps a block
(``fused_gather_segment_sum.cu``).  For each shape it times an empty
kernel of that many blocks of 256 threads (``scripts/bench_nei_table.py``'s
``EMPTY_CU``, built by nvcc with the package's flags) and the bf16 kernel
on ``chip_smoke.bench_graph``'s inputs: the profiler's device µs a launch
(``chip_smoke.device_us``) and, for the empty kernel, the µs a launch
between CUDA events around replays of a CUDA graph; and the bytes bound
(each input read once, the output written once, at the card's memory
rate).  Prints the card's name and power limit, then one JSON line.
"""

import argparse
import ctypes
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from bench_nei_table import (EMPTY_CU, OUT, THREADS, card,  # noqa: E402
                             graph_us, nvcc)

WARPS_PER_BLOCK = THREADS // 32


def blocks_for(N: int, F: int) -> int:
    units = F // 8 if F % 8 == 0 else F
    lanes = 1
    while lanes < min(units, 32):
        lanes *= 2
    nodes = WARPS_PER_BLOCK * (32 // lanes)
    return (N + nodes - 1) // nodes


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('--calls', type=int, default=20)
    args = parser.parse_args()
    import numpy as np
    import torch
    from bench_flash import profiled_us
    from chip_smoke import (HBM_BYTES_PER_S, P2_BENCH_SHAPES, bench_graph,
                            device_us)
    from deepchem_tpu_torch.ops import fused_gather_segment_sum
    print(card(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / 'empty.cu').write_text(EMPTY_CU)
    nvcc({'empty': OUT / 'empty.cu'})
    launch = ctypes.CDLL(str(OUT / 'empty.so')).empty_launch
    launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    dev = torch.device('cuda', 0)
    rng = np.random.RandomState(0)
    out = {}
    for N, E, F in P2_BENCH_SHAPES[:4]:
        blocks = blocks_for(N, F)

        def empty():
            if launch(blocks, THREADS,
                      torch.cuda.current_stream().cuda_stream):
                raise RuntimeError('empty_launch failed')
        h, src, row_ptr = bench_graph(rng, N, E, F, dev)
        h = h.to(torch.bfloat16)
        rows = int(src.unique().numel())
        nbytes = 2 * rows * F + 4 * E + 4 * (N + 1) + 2 * N * F
        out[f'N{N}_E{E}_F{F}'] = {
            'blocks': blocks, 'threads': THREADS,
            'empty_device_us': profiled_us(device_us, empty, 'empty_kernel',
                                           args.calls),
            'empty_graph_us': graph_us(empty, args.calls),
            'kernel_device_us': profiled_us(
                device_us, lambda: fused_gather_segment_sum(h, src, row_ptr),
                'fused_gather_segment_sum_bf16_kernel', args.calls),
            'bytes_bound_us': nbytes / HBM_BYTES_PER_S * 1e6}
    print(json.dumps({'p2_bf16_launch_floor': out}), flush=True)
    print(card(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
