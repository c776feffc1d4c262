#!/usr/bin/env python3
"""The launch floor of P2's bfloat16 kernel
(``fused_gather_segment_sum_bf16_kernel``): an empty kernel at the grid the
kernel takes and at the grid of its first design, beside the kernel
itself, on one card.

    python3 scripts/p2_bf16_launch_floor.py [--calls 20]

At each bench shape (``chip_smoke.P2_BENCH_SHAPES``: N nodes, E edges, F
features) on ``chip_smoke.bench_graph``'s inputs, it times
``p2_empty_kernel`` (``csrc/fused_gather_segment_sum.cu``) at the grid and
block that ``fused_gather_segment_sum_bf16`` takes for them
(``fused_gather_segment_sum_bf16_empty``) and at the first design's
(``blocks_for``: 8 warps a block, a group of the least power of two lanes
at or above a row's units a node, at most 32; ``p2_empty_launch``): the
profiler's device µs a launch (``chip_smoke.p2_bf16_floor_us``) and the µs
a launch between CUDA events around replays of a CUDA graph.  Beside them
the kernel's device µs and the bytes bound (each input read once, the
output written once, at the card's memory rate).  The floor
``chip_smoke.py`` holds the kernel to is the smaller of the two empty
kernels' device times.  Prints the card's name and power limit, then one
JSON line.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from bench_nei_table import card, graph_us  # noqa: E402
from chip_smoke import p2_bf16_parent_blocks as blocks_for  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('--calls', type=int, default=20)
    args = parser.parse_args()
    import numpy as np
    import torch
    from bench_flash import profiled_us
    from chip_smoke import (HBM_BYTES_PER_S, P2_BENCH_SHAPES,
                            P2_BF16_PARENT_WARPS, bench_graph, device_us,
                            p2_bf16_floor_us)
    from deepchem_tpu_torch.kernels import build
    from deepchem_tpu_torch.ops import fused_gather_segment_sum
    print(card(), flush=True)
    new_grid = build.c_entry('fused_gather_segment_sum',
                             'fused_gather_segment_sum_bf16_empty', 2, 2)
    any_grid = build.c_entry('fused_gather_segment_sum', 'p2_empty_launch',
                             0, 2)
    dev = torch.device('cuda', 0)
    rng = np.random.RandomState(0)
    out = {}
    for N, E, F in P2_BENCH_SHAPES:
        h, src, row_ptr = bench_graph(rng, N, E, F, dev)
        h = h.to(torch.bfloat16)
        res = h.new_empty((N, F))
        blocks = blocks_for(N, F)

        # the stream is read at each call: a graph captures on its own
        def empty_new():
            if new_grid(h.data_ptr(), res.data_ptr(), N, F,
                        torch.cuda.current_stream().cuda_stream):
                raise RuntimeError('fused_gather_segment_sum_bf16_empty')

        def empty_parent():
            if any_grid(blocks, 32 * P2_BF16_PARENT_WARPS,
                        torch.cuda.current_stream().cuda_stream):
                raise RuntimeError('p2_empty_launch failed')
        rows = int(src.unique().numel())
        nbytes = 2 * rows * F + 4 * E + 4 * (N + 1) + 2 * N * F
        out[f'N{N}_E{E}_F{F}'] = {
            'parent_blocks': blocks,
            **p2_bf16_floor_us(h, row_ptr),
            'empty_new_grid_graph_us': graph_us(empty_new, args.calls),
            'empty_parent_grid_graph_us': graph_us(empty_parent,
                                                   args.calls),
            'kernel_device_us': profiled_us(
                device_us, lambda: fused_gather_segment_sum(h, src, row_ptr),
                'fused_gather_segment_sum_bf16_kernel', args.calls),
            'bytes_bound_us': nbytes / HBM_BYTES_PER_S * 1e6}
    print(json.dumps({'p2_bf16_launch_floor': out}), flush=True)
    print(card(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
