#!/usr/bin/env python3
"""The launch floor of K4 (``nei_gather_kernel``): an empty kernel at the
grid K4 takes at the model paths' shapes, on one card.

    python3 scripts/k4_launch_floor.py [--calls 20]

GAT and AttentiveFP at the JAX package's defaults pack a batch of 100 of
``chip_smoke.py``'s 48 SMILES to N 2048 nodes and K 10 slots; K4
gathers C 8 (GAT's ``e_src``), C 64 (GAT's ``z``) and C 200
(AttentiveFP's ``z``) floats a slot in float4 units, a group of lanes a
slot row (``nei_gather.cu``: the least power of two at or above the
row's units, at most 32, in blocks of 256 threads).  For each C it times
an empty kernel of that many blocks (``scripts/bench_nei_table.py``'s
``EMPTY_CU``, built by nvcc with the package's flags): the profiler's
device µs a launch (``chip_smoke.device_us``) and the µs a launch between
CUDA events around replays of a CUDA graph.  Prints the card's name and
power limit, then one JSON line.
"""

import argparse
import ctypes
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from bench_nei_table import (EMPTY_CU, OUT, THREADS, card,  # noqa: E402
                             graph_us, nvcc)

NODES, SLOTS = 2048, 10
WIDTHS = {'gat_e_src': 8, 'gat_z': 64, 'attentivefp_z': 200}


def blocks_for(C: int) -> int:
    units = C // 4 if C % 4 == 0 else C
    lanes = 1
    while lanes < min(units, 32):
        lanes *= 2
    rows = THREADS // lanes
    return (NODES * SLOTS + rows - 1) // rows


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('--calls', type=int, default=20)
    args = parser.parse_args()
    import torch
    from bench_flash import profiled_us
    from chip_smoke import device_us
    print(card(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / 'empty.cu').write_text(EMPTY_CU)
    nvcc({'empty': OUT / 'empty.cu'})
    launch = ctypes.CDLL(str(OUT / 'empty.so')).empty_launch
    launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = {}
    for name, C in WIDTHS.items():
        blocks = blocks_for(C)

        def run():
            if launch(blocks, THREADS,
                      torch.cuda.current_stream().cuda_stream):
                raise RuntimeError('empty_launch failed')
        out[name] = {'C': C, 'blocks': blocks, 'threads': THREADS,
                     'device_us': profiled_us(device_us, run, 'empty_kernel',
                                              args.calls),
                     'graph_us': graph_us(run, args.calls)}
    print(json.dumps({'k4_launch_floor': out}), flush=True)
    print(card(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
