#!/usr/bin/env python3
"""Device and host time of K1 (``nei_sum``) and K2's backward
(``nei_max_bwd``): the source as it is and optionally other versions of
it (a parent commit's, a variant), in turns on one card, with their
library calls and the launch floor.

    python3 scripts/bench_nei_table.py [--parent FILE]
        [--version NAME=FILE ...] [--calls 20]

Each version of ``deepchem_tpu_torch/csrc/nei_table.cu`` is compiled by
nvcc with the package's flags into ``build/bench_nei_table/<name>.so``
(all at once, beside an empty kernel; ptxas's registers and spill stores
of each kernel are printed) and called through its C entries
``nei_sum_f32`` and ``nei_max_bwd_f32``.  ``base`` is the source as it
is, ``parent`` the file given to ``--parent``, and each ``--version``
another.  The runs go parent, the versions, base, base, the versions in
reverse, parent, and the two runs of each are averaged.

Cases: the inputs ``GraphConvModel`` at ``bench.py``'s width hands K1 and
K2 in ``chip_smoke.py`` phase 11's first batch of 256 (both layers; K2's
cotangent from a seed, its winners from the package's K2 forward), the
same in copies 4 bytes off 16-byte alignment (``chip_smoke.misaligned``:
there the base kernels take one float a lane, not float4 rows), and
``chip_smoke.random_table``'s graph of 1000 nodes with degrees 0 to 10 at
F 1, 4, 32, 64, 75 and 128, at F 64 with rows 4 bytes off 16-byte
alignment, with tied maxima (F 1, 75) and all ties (F 64).

Per run, case and kernel it prints the profiler's device µs a launch
(``chip_smoke.device_us``; null where no profile passed its checks), the
µs a launch between CUDA events around replays of a CUDA graph of
``--calls`` launches (the card's time, gaps between launches included),
and the host µs a call of the C entry (200 back-to-back calls, no
synchronise), and which path each base kernel took (the C entries'
float4 count).  Each run also times an empty kernel at the base kernel's
grid and at the parent's (one warp a node), the launch floor.  Before the
runs it times the library calls once (``torch.sparse.mm`` for K1,
``scatter_add_`` of g into its winners' rows for K2's backward): device
µs over every kernel of one call, and µs a call between CUDA events.
Each version's outputs are held against the plain version
(``chip_smoke.sum_tol``), and every other version's must equal the
base's bit for bit (``torch.equal``) in every case, or the script exits
1.  The card's name and power limit come first and last, and stand in
every JSON line of times (``card``); a JSON line of means comes before
the last.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))
CSRC = REPO / 'deepchem_tpu_torch' / 'csrc'
OUT = REPO / 'build' / 'bench_nei_table'
HOST_CALLS = 200
GRAPH_REPLAYS = 20
THREADS = 256                  # a block of either version
EMPTY_CU = r'''
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int blocks, int threads, cudaStream_t stream) {
  empty_kernel<<<blocks, threads, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
'''


def card() -> str:
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()


def nvcc(sources: dict) -> dict:
    """Compile {name: .cu path} into OUT/<name>.so with the package's
    flags, all at once; {name: {kernel: (registers, spill stores)}}."""
    from deepchem_tpu_torch.kernels import build as kbuild
    procs = {n: subprocess.Popen(
        [kbuild._nvcc(), *kbuild.NVCC_FLAGS, '-I', str(CSRC),
         '-o', str(OUT / f'{n}.so'), str(cu)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for n, cu in sources.items()}
    report = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f'nvcc failed for {n}:\n{log[-4000:]}')
        regs = re.findall(r"Compiling entry function '(\w+)' for 'sm_90a'\n"
                          r".*\n.* (\d+) bytes spill stores.*\n"
                          r".*Used (\d+) registers", log)
        report[n] = {k: (int(r), int(b)) for k, b, r in regs}
    return report


def entries(name: str):
    """The C entries of ``OUT/<name>.so`` by their names."""
    lib = ctypes.CDLL(str(OUT / f'{name}.so'))
    fns = {}
    for sym, n_ptrs in (('nei_sum_f32', 4), ('nei_max_bwd_f32', 5),
                        ('empty_launch', 0), ('nei_table_float4_launches', 1)):
        fn = getattr(lib, sym, None)
        if fn is not None and sym == 'nei_table_float4_launches':
            fn.argtypes, fn.restype = [ctypes.c_void_p], None
            fns[sym] = fn
        elif fn is not None:
            n_ints = 2 if sym == 'empty_launch' else 3
            fn.argtypes = [ctypes.c_void_p] * n_ptrs \
                + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[sym] = fn
    return fns


def cases(dev):
    """{name: (h, g, table, deg, winner)} on the card: K1 sums h, K2's
    backward takes g and the winners of h's max."""
    import numpy as np
    import torch
    from chip_smoke import (GRAPHCONV, graphconv_data, misaligned,
                            random_table, recorded)
    from deepchem_tpu_torch import GraphConvModel
    from deepchem_tpu_torch.models import graph_layers
    from deepchem_tpu_torch.ops import nei_table
    X, _ = graphconv_data()
    model = GraphConvModel(**GRAPHCONV, device=dev, seed=0)
    batch = X[:GRAPHCONV['batch_size']]
    sums = recorded(graph_layers, 'nei_sum',
                    lambda: model.predict_on_batch(batch))
    maxes = recorded(graph_layers, 'nei_max_incl_self',
                     lambda: model.predict_on_batch(batch))
    gen = torch.Generator(dev).manual_seed(2)
    rng = np.random.RandomState(0)
    table, deg = random_table(rng, 1000, dev)
    out = {}

    def add(name, h, g, table, deg, h_max=None):
        winner = nei_table._nei_max_forward(
            h if h_max is None else h_max, table, deg)[1]
        out[name] = (h, g, table, deg, winner)

    for i, ((h, tbl, dg), (hm, _, _)) in enumerate(zip(sums, maxes)):
        g = torch.randn(hm.shape, generator=gen, device=dev)
        add(f'graphconv_batch256_layer{i}', h, g, tbl, dg, hm)
        add(f'graphconv_batch256_layer{i}_misaligned', misaligned(h),
            misaligned(g), tbl, dg, hm)
    for F in (1, 4, 32, 64, 75, 128):
        h = torch.from_numpy(rng.randn(1000, F).astype(np.float32)).to(dev)
        add(f'degrees_0_10_F{F}', h, torch.randn(
            (1000, F), generator=gen, device=dev), table, deg)
    h = torch.from_numpy(rng.randn(1000, 64).astype(np.float32)).to(dev)
    add('degrees_0_10_F64_misaligned', misaligned(h), misaligned(
        torch.randn((1000, 64), generator=gen, device=dev)), table, deg)
    for F in (1, 75):
        h = torch.from_numpy(np.maximum(rng.randint(-2, 3, (1000, F)), 0)
                             .astype(np.float32)).to(dev)
        add(f'ties_degrees_0_10_F{F}', h, torch.randn(
            (1000, F), generator=gen, device=dev), table, deg)
    add('all_ties_F64', torch.zeros(1000, 64, device=dev), torch.randn(
        (1000, 64), generator=gen, device=dev), table, deg)
    return out


def graph_us(fn, calls: int) -> float:
    """µs a launch between CUDA events around replays of a CUDA graph of
    ``calls`` calls of ``fn``."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / (GRAPH_REPLAYS * calls)


def timed(fn, kernel: str, calls: int) -> dict:
    from bench_flash import host_us, profiled_us
    from chip_smoke import device_us
    return {'device_us': profiled_us(device_us, fn, kernel, calls),
            'graph_us': graph_us(fn, calls),
            'host_us': host_us(fn, HOST_CALLS)}


def float4_counts(fns: dict) -> tuple:
    """The C entries' float4 launches of K1 and K2's backward so far, or
    (0, 0) for a version that does not count them."""
    fn = fns.get('nei_table_float4_launches')
    counts = (ctypes.c_longlong * 2)()
    if fn is not None:
        fn(counts)
    return tuple(counts)


def grid(n: int, F: int, float4: bool) -> int:
    """Blocks of the base kernels for ``n`` rows of ``F`` floats: a group
    of lanes a node, the least power of two >= the row's units (floats or
    float4s), at most 32 (``layout_for`` in ``nei_table.cu``)."""
    cols = F // 4 if float4 else F
    lanes = 1
    while lanes < min(cols, 32):
        lanes *= 2
    nodes = THREADS // lanes
    return (n + nodes - 1) // nodes


def run_version(name: str, fns: dict, empty, inputs: dict,
                calls: int) -> tuple:
    """({case: {part: timings}}, {case: {part: output}}, {case: [path of
    K1, of K2's backward]}) of one version."""
    import torch
    from chip_smoke import max_err, sum_tol
    from deepchem_tpu_torch.ops.nei_table import (
        nei_max_backward_reference, nei_sum_reference)
    times, outs, paths = {}, {}, {}
    for case, (h, g, table, deg, winner) in inputs.items():
        N, F = h.shape
        K = table.shape[1]
        out, grad = torch.empty_like(h), torch.empty_like(g)
        k1, k2 = fns['nei_sum_f32'], fns['nei_max_bwd_f32']

        def stream():
            return torch.cuda.current_stream().cuda_stream

        def run_k1():
            return k1(h.data_ptr(), table.data_ptr(), deg.data_ptr(),
                      out.data_ptr(), N, K, F, stream())

        def run_k2():
            return k2(g.data_ptr(), table.data_ptr(), deg.data_ptr(),
                      winner.data_ptr(), grad.data_ptr(), N, K, g.shape[1],
                      stream())
        before = float4_counts(fns)
        if run_k1() or run_k2():
            raise RuntimeError(f'{name}: a launch failed at {case}')
        paths[case] = ['float4' if b > a else 'float'
                       for a, b in zip(before, float4_counts(fns))]
        torch.cuda.synchronize()
        outs[case] = {'nei_sum': out.clone(), 'nei_max_bwd': grad.clone()}
        for part, got, ref in (
                ('nei_sum', out, nei_sum_reference(h, table, deg)),
                ('nei_max_bwd', grad, nei_max_backward_reference(
                    g, table, deg, winner))):
            err = max_err(got, ref)
            if err > sum_tol(ref):
                raise RuntimeError(f'{name} {case} {part}: error {err}')
        times[case] = {
            'nei_sum': timed(run_k1, 'nei_sum_kernel', calls),
            'nei_max_bwd': timed(run_k2, 'nei_max_bwd_kernel', calls)}
        float4 = paths[case][0] == 'float4'
        for label, blocks in (('empty_base_grid', grid(N, F, float4)),
                              ('empty_parent_grid', grid(N, 32, False))):
            times[case][label] = dict(timed(
                lambda: empty(blocks, THREADS, stream()), 'empty_kernel',
                calls), blocks=blocks)
        print(f'{name} {case}: timed', file=sys.stderr, flush=True)
    return times, outs, paths


def library_us(inputs: dict, calls: int) -> dict:
    """{case: {call: device µs}} of the library calls, every kernel of one
    call (``chip_smoke.device_us_all``; null where the profiler recorded
    none), and the µs a call between CUDA events around 200 calls
    (``chip_smoke.time_ms``)."""
    from chip_smoke import (device_us_all, library_nei_max_bwd,
                            library_nei_sum, table_csr, time_ms)
    out = {}
    for case, (h, g, table, deg, winner) in inputs.items():
        _, _, row_ptr, col = table_csr(table, deg)
        winner_idx = winner.long()
        out[case] = {}
        for call, fn in (
                ('sparse_mm', lambda: library_nei_sum(h, row_ptr, col)),
                ('scatter_add', lambda: library_nei_max_bwd(g, winner_idx))):
            try:
                dev = device_us_all(fn, calls)[0]
            except RuntimeError as err:
                print(f'{case} {call}: {err}', file=sys.stderr, flush=True)
                dev = None
            out[case][call] = {'device_us': dev,
                               'event_us': time_ms(fn) * 1e3}
    return out


def mean(values):
    values = [v for v in values if v is not None]
    return sum(values) / len(values) if values else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--parent', type=Path)
    ap.add_argument('--version', action='append', default=[],
                    metavar='NAME=FILE')
    ap.add_argument('--calls', type=int, default=20)
    args = ap.parse_args()
    import torch
    from chip_smoke import bound, table_csr
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / 'empty.cu').write_text(EMPTY_CU)
    sources = {'base': CSRC / 'nei_table.cu', 'empty': OUT / 'empty.cu'}
    given = [('parent', args.parent)] if args.parent else []
    given += [tuple(v.split('=', 1)) for v in args.version]
    others = [n for n, _ in given if n != 'parent']
    for n, path in given:
        sources[n] = OUT / f'{n}.cu'
        sources[n].write_text(Path(path).read_text())
    name = card()
    print(name, flush=True)
    for n, rep in nvcc(sources).items():
        print(json.dumps({'version': n, 'registers_spills': rep}),
              flush=True)
    dev = torch.device('cuda', 0)
    inputs = cases(dev)
    info = {}
    for case, (h, g, table, deg, winner) in inputs.items():
        src, _, _, _ = table_csr(table, deg)
        N, F = h.shape
        Fg = g.shape[1]
        slots, rows = src.numel(), src.unique().numel()
        info[case] = {
            'N': N, 'F': {'nei_sum': F, 'nei_max_bwd': Fg},
            'K': table.shape[1], 'slots': slots,
            'bound_us': {
                'nei_sum': bound(4 * (rows * F + slots + N * F) + N,
                                 slots * F)[0] * 1e3,
                'nei_max_bwd': bound(4 * 3 * N * Fg + 4 * slots + N,
                                     slots * Fg)[0] * 1e3}}
    print(json.dumps({'card': name, 'cases': info}), flush=True)
    empty = entries('empty')['empty_launch']
    fns = {n: entries(n) for n in sources if n != 'empty'}
    outer = ['parent'] if args.parent else []
    order = outer + others + ['base', 'base'] + others[::-1] + outer
    print(json.dumps({'card': name,
                      'library_us': library_us(inputs, args.calls)}),
          flush=True)
    runs = {n: [] for n in fns}
    first_outs = {}
    for n in order:
        times, outs, paths = run_version(n, fns[n], empty, inputs,
                                         args.calls)
        runs[n].append(times)
        first_outs.setdefault(n, outs)
        print(json.dumps({'card': name, 'version': n, 'run': len(runs[n]),
                          'paths': paths, 'us': times}),
              flush=True)
    identical = {n: {case: {part: torch.equal(first_outs['base'][case][part],
                                              first_outs[n][case][part])
                            for part in ('nei_sum', 'nei_max_bwd')}
                     for case in inputs}
                 for n in first_outs if n != 'base'}
    if identical:
        print(json.dumps({'base_equals_bit_for_bit': identical}), flush=True)
    print(json.dumps({'card': name, 'mean_us': {
        n: {case: {part: {x: mean([r[case][part][x] for r in rs])
                          for x in rs[0][case][part]}
                   for part in rs[0][case]}
            for case in rs[0]}
        for n, rs in runs.items()}}), flush=True)
    print(name, flush=True)
    if not all(all(v.values()) for per in identical.values()
               for v in per.values()):
        print('outputs differ between versions', file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
