#!/usr/bin/env python3
"""Device and host time of GraphConv's kernels K1 (``nei_sum``), K2
(``nei_max_fwd``, ``nei_max_bwd``) and K3 (``graph_max_pool_fwd``,
``graph_max_pool_bwd``): the sources as they are and optionally other
versions of them (a parent commit's, a variant), in turns on one card,
with their library calls and the launch floor.

    python3 scripts/bench_nei_table.py [--parent FILE] [--parent-pool FILE]
        [--version NAME=FILE ...] [--pool-version NAME=FILE ...]
        [--calls 20]

Each version of ``deepchem_tpu_torch/csrc/nei_table.cu`` and of
``graph_pool.cu`` is compiled by nvcc with the package's flags into
``build/bench_nei_table/<name>.so`` and ``<name>_pool.so`` (all at once,
beside an empty kernel; ptxas's registers and spill stores of each kernel
are printed) and called through its C entries.  ``base`` is the sources
as they are; ``parent`` takes the files given to ``--parent``
(``nei_table.cu``) and ``--parent-pool`` (``graph_pool.cu``; the base's
where it is not given), each ``--version`` another ``nei_table.cu``
beside the base's ``graph_pool.cu``, and each ``--pool-version`` another
``graph_pool.cu`` beside the base's ``nei_table.cu``.  The runs go parent, the versions,
base, base, the versions in reverse, parent, and the two runs of each are
averaged.

Cases of K1 and K2: the inputs ``GraphConvModel`` at ``bench.py``'s width
hands them in ``chip_smoke.py`` phase 11's first batch of 256 (both
layers; K2's cotangent from a seed, its winners from the package's K2
forward), the same in copies 4 bytes off 16-byte alignment
(``chip_smoke.misaligned``: there the base kernels take one float a lane,
not float4 rows), and ``chip_smoke.random_table``'s graph of 1000 nodes
with degrees 0 to 10 at F 1, 4, 32, 64, 75 and 128, at F 64 with rows 4
bytes off 16-byte alignment, with tied maxima (F 1, 75) and all ties
(F 64); and K1 alone from MPNN's edge rows into its nodes, at the
inputs ``MPNNModel`` at its defaults hands it in ``chip_smoke.py`` phase
12's first batch of 100 (``nei_sum_edges`` over the incoming-edge table,
its rows also 4 bytes off alignment, and ``take_src``'s backward over the
outgoing-edge table with a cotangent from a seed).  A version whose
``nei_sum_f32`` takes no ``num_rows`` (before K1 took the source's row
count apart from the table's) is called without it: its kernel indexes
the rows through the table alone, so it runs the edge cases too.  Cases
of K3: the readout's input in the same batch (x [5120,
128], 256 graphs and the node mask), its misaligned copy, and 1000 rows
in graphs of 0 to 35 rows (a ghost tail of 20, one row in 50 masked) at
F 37, 75 and 128, and with tied maxima at F 128.  K3's backward takes
the cotangent from a seed and mx and den from the plain version, the
same for every version.

Per run, case and kernel it prints the profiler's device µs a launch
(``chip_smoke.device_us``; null where no profile passed its checks), the
µs a launch between CUDA events around replays of a CUDA graph of
``--calls`` launches (the card's time, gaps between launches included),
and the host µs a call of the C entry (200 back-to-back calls, no
synchronise), and which path each kernel took (the C entries' float4
counts).  Each run also times an empty kernel at the base grid
and at the parent's, the launch floor.  Before the runs it times the
library calls once (``torch.sparse.mm`` for K1, ``scatter_reduce_``
amax for K2's forward, ``scatter_add_`` of g into its winners' rows for
K2's backward, ``segment_reduce`` max for K3's forward): device µs over
every kernel of one call, and µs a call between CUDA events.  Each
version's outputs are held against the plain version
(``chip_smoke.sum_tol``; K2's forward exactly), the base's K1, K2 and
K3's backward bit for bit, signs of zeros included
(``chip_smoke.same_bits``), and every other version's must equal the
base's bit for bit (K2's winners and K3's mx and den too) in every case,
all of whose inputs are finite and above NEG, or the script exits 1;
only K1 and K2's backward may differ from a version before the repair of
their signed zeros, in the signs of zeros alone (``zero_signs``: K1's
sums start from -0, as the JAX sum starts from its first term, and K2's
backward adds +0 for the terms it does not take, as the JAX sum does).
The card's name and power limit come first and last,
and stand in every JSON line of times (``card``); a JSON line of means
comes before the last.
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
THREADS = 256                  # a block of K1 and K2, either version
POOL_THREADS = 256             # a block of K3, forward and backward (base)
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


# C entries: (pointers, ints) before the stream
SIGNATURES = {'nei_sum_f32': (4, 3), 'nei_max_fwd_f32': (5, 3),
              'nei_max_bwd_f32': (5, 3), 'graph_max_pool_fwd_f32': (6, 3),
              'graph_max_pool_bwd_f32': (7, 3), 'empty_launch': (0, 2)}
COUNTERS = ('nei_table_float4_launches', 'graph_pool_float4_launches')


def rows_arg(cu: Path) -> bool:
    """Whether a version's ``nei_sum_f32`` takes ``num_rows``."""
    m = re.search(r'int nei_sum_f32\(([^)]*)\)', cu.read_text())
    return bool(m) and 'num_rows' in m.group(1)


def entries(*names: str, rows: bool = False):
    """The C entries of ``OUT/<name>.so`` for each of ``names``, by their
    names; ``nei_sum_f32`` with ``num_rows`` where ``rows``
    (``fns['nei_sum_rows']``)."""
    fns = {'nei_sum_rows': rows}
    for name in names:
        lib = ctypes.CDLL(str(OUT / f'{name}.so'))
        for sym, (n_ptrs, n_ints) in SIGNATURES.items():
            if sym == 'nei_sum_f32' and rows:
                n_ints += 1
            fn = getattr(lib, sym, None)
            if fn is not None:
                fn.argtypes = [ctypes.c_void_p] * n_ptrs \
                    + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
                fns[sym] = fn
        for sym in COUNTERS:
            fn = getattr(lib, sym, None)
            if fn is not None:
                fn.argtypes, fn.restype = [ctypes.c_void_p], None
                fns[sym] = fn
    return fns


def table_cases(dev, X, model):
    """{name: (h, hm, g, table, deg, winner)} on the card: K1 sums h,
    K2's forward takes hm, its backward g and the winners of hm's max."""
    import numpy as np
    import torch
    from chip_smoke import GRAPHCONV, misaligned, random_table, recorded
    from deepchem_tpu_torch.models import graph_layers
    from deepchem_tpu_torch.ops import nei_table
    batch = X[:GRAPHCONV['batch_size']]
    sums = recorded(graph_layers, 'nei_sum',
                    lambda: model.predict_on_batch(batch))
    maxes = recorded(graph_layers, 'nei_max_incl_self',
                     lambda: model.predict_on_batch(batch))
    gen = torch.Generator(dev).manual_seed(2)
    rng = np.random.RandomState(0)
    table, deg = random_table(rng, 1000, dev)
    out = {}

    def add(name, h, g, table, deg, hm=None):
        hm = h if hm is None else hm
        winner = nei_table._nei_max_forward(hm, table, deg)[1]
        out[name] = (h, hm, g, table, deg, winner)

    for i, ((h, tbl, dg), (hm, _, _)) in enumerate(zip(sums, maxes)):
        g = torch.randn(hm.shape, generator=gen, device=dev)
        add(f'graphconv_batch256_layer{i}', h, g, tbl, dg, hm)
        add(f'graphconv_batch256_layer{i}_misaligned', misaligned(h),
            misaligned(g), tbl, dg, misaligned(hm))
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


def edge_cases(dev):
    """{name: (h, table, deg)} on the card: K1 from MPNN's edge rows
    through its edge-id tables, as ``chip_smoke.py`` phase 3 takes them."""
    import torch
    from chip_smoke import MPNN, misaligned, mpnn_data, recorded
    from deepchem_tpu_torch import MPNNModel
    from deepchem_tpu_torch.models import graph_layers
    X, _ = mpnn_data()
    model = MPNNModel(**MPNN, device=dev, seed=0)
    batch = X[:model.batch_size]
    (msg, e_table, e_deg, _, _), = recorded(
        graph_layers, 'nei_sum_edges',
        lambda: model.predict_on_batch(batch))[:1]
    (carry, esrc, o_table, o_deg), = recorded(
        graph_layers, 'take_src', lambda: model.predict_on_batch(batch))[:1]
    g = torch.randn((esrc.shape[0], carry.shape[1]),
                    generator=torch.Generator(dev).manual_seed(4), device=dev)
    return {'mpnn_batch100_nei_sum_edges': (msg, e_table, e_deg),
            'mpnn_batch100_nei_sum_edges_misaligned': (misaligned(msg),
                                                       e_table, e_deg),
            'mpnn_batch100_take_src_bwd': (g, o_table, o_deg)}


def pool_cases(dev, X, model):
    """{name: (x, row_ptr, mask, g, mx, den)} on the card: K3's forward
    takes x, row_ptr and mask, its backward also g and the plain version's
    mx and den."""
    import numpy as np
    import torch
    from chip_smoke import GRAPHCONV, misaligned, recorded
    from deepchem_tpu_torch.ops import segment
    batch = X[:GRAPHCONV['batch_size']]
    (x, row_ptr, mask), = recorded(segment, 'graph_max_pool',
                                   lambda: model.predict_on_batch(batch))
    gen = torch.Generator(dev).manual_seed(3)
    rng = np.random.RandomState(1)
    out = {}

    def add(name, x, row_ptr, mask):
        _, mx, den = segment.graph_max_pool_reference(x, row_ptr, mask)
        g = torch.randn(mx.shape, generator=gen, device=dev)
        out[name] = (x, row_ptr, mask, g, mx, den)

    add('graphconv_batch256_readout', x, row_ptr, mask)
    add('graphconv_batch256_readout_misaligned', misaligned(x), row_ptr,
        mask)
    sizes = []
    while sum(sizes) < 980:
        sizes.append(min(int(rng.randint(0, 36)), 980 - sum(sizes)))
    rp = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]),
                      dtype=torch.int32, device=dev)
    n = sum(sizes) + 20
    m = (torch.arange(n, device=dev) < sum(sizes)).float()
    m[::50] = 0.0
    for F in (37, 75, 128):
        add(f'graphs_0_35_N1000_F{F}', torch.from_numpy(
            rng.randn(n, F).astype(np.float32)).to(dev), rp, m)
    add('ties_graphs_0_35_N1000_F128', torch.from_numpy(
        rng.randint(-3, 3, (n, 128)).astype(np.float32)).to(dev), rp, m)
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
    """The C entries' float4 launches so far: K1, K2's backward, K2's
    forward, K3's forward, K3's backward (0 where a version does not count
    them)."""
    table = (ctypes.c_longlong * 3)()
    pool = (ctypes.c_longlong * 2)()
    if 'nei_table_float4_launches' in fns:
        fns['nei_table_float4_launches'](table)
    if 'graph_pool_float4_launches' in fns:
        fns['graph_pool_float4_launches'](pool)
    return tuple(table) + tuple(pool)


def lanes_for(cols: int) -> int:
    lanes = 1
    while lanes < min(cols, 32):
        lanes *= 2
    return lanes


def grid(n: int, F: int, float4: bool) -> int:
    """Blocks of the base K1 and K2 for ``n`` rows of ``F`` floats: a
    group of lanes a node, the least power of two >= the row's units
    (floats or float4s), at most 32 (``layout_for`` in ``nei_table.cu``)."""
    nodes = THREADS // lanes_for(F // 4 if float4 else F)
    return (n + nodes - 1) // nodes


def pool_threads(F: int) -> int:
    """Threads of a block of K3's backward before its redesign
    (``threads_for`` in that ``graph_pool.cu``): the parent's grid."""
    return min(max(32, (F + 31) // 32 * 32), 128)


def held(name, case, part, got, ref, exact=False):
    """``got`` against the plain version's ``ref``: bit for bit for the
    base's kernels that add in the plain version's order, else equal
    values where ``exact``, else within ``chip_smoke.sum_tol``."""
    from chip_smoke import max_err, same_bits, same_values, sum_tol
    if name == 'base' and part in BITS_OF_BASE:
        ok = same_bits(got, ref)
    elif exact:
        ok = same_values(got, ref)
    else:
        ok = max_err(got, ref) <= sum_tol(ref)
    if not ok:
        raise RuntimeError(f'{name} {case} {part}: differs from the plain '
                           f'version, error {max_err(got, ref)}')


# the base kernels that give their plain versions' bits
BITS_OF_BASE = ('nei_sum', 'nei_max_bwd', 'graph_max_pool_bwd')
# the kernels whose zeros may differ in sign from a version before the
# repair of their signed zeros
ZERO_SIGNS_REPAIRED = ('nei_sum', 'nei_max_bwd')


def run_table(name, fns, empty, case, inputs, calls, times, outs, paths):
    import torch
    from deepchem_tpu_torch.ops.nei_table import (
        nei_max_backward_reference, nei_max_reference, nei_sum_reference)
    h, hm, g, table, deg, winner = inputs
    N, F = h.shape
    K = table.shape[1]
    out, best, grad = (torch.empty_like(a) for a in (h, hm, g))
    win = torch.empty(hm.shape, dtype=torch.int32, device=h.device)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    rows = (N,) if fns['nei_sum_rows'] else ()
    runs = {
        'nei_sum': lambda: fns['nei_sum_f32'](
            h.data_ptr(), table.data_ptr(), deg.data_ptr(), out.data_ptr(),
            *rows, N, K, F, stream()),
        'nei_max_fwd': lambda: fns['nei_max_fwd_f32'](
            hm.data_ptr(), table.data_ptr(), deg.data_ptr(), best.data_ptr(),
            win.data_ptr(), N, K, hm.shape[1], stream()),
        'nei_max_bwd': lambda: fns['nei_max_bwd_f32'](
            g.data_ptr(), table.data_ptr(), deg.data_ptr(),
            winner.data_ptr(), grad.data_ptr(), N, K, g.shape[1],
            stream())}
    before = float4_counts(fns)
    if any(run() for run in runs.values()):
        raise RuntimeError(f'{name}: a launch failed at {case}')
    after = float4_counts(fns)
    paths[case] = {part: 'float4' if after[i] > before[i] else 'float'
                   for part, i in (('nei_sum', 0), ('nei_max_fwd', 2),
                                   ('nei_max_bwd', 1))}
    torch.cuda.synchronize()
    outs[case] = {'nei_sum': (out.clone(),),
                  'nei_max_fwd': (best.clone(), win.clone()),
                  'nei_max_bwd': (grad.clone(),)}
    ref_best, ref_win = nei_max_reference(hm, table, deg)
    held(name, case, 'nei_sum', out, nei_sum_reference(h, table, deg))
    held(name, case, 'nei_max_fwd', best, ref_best, exact=True)
    if not torch.equal(win, ref_win):
        raise RuntimeError(f'{name} {case}: K2 winners differ')
    held(name, case, 'nei_max_bwd', grad,
         nei_max_backward_reference(g, table, deg, winner))
    times[case] = {part: timed(run, f'{part}_kernel', calls)
                   for part, run in runs.items()}
    float4 = paths[case]['nei_sum'] == 'float4'
    for label, blocks in (('empty_base_grid', grid(N, F, float4)),
                          ('empty_parent_grid', grid(N, 32, False))):
        times[case][label] = dict(timed(
            lambda: empty(blocks, THREADS, stream()), 'empty_kernel',
            calls), blocks=blocks, threads=THREADS)


def run_edges(name, fns, empty, case, inputs, calls, times, outs, paths):
    """K1 alone from R edge rows into the table's N nodes."""
    import torch
    from deepchem_tpu_torch.ops.nei_table import nei_sum_reference
    h, table, deg = inputs
    R, F = h.shape
    N, K = table.shape
    out = torch.empty((N, F), device=h.device)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    rows = (R,) if fns['nei_sum_rows'] else ()

    def run():
        return fns['nei_sum_f32'](h.data_ptr(), table.data_ptr(),
                                  deg.data_ptr(), out.data_ptr(), *rows, N,
                                  K, F, stream())
    before = float4_counts(fns)
    if run():
        raise RuntimeError(f'{name}: a launch failed at {case}')
    paths[case] = {'nei_sum': 'float4' if float4_counts(fns)[0] > before[0]
                   else 'float'}
    torch.cuda.synchronize()
    outs[case] = {'nei_sum': (out.clone(),)}
    held(name, case, 'nei_sum', out, nei_sum_reference(h, table, deg))
    times[case] = {'nei_sum': timed(run, 'nei_sum_kernel', calls)}
    blocks = grid(N, F, paths[case]['nei_sum'] == 'float4')
    times[case]['empty_base_grid'] = dict(timed(
        lambda: empty(blocks, THREADS, stream()), 'empty_kernel', calls),
        blocks=blocks, threads=THREADS)


def run_pool(name, fns, empty, case, inputs, calls, times, outs, paths):
    import torch
    from deepchem_tpu_torch.ops.segment import (
        graph_max_pool_backward_reference, graph_max_pool_reference)
    x, row_ptr, mask, g, mx_in, den_in = inputs
    N, F = x.shape
    G = row_ptr.shape[0] - 1
    out, mx, den = (torch.empty_like(g) for _ in range(3))
    dx = torch.empty_like(x)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    runs = {
        'graph_max_pool_fwd': lambda: fns['graph_max_pool_fwd_f32'](
            x.data_ptr(), row_ptr.data_ptr(), mask.data_ptr(),
            out.data_ptr(), mx.data_ptr(), den.data_ptr(), G, N, F,
            stream()),
        'graph_max_pool_bwd': lambda: fns['graph_max_pool_bwd_f32'](
            g.data_ptr(), x.data_ptr(), row_ptr.data_ptr(), mask.data_ptr(),
            mx_in.data_ptr(), den_in.data_ptr(), dx.data_ptr(), G, N, F,
            stream())}
    before = float4_counts(fns)
    if any(run() for run in runs.values()):
        raise RuntimeError(f'{name}: a launch failed at {case}')
    after = float4_counts(fns)
    paths[case] = {part: 'float4' if after[i] > before[i] else 'float'
                   for part, i in (('graph_max_pool_fwd', 3),
                                   ('graph_max_pool_bwd', 4))}
    torch.cuda.synchronize()
    outs[case] = {'graph_max_pool_fwd': (out.clone(), mx.clone(),
                                         den.clone()),
                  'graph_max_pool_bwd': (dx.clone(),)}
    ref, ref_mx, ref_den = graph_max_pool_reference(x, row_ptr, mask)
    held(name, case, 'graph_max_pool_fwd', out, ref)
    if not (torch.equal(mx, ref_mx) and torch.equal(den, ref_den)):
        raise RuntimeError(f'{name} {case}: K3 mx or den differs')
    held(name, case, 'graph_max_pool_bwd', dx,
         graph_max_pool_backward_reference(g, x, row_ptr, mask, mx_in,
                                           den_in))
    times[case] = {part: timed(run, f'{part}_kernel', calls)
                   for part, run in runs.items()}
    for label, blocks, threads in (
            ('empty_base_grid', G, POOL_THREADS),
            ('empty_parent_grid', G, pool_threads(F))):
        times[case][label] = dict(timed(
            lambda: empty(blocks, threads, stream()), 'empty_kernel',
            calls), blocks=blocks, threads=threads)


def run_version(name: str, fns: dict, empty, tables: dict, pools: dict,
                edges: dict, calls: int) -> tuple:
    """({case: {part: timings}}, {case: {part: outputs}}, {case: {part:
    path}}) of one version."""
    times, outs, paths = {}, {}, {}
    for case, inputs in tables.items():
        run_table(name, fns, empty, case, inputs, calls, times, outs, paths)
        print(f'{name} {case}: timed', file=sys.stderr, flush=True)
    for case, inputs in edges.items():
        run_edges(name, fns, empty, case, inputs, calls, times, outs, paths)
        print(f'{name} {case}: timed', file=sys.stderr, flush=True)
    for case, inputs in pools.items():
        run_pool(name, fns, empty, case, inputs, calls, times, outs, paths)
        print(f'{name} {case}: timed', file=sys.stderr, flush=True)
    return times, outs, paths


def library_us(tables: dict, pools: dict, edges: dict, calls: int) -> dict:
    """{case: {call: device µs}} of the library calls, every kernel of one
    call (``chip_smoke.device_us_all``; null where the profiler recorded
    none), and the µs a call between CUDA events around 200 calls
    (``chip_smoke.time_ms``)."""
    from chip_smoke import (device_us_all, library_graph_max,
                            library_nei_max, library_nei_max_bwd,
                            library_nei_sum, table_csr, time_ms)
    calls_of = {}
    for case, (h, hm, g, table, deg, winner) in tables.items():
        src, dst, row_ptr, col = table_csr(table, deg)
        winner_idx = winner.long()
        calls_of[case] = {
            'sparse_mm': lambda h=h, r=row_ptr, c=col: library_nei_sum(
                h, r, c),
            'scatter_reduce_amax': lambda h=hm, s=src, d=dst:
            library_nei_max(h, s, d),
            'scatter_add': lambda g=g, w=winner_idx: library_nei_max_bwd(
                g, w)}
    for case, (h, table, deg) in edges.items():
        _, _, row_ptr, col = table_csr(table, deg)
        calls_of[case] = {
            'sparse_mm': lambda h=h, r=row_ptr, c=col: library_nei_sum(
                h, r, c)}
    for case, (x, row_ptr, mask, g, mx, den) in pools.items():
        rows = int(row_ptr[-1])
        lengths = (row_ptr[1:] - row_ptr[:-1]).long()
        calls_of[case] = {
            'segment_reduce_max': lambda x=x, n=lengths, r=rows:
            library_graph_max(x, n, r)}
    out = {}
    for case, fns in calls_of.items():
        out[case] = {}
        for call, fn in fns.items():
            try:
                dev = device_us_all(fn, calls)[0]
            except RuntimeError as err:
                print(f'{case} {call}: {err}', file=sys.stderr, flush=True)
                dev = None
            out[case][call] = {'device_us': dev,
                               'event_us': time_ms(fn) * 1e3}
    return out


def bounds(tables: dict, pools: dict, edges: dict) -> dict:
    """{case: {'N', 'F', 'bound_us': {part: µs}}}: the bytes and
    operations of each kernel as ``chip_smoke.py`` phase 3 counts them."""
    from chip_smoke import bound, table_csr
    info = {}
    for case, (h, hm, g, table, deg, winner) in tables.items():
        src, _, _, _ = table_csr(table, deg)
        N, F = h.shape
        slots, rows = src.numel(), src.unique().numel()
        tbl = 4 * slots + N
        info[case] = {'N': N, 'F': F, 'K': table.shape[1], 'slots': slots,
                      'bound_us': {
                          'nei_sum': bound(4 * (rows * F + slots + N * F)
                                           + N, slots * F)[0] * 1e3,
                          'nei_max_fwd': bound(4 * 3 * N * hm.shape[1] + tbl,
                                               slots * hm.shape[1])[0] * 1e3,
                          'nei_max_bwd': bound(4 * 3 * N * g.shape[1] + tbl,
                                               slots * g.shape[1])[0] * 1e3}}
    for case, (h, table, deg) in edges.items():
        src, _, _, _ = table_csr(table, deg)
        R, F = h.shape
        N = table.shape[0]
        slots, rows = src.numel(), src.unique().numel()
        info[case] = {'N': N, 'R': R, 'F': F, 'K': table.shape[1],
                      'slots': slots, 'bound_us': {'nei_sum': bound(
                          4 * (rows * F + slots + N * F) + N,
                          slots * F)[0] * 1e3}}
    for case, (x, row_ptr, mask, g, mx, den) in pools.items():
        N, F = x.shape
        G = row_ptr.shape[0] - 1
        rows = int(row_ptr[-1])
        common = 4 * (rows * F + rows + G + 1)
        info[case] = {'N': N, 'F': F, 'G': G, 'rows': rows, 'bound_us': {
            'graph_max_pool_fwd': bound(common + 4 * 3 * G * F,
                                        2 * rows * F)[0] * 1e3,
            'graph_max_pool_bwd': bound(common + 4 * 3 * G * F + 4 * N * F,
                                        rows * F)[0] * 1e3}}
    return info


def compare(a: tuple, b: tuple) -> str:
    """'bits' where each pair of tensors is equal bit for bit,
    'zero_signs' where they differ only in the signs of zeros (equal as
    values, none NaN), else 'values'."""
    import torch
    if all(torch.equal(x.view(torch.int32), y.view(torch.int32))
           for x, y in zip(a, b)):
        return 'bits'
    return 'zero_signs' if all(torch.equal(x, y) for x, y in zip(a, b)) \
        else 'values'


def mean(values):
    values = [v for v in values if v is not None]
    return sum(values) / len(values) if values else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--parent', type=Path)
    ap.add_argument('--parent-pool', type=Path)
    ap.add_argument('--version', action='append', default=[],
                    metavar='NAME=FILE')
    ap.add_argument('--pool-version', action='append', default=[],
                    metavar='NAME=FILE')
    ap.add_argument('--calls', type=int, default=20)
    args = ap.parse_args()
    import torch
    from chip_smoke import GRAPHCONV, graphconv_data
    from deepchem_tpu_torch import GraphConvModel
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / 'empty.cu').write_text(EMPTY_CU)
    sources = {'base': CSRC / 'nei_table.cu',
               'base_pool': CSRC / 'graph_pool.cu', 'empty': OUT / 'empty.cu'}
    pool_of = {'base': 'base_pool'}
    given = [('parent', args.parent)] if args.parent else []
    given += [tuple(v.split('=', 1)) for v in args.version]
    pool_given = [tuple(v.split('=', 1)) for v in args.pool_version]
    others = [n for n, _ in given + pool_given if n != 'parent']
    for n, path in given:
        sources[n] = OUT / f'{n}.cu'
        sources[n].write_text(Path(path).read_text())
        pool_of[n] = 'base_pool'
    table_of = {n: n for n in pool_of}
    for n, path in pool_given:
        sources[f'{n}_pool'] = OUT / f'{n}_pool.cu'
        sources[f'{n}_pool'].write_text(Path(path).read_text())
        pool_of[n], table_of[n] = f'{n}_pool', 'base'
    if args.parent and args.parent_pool:
        sources['parent_pool'] = OUT / 'parent_pool.cu'
        sources['parent_pool'].write_text(args.parent_pool.read_text())
        pool_of['parent'] = 'parent_pool'
    name = card()
    print(name, flush=True)
    for n, rep in nvcc(sources).items():
        print(json.dumps({'version': n, 'registers_spills': rep}),
              flush=True)
    dev = torch.device('cuda', 0)
    X, _ = graphconv_data()
    model = GraphConvModel(**GRAPHCONV, device=dev, seed=0)
    tables = table_cases(dev, X, model)
    pools = pool_cases(dev, X, model)
    edges = edge_cases(dev)
    print(json.dumps({'card': name, 'cases': bounds(tables, pools, edges)}),
          flush=True)
    empty = entries('empty')['empty_launch']
    fns = {n: entries(table_of.get(n, n), pool,
                      rows=rows_arg(sources[table_of.get(n, n)]))
           for n, pool in pool_of.items()}
    outer = ['parent'] if args.parent else []
    order = outer + others + ['base', 'base'] + others[::-1] + outer
    print(json.dumps({'card': name,
                      'library_us': library_us(tables, pools, edges,
                                               args.calls)}),
          flush=True)
    runs = {n: [] for n in fns}
    first_outs = {}
    for n in order:
        times, outs, paths = run_version(n, fns[n], empty, tables, pools,
                                         edges, args.calls)
        runs[n].append(times)
        first_outs.setdefault(n, outs)
        print(json.dumps({'card': name, 'version': n, 'run': len(runs[n]),
                          'paths': paths, 'us': times}),
              flush=True)
    base = first_outs['base']
    identical = {n: {case: {part: compare(base[case][part], outs[case][part])
                            for part in base[case]} for case in base}
                 for n, outs in first_outs.items() if n != 'base'}
    if identical:
        print(json.dumps({'base_against_each_version': identical}),
              flush=True)
    print(json.dumps({'card': name, 'mean_us': {
        n: {case: {part: {x: mean([r[case][part][x] for r in rs])
                          for x in rs[0][case][part]}
                   for part in rs[0][case]}
            for case in rs[0]}
        for n, rs in runs.items()}}), flush=True)
    print(name, flush=True)
    if any(got == 'values' or (got == 'zero_signs'
                               and part not in ZERO_SIGNS_REPAIRED)
           for per in identical.values() for v in per.values()
           for part, got in v.items()):
        print('outputs differ between versions', file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
