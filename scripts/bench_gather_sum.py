#!/usr/bin/env python3
"""Device and host time of P2, ``fused_gather_segment_sum``, in float32
or bfloat16: the source as it is, other versions of it (a parent
commit's) and variants of its tuning constants, in turns on one card,
beside the library call at the same inputs.

    python3 scripts/bench_gather_sum.py [--dtype f32|bf16]
        [--parent NAME=FILE ...]
        [--variant NAME:kSplitEdges=64,kAheadOwn=0/2/2/2/2 ...]
        [--calls 20] [--check-only] [--cases REGEX]

Each version of ``deepchem_tpu_torch/csrc/fused_gather_segment_sum.cu``
is compiled by nvcc with the package's flags into
``build/bench_gather_sum/<name>.so`` (all at once; ``-I`` the package's
``csrc/`` for its header) and called through its C entry
``fused_gather_segment_sum_f32``.  Each ``--parent`` names another file
with that entry (a parent commit's); a variant is the source with the
named ``constexpr int`` constants set to other values.  The versions run
parents, base, variants, then the same in reverse, and the two runs of
each are averaged.

Cases: the inputs ``chip_smoke.py`` phase 3 records P2 at (GNNModular's
GCN layers at F 30 and 64 and a backward's transpose, PNA's edge sums,
GraphConv's COO neighbour sum and its neighbour max's transpose at batch
256, DMPNN's COO edge sums ``[4096, 300]`` at batch 100, recorded from
the same models and batches, and the longest ghost range of DMPNN COO's
``fit`` epoch, ``chip_smoke.dmpnn_coo_fit_p2_inputs``), its five bench
shapes and its two synthetic long segments
(``chip_smoke.p2_long_inputs``).  Every version is checked against the
plain version in float64 (``chip_smoke.sum_tol``) and for a
bit-identical repeat before it is timed.  Per run and case it prints the
profiler's device µs a launch (``chip_smoke.device_us``; null where no
profile counted), the µs a call between CUDA events around 200
back-to-back calls (``chip_smoke.time_ms``) and the host µs a call (200
calls, no synchronise); per case the library call's device µs
(``chip_smoke.device_us_all``, before the first run and after the last).
The card's name and power limit come first, then each version's ptxas
registers and spill bytes, a JSON line of means last; that line is also
written to ``chiprun_out/bench_gather_sum.json``.

``--dtype bf16`` does the same for the bfloat16 entry
``fused_gather_segment_sum_bf16`` (``fused_gather_segment_sum_bf16_kernel``)
at ``chip_smoke.py`` phase 3's bfloat16 cases: the five bench shapes, F 37,
F 64 off 16-byte alignment, the two long segments and the non-finite
inputs (``chip_smoke.p2_bf16_non_finite_inputs``).  Every version is held
bit for bit against the plain version (``chip_smoke.bf16_same``; a
version whose bits differ only at NaN is reported and still timed, one
that differs elsewhere stops the run) and for a bit-identical repeat
before it is timed; the library call is ``index_select`` then
``index_add_`` in bfloat16.  For each version with a
``p2_bf16_add_chain`` entry it also prints the latency of one dependent
add (``chip_smoke.bf16_add_ns``).  ``--check-only`` builds,
prints ptxas's report and the checks, and times nothing; ``--cases``
keeps the cases whose names match a regular expression.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

from bench_flash import host_us, nvcc, profiled_us

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
CSRC = REPO / 'deepchem_tpu_torch' / 'csrc'
OUT = REPO / 'build' / 'bench_gather_sum'
HOST_CALLS = 200
KERNEL = r'fused_gather_segment_sum_kernelI\w+?(?:Li\d+)?E'
BF16_KERNEL = (r'fused_gather_segment_sum_bf16_kernelI(?:Li\d+E)+'
               r'|fused_gather_segment_sum_bf16_kernelI\d+\w+?E')


def model_cases(dev):
    """{name: (h, src, row_ptr)} as the models hand them to P2, recorded
    as ``chip_smoke.py`` phase 3 records them."""
    import numpy as np
    from chip_smoke import (DMPNN, GNN_REGRESSION, GRAPHCONV, PNA, SMILES,
                            STEREO_SMILES, coo_branch,
                            dmpnn_coo_fit_p2_inputs, graphconv_data,
                            recorded, table_data)
    from deepchem_tpu_torch import (DMPNNFeaturizer, DMPNNModel,
                                    GNNModular, GraphConvModel,
                                    MolGraphConvFeaturizer, PNAModel)
    from deepchem_tpu_torch.ops import csr_segment

    def record(run):
        return recorded(csr_segment, '_gather_sum_forward', run)

    def backward(seen):
        return [a for a in seen if a[3:] == ('backward_launches',)]
    gnn_X, gnn_y = table_data(MolGraphConvFeaturizer(), SMILES)
    dm_X, _ = table_data(DMPNNFeaturizer(), SMILES + STEREO_SMILES)
    gc_X, gc_labels = graphconv_data()
    B = 100
    gnn = GNNModular(**GNN_REGRESSION, device=dev, seed=0)
    gnn_fwd = record(lambda: gnn.predict_on_batch(gnn_X[:B]))
    gnn_bwd = backward(record(lambda: gnn.fit_on_batch(
        gnn_X[:B], gnn_y[:B], np.ones_like(gnn_y[:B]))))
    pna = PNAModel(**PNA, device=dev, seed=0)
    pna_in = record(lambda: pna.predict_on_batch(gnn_X[:B]))
    with coo_branch(GraphConvModel):
        gc = GraphConvModel(**GRAPHCONV, device=dev, seed=0)
        gcb = gc_X[:GRAPHCONV['batch_size']]
        gc_in = record(lambda: gc.predict_on_batch(gcb))
        gc_bwd = backward(record(lambda: gc.fit_on_batch(
            gcb, gc_labels[:len(gcb)], np.ones_like(gc_labels[:len(gcb)]))))
    with coo_branch(DMPNNModel):
        dm = DMPNNModel(**DMPNN, device=dev, seed=0)
        dm_in = record(lambda: dm.predict_on_batch(dm_X[:B]))
    dm_fit = [a for a in dmpnn_coo_fit_p2_inputs(dev) if not a[3:]]
    dm_fit_longest = max(dm_fit, key=lambda a: int(a[2][-1] - a[2][-2]))
    return {'gnn_batch100_layer0': gnn_fwd[0][:3],
            'gnn_batch100_layer1': gnn_fwd[1][:3],
            'gnn_batch100_layer2_backward': gnn_bwd[0][:3],
            'pna_batch100_edge_sum': pna_in[0][:3],
            'graphconv_coo_batch256_layer0': gc_in[0][:3],
            'graphconv_coo_batch256_pool_max_backward': gc_bwd[-1][:3],
            'dmpnn_coo_batch100_edge_sum': dm_in[0][:3],
            'dmpnn_coo_fit_batch100_edge_sum': dm_fit_longest[:3]}


def cases(dev):
    import numpy as np
    from chip_smoke import P2_BENCH_SHAPES, bench_graph, p2_long_inputs
    rng = np.random.RandomState(0)
    out = model_cases(dev)
    out.update({f'bench_N{n}_E{e}_F{f}': tuple(bench_graph(rng, n, e, f,
                                                           dev))
                for n, e, f in P2_BENCH_SHAPES})
    out.update(p2_long_inputs(dev))
    return out


def bf16_cases(dev):
    """{name: (h, src, row_ptr)} at ``chip_smoke.py`` phase 3's bfloat16
    inputs."""
    import numpy as np
    import torch
    from chip_smoke import (P2_BENCH_SHAPES, bench_graph, p2_long_inputs,
                            p2_bf16_non_finite_inputs)
    rng = np.random.RandomState(0)
    out = {}
    for n, e, f in P2_BENCH_SHAPES:
        h, src, rp = bench_graph(rng, n, e, f, dev)
        out[f'bench_N{n}_E{e}_F{f}_bf16'] = (h.to(torch.bfloat16), src, rp)
    h, src, rp = bench_graph(rng, 2048, 4096, 37, dev)
    out['F37_bf16'] = (h.to(torch.bfloat16), src, rp)
    h, src, rp = bench_graph(rng, 2048, 4096, 64, dev)
    flat = torch.empty(h.numel() + 1, dtype=torch.bfloat16, device=dev)
    flat[1:] = h.reshape(-1).to(torch.bfloat16)
    out['F64_unaligned_bf16'] = (flat[1:].view(h.shape), src, rp)
    for k, (h, src, rp) in p2_long_inputs(dev).items():
        out[f'{k}_bf16'] = (h.to(torch.bfloat16), src, rp)
    for f, aligned in ((64, True), (64, False), (37, True)):
        out[f'non_finite_F{f}{"" if aligned else "_unaligned"}_bf16'] = \
            p2_bf16_non_finite_inputs(dev, f, aligned)
    return out


def variant_source(base: str, spec: str) -> str:
    """``base`` with each ``constexpr int NAME = ...;`` of ``spec``
    (``NAME=VALUE,...``) set to VALUE; an array's VALUE is its entries
    joined by ``/``."""
    for item in spec.split(','):
        name, value = item.split('=')
        value = '{%s}' % ', '.join(str(int(v)) for v in value.split('/')) \
            if '/' in value else str(int(value))
        base, n = re.subn(rf'constexpr int {name}(\[[^\]]*\])? = [^;]+;',
                          rf'constexpr int {name}\g<1> = {value};', base)
        if n != 1:
            raise SystemExit(f'bench_gather_sum: no constant {name}')
    return base


def library_us(inputs: dict, calls: int, bf16: bool) -> dict:
    import torch
    from chip_smoke import (device_us_all, library_neighbor_sum,
                            library_neighbor_sum_bf16)
    out = {}
    for case, (h, src, rp) in inputs.items():
        if bf16:
            used, N = int(rp[-1]), rp.shape[0] - 1
            dst = torch.searchsorted(rp[1:], torch.arange(
                used, dtype=torch.int32, device=h.device), right=True)
            lib_src = src[:used].long()
            out[case] = device_us_all(lambda: library_neighbor_sum_bf16(
                h, lib_src, dst, N), calls=calls)[0]
        else:
            out[case] = device_us_all(
                lambda: library_neighbor_sum(h, src, rp), calls=calls)[0]
    return out


def check_bf16(name, case, res, first, ref) -> dict:
    """The bfloat16 checks of one version at one case; raises where bits
    differ at anything but NaN, or a repeat differs."""
    import torch
    from chip_smoke import bf16_same
    same, same_but_nan = bf16_same(first, ref)
    repeat = torch.equal(first.view(torch.int16), res.view(torch.int16))
    if not same_but_nan or not repeat:
        raise RuntimeError(f'{name} {case}: bits equal {same}, NaN where '
                           f'NaN and the rest equal {same_but_nan}, repeat '
                           f'identical {repeat}')
    return {'bits_equal': same, 'nan_where_nan_rest_equal': same_but_nan}


def time_version(name: str, inputs: dict, calls: int, bf16: bool,
                 timed: bool = True) -> dict:
    import torch
    from chip_smoke import device_us, sum_tol, time_ms
    from deepchem_tpu_torch.ops.csr_segment import csr_neighbor_sum_reference
    entry = 'fused_gather_segment_sum_bf16' if bf16 \
        else 'fused_gather_segment_sum_f32'
    fn = getattr(ctypes.CDLL(str(OUT / f'{name}.so')), entry)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for case, (h, src, row_ptr) in inputs.items():
        N, (Nh, F), E = row_ptr.shape[0] - 1, h.shape, src.shape[0]
        res = h.new_empty((N, F))

        def run():
            return fn(h.data_ptr(), src.data_ptr(), row_ptr.data_ptr(),
                      res.data_ptr(), N, Nh, E, F, stream)
        if run():
            raise RuntimeError(f'{name}: launch failed at {case}')
        first = res.clone()
        run()
        torch.cuda.synchronize()
        if bf16:
            out[case] = check_bf16(name, case, res, first,
                                   csr_neighbor_sum_reference(h, src,
                                                              row_ptr))
        else:
            ref = csr_neighbor_sum_reference(h.double(), src, row_ptr)
            err = (res.double() - ref).abs().max().item()
            if err > sum_tol(ref) or not torch.equal(first, res):
                raise RuntimeError(f'{name} {case}: error {err}, repeat '
                                   f'identical {torch.equal(first, res)}')
            out[case] = {'max_abs_err': err}
        if timed:
            out[case].update({
                'device_us': profiled_us(
                    device_us, run, 'fused_gather_segment_sum_bf16_kernel'
                    if bf16 else 'fused_gather_segment_sum_kernel', calls),
                'event_us': time_ms(run, HOST_CALLS) * 1e3,
                'host_us': host_us(run, HOST_CALLS)})
    return out


def add_latency(name: str, dev):
    """ns a dependent add of the version's own, or None where its library
    has no ``p2_bf16_add_chain``."""
    import torch
    from chip_smoke import bf16_add_ns
    lib = ctypes.CDLL(str(OUT / f'{name}.so'))
    if not hasattr(lib, 'p2_bf16_add_chain'):
        return None
    chain = lib.p2_bf16_add_chain
    chain.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    chain.restype = ctypes.c_int
    torch.cuda.synchronize()
    return bf16_add_ns(dev, chain)


def mean(xs):
    xs = [x for x in xs if x is not None]
    return sum(xs) / len(xs) if xs else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--dtype', choices=('f32', 'bf16'), default='f32')
    ap.add_argument('--parent', action='append', default=[],
                    help='NAME=FILE, another source with the same entry')
    ap.add_argument('--variant', action='append', default=[],
                    help='NAME:CONST=VALUE,... (constants of the source)')
    ap.add_argument('--calls', type=int, default=20)
    ap.add_argument('--check-only', action='store_true',
                    help='build, check and print ptxas; time nothing')
    ap.add_argument('--cases', default='',
                    help='only the cases whose names match this regex')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('bench_gather_sum: no CUDA device', file=sys.stderr)
        return 1
    bf16 = args.dtype == 'bf16'
    OUT.mkdir(parents=True, exist_ok=True)
    base = (CSRC / 'fused_gather_segment_sum.cu').read_text()
    sources = {}
    for v in args.parent:
        name, path = v.split('=', 1)
        sources[name] = Path(path).read_text()
    sources['base'] = base
    for v in args.variant:
        name, spec = v.split(':', 1)
        sources[name] = variant_source(base, spec)
    paths = {}
    for name, text in sources.items():
        paths[name] = OUT / f'{name}.cu'
        paths[name].write_text(text)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    print(json.dumps({'ptxas': nvcc(paths, OUT,
                                    BF16_KERNEL if bf16 else KERNEL)}),
          flush=True)
    dev = torch.device('cuda', 0)
    inputs = {k: v for k, v in (bf16_cases(dev) if bf16
                                else cases(dev)).items()
              if re.search(args.cases, k)}
    print(json.dumps({'cases': {k: [list(h.shape), src.shape[0],
                                    rp.shape[0] - 1]
                                for k, (h, src, rp) in inputs.items()}}),
          flush=True)
    names = list(sources)
    if bf16:
        print(json.dumps({'add_ns': {n: add_latency(n, dev)
                                     for n in names}}), flush=True)
    if args.check_only:
        for n in names:
            print(json.dumps({'version': n, 'checks': time_version(
                n, inputs, args.calls, bf16, timed=False)}), flush=True)
        return 0
    library = [library_us(inputs, args.calls, bf16)]
    runs = {n: [] for n in names}
    for n in names + names[::-1]:
        runs[n].append(time_version(n, inputs, args.calls, bf16))
        print(json.dumps({'version': n, 'run': len(runs[n]),
                          'us': runs[n][-1]}), flush=True)
    library.append(library_us(inputs, args.calls, bf16))
    line = json.dumps({
        'device': torch.cuda.get_device_name(0),
        'library_device_us': {c: sum(r[c] for r in library) / 2
                              for c in inputs},
        'mean_us': {n: {c: {x: mean([r[c][x] for r in rs])
                            for x in ('device_us', 'event_us', 'host_us')}
                        for c in inputs} for n, rs in runs.items()}})
    print(line)
    (REPO / 'chiprun_out').mkdir(exist_ok=True)
    (REPO / 'chiprun_out' / 'bench_gather_sum.json').write_text(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
