#!/usr/bin/env python3
"""Device and host time of P1, ``csr_segment_softmax``: the source as it is
and optionally other versions of it (parent commits'), in turns on one
card, at the shapes PAGTN hands it.

    python3 scripts/bench_csr_softmax.py [--parent NAME=FILE ...] [--calls 20]

Each version of ``deepchem_tpu_torch/csrc/csr_segment_softmax.cu`` is
compiled by nvcc with the package's flags into
``build/bench_csr_softmax/<name>.so`` (all at once) and called through its
C entry ``csr_segment_softmax_f32``: ``base`` is the source as it is, and
each ``--parent`` names another file.  The runs go parents, base, base,
parents in reverse, and the two runs of each version are averaged.

Cases: the logits and ``row_ptr`` that ``PagtnModel(n_tasks=12,
mode='classification')`` at its defaults hands P1 in its first layer for a
batch of 16 of ``chip_smoke.py``'s molecules (``[6144, 1]``, recorded from
``predict_on_batch``); ``[16384, 8]`` over 2048 random segments; a
ghost-like segment of 1536 edges after 300 short ones (H 1); one segment
of 40 000 edges among 511 short ones (H 1).  Per run and case it prints the
profiler's device µs a launch (``chip_smoke.device_us``; null where no
profile passed its checks), the µs a call between CUDA events around 200
back-to-back calls (the card's time where the kernel outlasts the host's
call) and the host µs a call (200 back-to-back calls, no synchronise),
after checking each version against the plain version in float64 (in
float32 the plain version's own sums drift on long segments).  Every
other version's outputs must equal the base's bit for bit in these
finite cases, or the script exits 1.  One more case, not timed, holds
each version at ``chip_smoke.softmax_non_finite_inputs`` (+inf, NaN,
-inf and overflowing logits on each path of the kernel, H 3) to
``chip_smoke.softmax_non_finite_ok`` (``non_finite_parity``); the base
must pass it.  The card's
name, power limit, SM clock and driver come first, a JSON line of means
last.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))
CSRC = REPO / 'deepchem_tpu_torch' / 'csrc'
OUT = REPO / 'build' / 'bench_csr_softmax'
HOST_CALLS = 200
KERNEL_ATOL = 1e-6              # chip_smoke.py's limit for P1


def long_segments(rng, short, long_len):
    """``row_ptr`` of ``short`` segments of 0 to 33 edges, then one of
    ``long_len``."""
    import numpy as np
    lengths = list(rng.randint(0, 34, short)) + [long_len]
    return np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)


def cases(dev):
    """{name: (logits, row_ptr)} on the card."""
    import numpy as np
    import torch
    from chip_smoke import SMILES, recorded
    from deepchem_tpu_torch import PagtnModel, PagtnMolGraphFeaturizer
    from deepchem_tpu_torch.ops import segment
    X = PagtnMolGraphFeaturizer().featurize(SMILES[1:17])
    model = PagtnModel(n_tasks=12, mode='classification', device=dev, seed=0)
    layer0 = recorded(segment, 'csr_segment_softmax',
                      lambda: model.predict_on_batch(X))[0]
    rng = np.random.RandomState(0)
    E, H, N = 16384, 8, 2048
    wide_rp = np.searchsorted(np.sort(rng.randint(0, N, E)),
                              np.arange(N + 1)).astype(np.int32)
    ghost_rp = long_segments(rng, 300, 1536)
    long_rp = long_segments(rng, 511, 40000)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return {
        'pagtn_layer0_6144x1': layer0,
        'wide_16384x8': (t(rng.randn(E, H).astype(np.float32)), t(wide_rp)),
        'ghost_1536_H1': (t(rng.randn(int(ghost_rp[-1]), 1).astype(
            np.float32)), t(ghost_rp)),
        'segment_40000_H1': (t(rng.randn(int(long_rp[-1]), 1).astype(
            np.float32)), t(long_rp))}


def time_version(name: str, inputs: dict, non_finite: tuple,
                 calls: int) -> tuple:
    """({case: timings}, {case: output}, non-finite parity) of one
    version."""
    import torch
    from bench_flash import host_us, profiled_us
    from chip_smoke import device_us, softmax_non_finite_ok, time_ms
    from deepchem_tpu_torch.ops.csr_segment import \
        csr_segment_softmax_reference
    fn = ctypes.CDLL(str(OUT / f'{name}.so')).csr_segment_softmax_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    out, outs = {}, {}
    for case, (logits, row_ptr) in inputs.items():
        N, (E, H) = row_ptr.shape[0] - 1, logits.shape
        res = torch.empty_like(logits)

        def run():
            return fn(logits.data_ptr(), row_ptr.data_ptr(), res.data_ptr(),
                      N, E, H, stream)
        if run():
            raise RuntimeError(f'{name}: launch failed at {case}')
        torch.cuda.synchronize()
        ref = csr_segment_softmax_reference(logits.double(), row_ptr)
        err = (res - ref).abs().max().item()
        if err > KERNEL_ATOL:
            raise RuntimeError(f'{name} {case}: error {err}')
        outs[case] = res.clone()
        out[case] = {'device_us': profiled_us(
                         device_us, run, 'csr_segment_softmax_kernel', calls),
                     'event_us': time_ms(run, HOST_CALLS) * 1e3,
                     'host_us': host_us(run, HOST_CALLS)}
    logits, row_ptr = non_finite
    y = torch.empty_like(logits)
    if fn(logits.data_ptr(), row_ptr.data_ptr(), y.data_ptr(),
          row_ptr.shape[0] - 1, *logits.shape, stream):
        raise RuntimeError(f'{name}: launch failed at the non-finite case')
    torch.cuda.synchronize()
    return out, outs, softmax_non_finite_ok(y, logits, row_ptr)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--parent', action='append', default=[],
                    metavar='NAME=FILE')
    ap.add_argument('--calls', type=int, default=20)
    args = ap.parse_args()
    import numpy as np
    import torch
    from bench_flash import mean, nvcc
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {'base': CSRC / 'csr_segment_softmax.cu'}
    parents = []
    for spec in args.parent:
        pname, path = spec.split('=', 1)
        sources[pname] = OUT / f'{pname}.cu'
        sources[pname].write_text(Path(path).read_text())
        parents.append(pname)
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit,clocks.sm,'
         'clocks.max.sm,driver_version', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)
    nvcc(sources, OUT)
    from chip_smoke import softmax_non_finite_inputs
    dev = torch.device('cuda', 0)
    inputs = cases(dev)
    non_finite = softmax_non_finite_inputs(np.random.RandomState(5), dev, 3)
    print(json.dumps({'cases': {k: [list(x.shape), r.shape[0] - 1]
                                for k, (x, r) in inputs.items()}}))
    order = parents + ['base', 'base'] + parents[::-1]
    runs = {n: [] for n in sources}
    first_outs, parity = {}, {}
    for n in order:
        times, outs, parity[n] = time_version(n, inputs, non_finite,
                                              args.calls)
        runs[n].append(times)
        first_outs.setdefault(n, outs)
        print(json.dumps({'version': n, 'run': len(runs[n]), 'us': times,
                          'non_finite_parity': parity[n]}), flush=True)
    base = first_outs['base']
    bits = {n: {case: torch.equal(base[case].view(torch.int32),
                                  outs[case].view(torch.int32))
                for case in base}
            for n, outs in first_outs.items() if n != 'base'}
    print(json.dumps({'base_bits_equal_each_version': bits}), flush=True)
    print(json.dumps({'mean_us': {
        n: {case: {x: mean([r[case][x] for r in rs]) for x in rs[0][case]}
            for case in rs[0]}
        for n, rs in runs.items()}}))
    if not parity['base'] or not all(all(v.values())
                                     for v in bits.values()):
        print('the base fails the non-finite case or differs from a '
              'version on finite logits', file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
