#!/usr/bin/env python3
"""Device and host time of P3, ``csr_segment_sum``: the source as it is
and optionally another version of it (a parent commit's), in turns on one
card, at the shapes PAGTN hands it.

    python3 scripts/bench_csr_sum.py [--parent FILE] [--calls 20]

Each version of ``deepchem_tpu_torch/csrc/csr_segment_sum.cu`` is compiled
by nvcc with the package's flags into ``build/bench_csr_sum/<name>.so``
(both at once; ``-I`` the package's ``csrc/`` for its header) and called
through its C entry ``csr_segment_sum_f32``.  With a parent they run
parent, base, base, parent, and the two runs of each are averaged.

Cases: the inputs ``PagtnModel(n_tasks=12, mode='classification')`` at
its defaults hands P3 for a batch of 16 of ``chip_smoke.py``'s molecules
(the aggregation, ``[6144, 32]``, and P1's backward, ``[6144, 1]``),
recorded from ``predict_on_batch`` and ``fit_on_batch``; one segment of
40 000 edges among short ones at F 32; ``[32768, 512]`` over 8192 random
segments.  Per run and case it prints the profiler's device µs a launch
(``chip_smoke.device_us``) and the host µs a call (200 back-to-back calls,
no synchronise), after checking each version against the plain version.
The card's name and power limit come first, a JSON line of means last.
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
OUT = REPO / 'build' / 'bench_csr_sum'
HOST_CALLS = 200


def cases(dev):
    """{name: (msgs, row_ptr)} on the card."""
    import numpy as np
    import torch
    from chip_smoke import SMILES, recorded
    from deepchem_tpu_torch import PagtnModel, PagtnMolGraphFeaturizer
    from deepchem_tpu_torch.models import graph_models
    from deepchem_tpu_torch.ops import csr_segment
    X = PagtnMolGraphFeaturizer().featurize(SMILES[1:17])
    y = np.random.RandomState(0).randint(0, 2, (16, 12)).astype(np.float32)
    model = PagtnModel(n_tasks=12, mode='classification', device=dev, seed=0)
    agg = recorded(graph_models, 'csr_segment_sum',
                   lambda: model.predict_on_batch(X))[0]
    bwd = recorded(csr_segment, 'csr_segment_sum',
                   lambda: model.fit_on_batch(X, y, np.ones_like(y)))[0]
    rng = np.random.RandomState(0)
    lengths = list(rng.randint(0, 8, 511)) + [40000]
    ghost_rp = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    N, E = 8192, 32768
    wide_rp = np.searchsorted(np.sort(rng.randint(0, N, E)),
                              np.arange(N + 1)).astype(np.int32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return {
        'pagtn_aggregation_6144x32': agg,
        'pagtn_softmax_backward_6144x1': bwd,
        'segment_40000_F32': (t(rng.randn(int(ghost_rp[-1]), 32).astype(
            np.float32)), t(ghost_rp)),
        'wide_32768x512': (t(rng.randn(E, 512).astype(np.float32)),
                           t(wide_rp))}


def time_version(name: str, inputs: dict, calls: int) -> dict:
    import torch
    from bench_flash import host_us
    from chip_smoke import device_us, sum_tol
    from deepchem_tpu_torch.ops.csr_segment import csr_segment_sum_reference
    fn = ctypes.CDLL(str(OUT / f'{name}.so')).csr_segment_sum_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for case, (msgs, row_ptr) in inputs.items():
        N, (E, F) = row_ptr.shape[0] - 1, msgs.shape
        res = msgs.new_empty((N, F))

        def run():
            return fn(msgs.data_ptr(), row_ptr.data_ptr(), res.data_ptr(),
                      N, E, F, stream)
        if run():
            raise RuntimeError(f'{name}: launch failed at {case}')
        torch.cuda.synchronize()
        ref = csr_segment_sum_reference(msgs, row_ptr)
        err = (res - ref).abs().max().item()
        if err > sum_tol(ref):
            raise RuntimeError(f'{name} {case}: error {err}')
        out[case] = {'device_us': device_us(run, 'csr_segment_sum_kernel',
                                            calls=calls),
                     'host_us': host_us(run, HOST_CALLS)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--parent', type=Path)
    ap.add_argument('--calls', type=int, default=20)
    args = ap.parse_args()
    import torch
    from bench_flash import nvcc
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {'base': CSRC / 'csr_segment_sum.cu'}
    if args.parent:
        sources['parent'] = OUT / 'parent.cu'
        sources['parent'].write_text(args.parent.read_text())
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    nvcc(sources, OUT)
    inputs = cases(torch.device('cuda', 0))
    print(json.dumps({'cases': {k: [list(m.shape), r.shape[0] - 1]
                                for k, (m, r) in inputs.items()}}))
    order = ['parent', 'base', 'base', 'parent'] if args.parent else ['base']
    runs = {n: [] for n in sources}
    for n in order:
        runs[n].append(time_version(n, inputs, args.calls))
        print(json.dumps({'version': n, 'run': len(runs[n]),
                          'us': runs[n][-1]}), flush=True)
    print(json.dumps({'mean_us': {
        n: {case: {x: sum(r[case][x] for r in rs) / len(rs)
                   for x in ('device_us', 'host_us')} for case in rs[0]}
        for n, rs in runs.items()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
