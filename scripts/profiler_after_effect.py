#!/usr/bin/env python3
"""Does a process that has run ``torch.profiler`` launch slower afterwards?

    python3 scripts/profiler_after_effect.py [--profiles 0,50,150,300]

Times GraphConvModel at ``bench.py``'s width as ``chip_smoke.py`` phase 11
does (``chip_smoke.GRAPHCONV``, its 768 molecules, a warm-up epoch of
``fit_on_device`` and then 2 timed epochs: host ms a step; and the median
of 30 requests of 16 molecules), first in a fresh process and then after
more and more profiler runs, each one ``torch.profiler.profile`` with
CPU and CUDA activities around 20 calls of K1 (``nei_sum``) at layer 1's
shape, as ``chip_smoke.device_us`` runs it.  ``--profiles`` lists the
total profiler runs before each timing point.  Prints one JSON line with
the card's name and power limit and, per point, the profiler runs so far,
three step times and the request median.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def card() -> str:
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--profiles', default='0,50,150,300')
    args = ap.parse_args()
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import GRAPHCONV, GRAPHCONV_MOLECULES, graphconv_data
    from deepchem_tpu_torch import GraphConvModel, NumpyDataset
    from deepchem_tpu_torch.ops import nei_sum
    dev = torch.device('cuda', 0)
    X, labels = graphconv_data()
    ds = NumpyDataset(X, labels, np.ones_like(labels))
    steps = 2 * -(-GRAPHCONV_MOLECULES // GRAPHCONV['batch_size'])
    server = GraphConvModel(**GRAPHCONV, device=dev, seed=0)
    h = torch.randn(5120, 64, device=dev)
    table = torch.randint(0, 5120, (5120, 10), dtype=torch.int32,
                          device=dev)
    deg = torch.randint(0, 5, (5120,), dtype=torch.int8, device=dev)

    def step_ms() -> float:
        trainer = GraphConvModel(**GRAPHCONV, device=dev, seed=1)
        trainer.fit_on_device(ds, nb_epoch=1, seed=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.fit_on_device(ds, nb_epoch=2, seed=1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    def request_ms() -> float:
        server.predict_on_batch(X[:16])
        times = []
        for i in range(30):
            t0 = time.perf_counter()
            server.predict_on_batch(X[16 * i:16 * i + 16])
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    name = card()
    points, done = [], 0
    for total in (int(n) for n in args.profiles.split(',')):
        for _ in range(total - done):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                for _ in range(20):
                    nei_sum(h, table, deg)
                torch.cuda.synchronize()
        done = max(done, total)
        points.append({'profiles': done,
                       'step_ms': [step_ms() for _ in range(3)],
                       'request_of_16_median_ms': request_ms()})
        print(json.dumps(points[-1]), file=sys.stderr, flush=True)
    print(json.dumps({'card': name, 'points': points}), flush=True)
    print(name, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
