#!/usr/bin/env python3
"""Where a PagtnModel request's time goes on one CUDA card.

    python3 scripts/profile_torch_pagtn.py [--batch 16] [--requests 20]

Builds the model of ``chip_smoke.py`` (PagtnModel(n_tasks=12,
mode='classification'), default widths, seeded weights, ``batch_size``
set to ``--batch``) and answers
``--requests`` requests of ``--batch`` molecules drawn with replacement
from its 48, already featurized:

- host clock, per request: packing the padded batch (numpy), copying it
  to the card, the forward pass (ended by a synchronise) and copying the
  outputs back;
- ``torch.profiler`` over the same requests: device time by kernel, and
  the device's busy share of the window (sum of kernel self times over
  the window's wall time; overlapping kernels would count twice, and on
  one stream there are none).

Prints one JSON line and writes it to ``chiprun_out/profile_pagtn.json``.
Needs a CUDA device; there is no CPU fallback.
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--batch', type=int, default=16)
    ap.add_argument('--requests', type=int, default=20)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print('profile_torch_pagtn: no CUDA device', file=sys.stderr)
        return 1
    from chip_smoke import SMILES
    from deepchem_tpu_torch import PagtnModel, PagtnMolGraphFeaturizer
    from deepchem_tpu_torch.ops import csr_segment_softmax

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    X = PagtnMolGraphFeaturizer().featurize(SMILES)
    model = PagtnModel(n_tasks=12, mode='classification',
                       batch_size=args.batch, seed=0)
    rng = np.random.RandomState(0)
    batches = [X[rng.randint(0, len(X), args.batch)]
               for _ in range(args.requests)]

    def request(X_b, clock=None):
        t0 = time.perf_counter()
        arrays = model._graph_inputs(X_b)
        t1 = time.perf_counter()
        inputs, _, _ = model._prepare_batch((arrays, [], []))
        t2 = time.perf_counter()
        outs = model._forward(inputs)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        probs = outs[0].cpu().numpy()
        t4 = time.perf_counter()
        if clock is not None:
            for key, dt in zip(('pack', 'to_device', 'forward', 'to_host'),
                               (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                clock[key] += dt * 1e3 / args.requests
        return probs

    for X_b in batches[:3]:                      # warm-up
        request(X_b)
    clock = dict.fromkeys(('pack', 'to_device', 'forward', 'to_host'), 0.0)
    for X_b in batches:
        request(X_b, clock)
    clock['total'] = sum(clock.values())

    csr_segment_softmax.launches = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for X_b in batches:
            request(X_b)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, 'self_device_time_total', 0.0)
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append({'name': evt.key[:80], 'calls': evt.count,
                            'device_us_per_request':
                                dev_us / args.requests})
    kernels.sort(key=lambda k: -k['device_us_per_request'])
    busy_ms = sum(k['device_us_per_request'] for k in kernels) \
        * args.requests / 1e3
    result = {
        'device': torch.cuda.get_device_name(0),
        'batch': args.batch, 'requests': args.requests,
        'host_ms_per_request': clock,
        'profiled_wall_ms_per_request': wall_ms / args.requests,
        'device_busy_ms_per_request': busy_ms / args.requests,
        'device_busy_share': busy_ms / wall_ms if wall_ms else None,
        'kernel_launches_per_request': sum(k['calls'] for k in kernels)
        / args.requests,
        'csr_segment_softmax_launches': csr_segment_softmax.launches,
        'top_kernels': kernels[:15],
    }
    line = json.dumps(result)
    out = REPO / 'chiprun_out'
    out.mkdir(exist_ok=True)
    (out / 'profile_pagtn.json').write_text(line + '\n')
    print(line)
    if not kernels:
        print('profile_torch_pagtn: the profiler recorded no device time',
              file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
