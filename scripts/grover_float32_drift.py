#!/usr/bin/env python3
"""How far do GROVER-large's float32 step-1 gradients lie from float64?

    python3 scripts/grover_float32_drift.py [--seeds 1,2,3] [--batch 8]
        [--device cuda|cpu]

At ``chip_smoke.py``'s GROVER width (hidden 1024, 8 heads, 2 MT blocks,
depth 3) and its molecules, for each layout (flat, packed) and task
(pretraining, finetuning on 12 classification tasks) and each seed: the
step-1 gradients of one batch of ``--batch`` molecules in float64 on the
CPU, and in float32 on the CPU twice (the flat layout padded to quanta of
64 and of 128, so the same sums run in other shapes and orders) and on
``--device``.  Prints, a line a run, each float32 run's largest
``|g32 - g64| / max(1, max |g64|)`` over the parameters, and the
parameter where it lies; last a JSON summary.  ``chip_smoke.py`` phase
22 holds the card's float32 step-1 gradients against the CPU's float32
ones within a limit set from these runs (``GROVER_GRAD_ATOL``): each
lies up to the largest reading from float64, so the two up to twice
that from each other.
"""

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def step1_grads(model, X, y, double=False):
    """Every parameter's gradient of the loss of ``model`` on the first
    batch of ``X``, ``y`` (in float64 with ``double``)."""
    from deepchem_tpu_torch import NumpyDataset
    module = model.module.double() if double else model.module
    module.train()
    batch = model._prepare_batch(next(model.default_generator(
        NumpyDataset(X, y))))
    inputs, labels, weights = ([t.double() if double and t.is_floating_point()
                                else t for t in part] for part in batch)
    out = module(*inputs)
    model._compute_loss(list(out), labels, weights).backward()
    return {n: p.grad.detach().cpu().double()
            for n, p in module.named_parameters() if p.grad is not None}


def worst(grads, ref):
    """The largest scaled difference and its parameter."""
    errs = {n: float((g - ref[n]).abs().max())
            / max(1.0, float(ref[n].abs().max())) for n, g in grads.items()}
    name = max(errs, key=errs.get)
    return errs[name], name


def main() -> int:
    import torch
    import chip_smoke as cs
    from deepchem_tpu_torch import GroverModel
    p = argparse.ArgumentParser()
    p.add_argument('--seeds', default='1,2,3')
    p.add_argument('--batch', type=int, default=8)
    p.add_argument('--device', default='cuda')
    args = p.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.device == 'cuda':
        if not torch.cuda.is_available():
            print('grover_float32_drift: no CUDA device', file=sys.stderr)
            return 1
        from deepchem_tpu_torch.kernels import build
        build.build_all()
    gd = cs.grover_data()
    B = args.batch
    X, y = gd['grover'][:B], gd['grover_y'][:B]
    runs = []
    for packed in (False, True):
        for pretrain in (True, False):
            task = dict(task='pretraining', atom_vocab=gd['av'],
                        bond_vocab=gd['bv']) if pretrain else dict(
                task='finetuning', mode='classification',
                n_tasks=cs.GROVER_TASKS)
            for seed in [int(s) for s in args.seeds.split(',')]:
                def make(device, quantum=64):
                    m = GroverModel(**{**cs.GROVER, **task, 'batch_size': B},
                                    packed=packed, device=device, seed=seed)
                    m.node_quantum = m.edge_quantum = quantum
                    return m
                ref = step1_grads(make('cpu'), X, y, double=True)
                res = {'layout': 'packed' if packed else 'flat',
                       'task': task['task'], 'seed': seed}
                for key, device, quantum in (
                        ('cpu_q64', 'cpu', 64), ('cpu_q128', 'cpu', 128),
                        (args.device, args.device, 64)):
                    if packed and key == 'cpu_q128':
                        continue                 # the packed quanta differ
                    res[key] = worst(step1_grads(make(device, quantum), X, y),
                                     ref)
                print(json.dumps(res), flush=True)
                runs.append(res)
    keys = [k for k in ('cpu_q64', 'cpu_q128', args.device)]
    print(json.dumps({'max': {k: max(r[k][0] for r in runs if k in r)
                              for k in keys},
                      'device': torch.cuda.get_device_name(0)
                      if args.device == 'cuda' else 'cpu'}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
