#!/usr/bin/env python3
"""How far GraphConv's training trajectory at bench.py's width carries a
float32 rounding difference.

    python3 scripts/graphconv_trajectory_drift.py [--device cpu] [--steps 26]

Loads chip_smoke.py's Tox21-shaped file of 8014 molecules through
``load_tox21`` (random split, seed 123), then trains GraphConvModel
(layers 64, 64, dense 128, batch 256, lr 0.002) with ``fit`` in dataset
order from seed 1 for ``--steps`` steps: once as drawn and twice with
every weight moved by one float32 ulp (times 1 +- 1.2e-7, signs from a
seed), on ``--device`` (default the card); on the card also on the CPU
from the same weights.  Prints each run's loss difference a step from the
unperturbed run, of max(1, |loss|).  Each run is one process's
arithmetic: the differences are rounding carried through Adam and the
batch norm.  About a minute on the card's machine, three on a CPU.
"""

import argparse
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def trajectory(train, device, steps, perturb=0):
    """The first ``steps`` losses of a fit from seed 1's weights (drawn
    on the host, so alike on every device), each moved by one ulp with
    ``perturb``."""
    import chip_smoke as cs
    from deepchem_tpu_torch import GraphConvModel
    model = GraphConvModel(**cs.GRAPHCONV, device=device, seed=1,
                           log_frequency=1)
    if perturb:
        g = torch.Generator().manual_seed(perturb)
        with torch.no_grad():
            for p in model.module.parameters():
                sign = torch.randint(0, 2, p.shape, generator=g) * 2 - 1
                p.mul_(1 + 1.2e-7 * sign.to(device))
    losses = []
    model.fit(train, nb_epoch=1, deterministic=True, checkpoint_interval=0,
              callbacks=cs.stop_after(steps), all_losses=losses)
    return np.array(losses)


def main() -> int:
    import chip_smoke as cs
    from deepchem_tpu_torch.molnet import load_tox21
    ap = argparse.ArgumentParser()
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--steps', type=int, default=26)
    args = ap.parse_args()
    if args.device == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(torch.cuda.get_device_name(0), flush=True)
    with tempfile.TemporaryDirectory() as d:
        cs.write_tox21(os.path.join(d, 'tox21.csv.gz'), cs.TOX21_ROWS)
        _, (train, _, _), _ = load_tox21(
            featurizer='graphconv', splitter='random', splitter_seed=123,
            data_dir=d, save_dir=d)
        base = trajectory(train, args.device, args.steps)
        runs = {f'weights 1 ulp apart ({seed})': trajectory(
            train, args.device, args.steps, perturb=seed)
            for seed in (1, 2)}
        if args.device != 'cpu':
            runs['the CPU, same weights'] = trajectory(train, 'cpu',
                                                       args.steps)
    for name, losses in runs.items():
        err = np.abs(losses - base) / np.maximum(1.0, np.abs(base))
        print(f'{args.device} {name}: {[float(f"{e:.3g}") for e in err]}',
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
