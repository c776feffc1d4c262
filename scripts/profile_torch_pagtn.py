#!/usr/bin/env python3
"""Where a graph model's request, or training step, spends its time on
one CUDA card.

    python3 scripts/profile_torch_pagtn.py
        [--model pagtn|graphconv|mpnn|gcn|gat|attentivefp|dmpnn|pna|
                 gnn_regression|gnn_edge_pred|infograph_star]
        [--mode serve|train|fit_on_device] [--batch N] [--requests 20]

Builds a model of ``chip_smoke.py`` with seeded weights and ``batch_size``
set to ``--batch``: PagtnModel(n_tasks=12, mode='classification') at its
default widths (batch 16 by default), GraphConvModel at ``bench.py``'s
width (``chip_smoke.GRAPHCONV``; batch 16 to serve, 256 to train by
default), or MPNNModel, GCNModel, GATModel, AttentiveFPModel or
DMPNNModel at the JAX package's defaults (``chip_smoke.MPNN``, ``GCN``,
``GAT``, ``ATTENTIVEFP``, ``DMPNN``, one regression task; batch 16 to
serve, 100 to train by default), or the COO models of phase 16 (PNAModel,
GNNModular as a regressor and on edge prediction, InfoGraphStarModel;
``chip_smoke.PNA``, ``GNN_REGRESSION``, ``GNN_EDGE_PRED``,
``INFOGRAPH_STAR``), alike.  It runs ``--requests`` batches of
``--batch`` molecules drawn with replacement from the script's 48 (MPNN
and DMPNN: and ``chip_smoke.STEREO_SMILES``), already featurized, with
seeded 0/1 labels (the regression models: normal):

- ``serve``: answers each batch as a request.  Host clock, per request
  (means, and the median and p90 of the totals):
  packing the padded batch (numpy), copying it to the card, the forward
  pass (ended by a synchronise) and copying the outputs back.
- ``train``: one training step per batch, with seeded 0/1 labels, as
  ``TorchModel._train_step`` runs it.  Host clock, per step: packing (with
  the one-hot labels), copying to the card, forward and loss, backward,
  and the Adam update, each ended by a synchronise.
- ``fit_on_device``: the epoch's ``--requests`` batches uploaded once
  (``TorchModel.fit_on_device``), one warm-up epoch, then host ms a step
  over 2 timed epochs with no synchronise between steps.
- all: ``torch.profiler`` over the same batches without the extra
  synchronises: device time by kernel, and the device's busy share of the
  window (sum of kernel self times over the window's wall time;
  overlapping kernels would count twice, and on one stream there are
  none).

Prints one JSON line and writes it to
``chiprun_out/profile_<model>_<mode>.json``.  Needs a CUDA device; there
is no CPU fallback.
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def device_breakdown(run, n: int):
    """``torch.profiler`` over ``run()``, which runs ``n`` requests or steps
    and does not synchronise: the window's wall ms, and the device time of
    each kernel by name (``device_us_per_request`` is over ``n``), largest
    first."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, 'self_device_time_total', 0.0)
        # a user annotation (Adam's ``Optimizer.step``) spans kernels that
        # are counted on their own
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(evt, 'is_user_annotation', False):
            kernels.append({'name': evt.key[:80], 'calls': evt.count,
                            'device_us_per_request': dev_us / n})
    kernels.sort(key=lambda k: -k['device_us_per_request'])
    return wall_ms, kernels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--model', choices=('pagtn', 'graphconv', 'mpnn', 'gcn',
                                        'gat', 'attentivefp', 'dmpnn',
                                        'pna', 'gnn_regression',
                                        'gnn_edge_pred', 'infograph_star'),
                    default='pagtn')
    ap.add_argument('--mode', choices=('serve', 'train', 'fit_on_device'),
                    default='serve')
    ap.add_argument('--batch', type=int, default=None)
    ap.add_argument('--requests', type=int, default=20)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('profile_torch_pagtn: no CUDA device', file=sys.stderr)
        return 1
    from chip_smoke import (ATTENTIVEFP, DMPNN, GAT, GCN, GNN_EDGE_PRED,
                            GNN_REGRESSION, GRAPHCONV, INFOGRAPH_STAR, MPNN,
                            PNA, SMILES, STEREO_SMILES, _counted,
                            launch_counts)
    from deepchem_tpu_torch import (AttentiveFPModel, ConvMolFeaturizer,
                                    DMPNNFeaturizer, DMPNNModel, GATModel,
                                    GCNModel, GNNModular, GraphConvModel,
                                    InfoGraphStarModel,
                                    MolGraphConvFeaturizer, MPNNModel,
                                    NumpyDataset, PagtnModel,
                                    PagtnMolGraphFeaturizer, PNAModel)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.batch is None:
        args.batch = {'pagtn': 16, 'graphconv': 256}.get(args.model, 100) \
            if args.mode != 'serve' else 16
    labels = np.random.RandomState(0).randint(0, 2, (len(SMILES), 12))
    if args.model == 'pagtn':
        X = PagtnMolGraphFeaturizer().featurize(SMILES)
        model = PagtnModel(n_tasks=12, mode='classification',
                           batch_size=args.batch, seed=0)
    elif args.model == 'graphconv':
        X = ConvMolFeaturizer().featurize(SMILES)
        model = GraphConvModel(**dict(GRAPHCONV, batch_size=args.batch),
                               seed=0)
    elif args.model in ('mpnn', 'dmpnn'):
        feat = DMPNNFeaturizer() if args.model == 'dmpnn' \
            else MolGraphConvFeaturizer(use_edges=True)
        X = feat.featurize(SMILES + STEREO_SMILES)
        cls, config = ((DMPNNModel, DMPNN) if args.model == 'dmpnn'
                       else (MPNNModel, MPNN))
        model = cls(**dict(config, batch_size=args.batch), seed=0)
        labels = np.random.RandomState(0).randn(len(X), 1)
    else:
        X = MolGraphConvFeaturizer().featurize(SMILES)
        cls, config = {'gcn': (GCNModel, GCN), 'gat': (GATModel, GAT),
                       'attentivefp': (AttentiveFPModel, ATTENTIVEFP),
                       'pna': (PNAModel, PNA),
                       'gnn_regression': (GNNModular, GNN_REGRESSION),
                       'gnn_edge_pred': (GNNModular, GNN_EDGE_PRED),
                       'infograph_star': (InfoGraphStarModel,
                                          INFOGRAPH_STAR)}[args.model]
        model = cls(**dict(config, batch_size=args.batch), seed=0)
        labels = np.random.RandomState(0).randn(len(X), 1)
    labels = labels.astype(np.float32)
    rng = np.random.RandomState(0)
    picks = [rng.randint(0, len(X), args.batch)
             for _ in range(args.requests)]
    phases = (('pack', 'to_device', 'forward', 'to_host')
              if args.mode == 'serve' else
              ('pack', 'to_device', 'forward', 'backward', 'optimizer'))

    def request(idx, clock=None):
        t = [time.perf_counter()]
        arrays = model._graph_inputs(X[idx])
        t.append(time.perf_counter())
        inputs, _, _ = model._prepare_batch((arrays, [], []))
        t.append(time.perf_counter())
        outs = model._forward(inputs)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        outs[0].cpu().numpy()
        t.append(time.perf_counter())
        return t

    def train_step(idx, clock=None):
        """``TorchModel._train_step``, split at synchronises when timed."""
        sync = torch.cuda.synchronize if clock is not None else (
            lambda: None)
        t = [time.perf_counter()]
        batch = next(model.default_generator(
            NumpyDataset(X[idx], labels[idx], np.ones_like(labels[idx]))))
        t.append(time.perf_counter())
        inputs, y, w = model._prepare_batch(batch)
        sync()
        t.append(time.perf_counter())
        if clock is None:
            model._train_step(inputs, y, w)
            return t
        model.module.train()
        opt = model._torch_optimizer
        opt.zero_grad(set_to_none=True)
        out = model.module(*inputs)
        loss = model._compute_loss(
            list(out) if isinstance(out, tuple) else [out], y, w)
        sync()
        t.append(time.perf_counter())
        loss.backward()
        sync()
        t.append(time.perf_counter())
        opt.step()
        sync()
        t.append(time.perf_counter())
        return t

    if args.mode == 'fit_on_device':
        idx = np.concatenate(picks)
        epoch = NumpyDataset(X[idx], labels[idx], np.ones_like(labels[idx]))
        model.fit_on_device(epoch, nb_epoch=1)   # uploads, warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit_on_device(epoch, nb_epoch=2)
        torch.cuda.synchronize()
        clock = {'step': (time.perf_counter() - t0) * 1e3
                 / (2 * args.requests)}

        def run_epoch():
            model.fit_on_device(epoch, nb_epoch=1)
    else:
        run = request if args.mode == 'serve' else train_step
        for idx in picks[:3]:                        # warm-up
            run(idx, {})
        clock = dict.fromkeys(phases, 0.0)
        totals = []
        for idx in picks:
            t = run(idx, clock)
            for key, a, b in zip(phases, t, t[1:]):
                clock[key] += (b - a) * 1e3 / args.requests
            totals.append((t[-1] - t[0]) * 1e3)
        clock['total'] = sum(clock.values())
        clock['total_median'], clock['total_p90'] = (
            float(v) for v in np.percentile(totals, [50, 90]))

        def run_epoch():
            for i in picks:
                run(i)

    for fn, attr in _counted().values():
        setattr(fn, attr, 0)
    wall_ms, kernels = device_breakdown(run_epoch, args.requests)
    busy_ms = sum(k['device_us_per_request'] for k in kernels) \
        * args.requests / 1e3
    result = {
        'device': torch.cuda.get_device_name(0), 'model': args.model,
        'mode': args.mode,
        'batch': args.batch, 'requests': args.requests,
        'host_ms_per_request': clock,
        'profiled_wall_ms_per_request': wall_ms / args.requests,
        'device_busy_ms_per_request': busy_ms / args.requests,
        'device_busy_share': busy_ms / wall_ms if wall_ms else None,
        'kernel_launches_per_request': sum(k['calls'] for k in kernels)
        / args.requests,
        'port_kernel_launches': {k: v for k, v in launch_counts().items()
                                 if v},
        'top_kernels': kernels[:25],
    }
    line = json.dumps(result)
    out = REPO / 'chiprun_out'
    out.mkdir(exist_ok=True)
    (out / f'profile_{args.model}_{args.mode}.json').write_text(
        line + '\n')
    print(line)
    if not kernels:
        print('profile_torch_pagtn: the profiler recorded no device time',
              file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
