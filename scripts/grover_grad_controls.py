#!/usr/bin/env python3
"""Would ``chip_smoke.py`` phase 22's GROVER gradient limit catch a wrong
backward?  Planted faults, and how far each moves the step-1 gradients.

    python3 scripts/grover_grad_controls.py [--seeds 1,2] [--batch 8]
        [--threads 4]

Phase 22 holds the card's step-1 gradients of GROVER-large (hidden 1024,
8 heads, 2 MT blocks, depth 3) against the CPU's within
``GROVER_GRAD_ATOL`` of max(1, max |g|) over each parameter, at batch 8
of its molecules (seed 1, quanta of 64).  Here, on the CPU and in the
flat layout, each task's correct step-1 gradients are set beside those
of the same model with one fault planted in its backward (the forward
unchanged), each planted at run time by swapping a function or class of
``deepchem_tpu_torch.models.grover``:

* ``ghost_cotangent_zeroed``: the custom-VJP symmetric sums
  (``_nei_sum_sym`` and its grouped twin) give the ghost row of each
  group no cotangent, where the JAX package's custom VJP gives it the
  slot sum of its own table (every slot a pad at row 0);
* ``true_transpose``: those sums take the true transpose in place of
  the JAX package's custom VJP (row 0 then collects every pad slot's
  cotangent);
* ``sym_first_slot_dropped``: those sums' backward (K1) leaves out
  each row's first slot, a real neighbour of every atom with one;
* ``b2revb_pads_dropped``: the ``b2revb`` gathers' backward leaves out
  row 0's segment, the ghost's and every pad slot's cotangent, which the
  JAX package's scatter collects there;
* ``b2a_last_dropped``: the ``b2a`` gathers' backward (P2 over the
  CSR) drops the last entry of each atom's segment, a fault on real
  rows.

Prints a line a run: the largest ``|g_fault - g| / max(1, max |g|)``
over the parameters and where, and the parameters whose difference
passes the limit; a line a run with the parameters whose every
gradient lies below the limit, where a fault confined to them would
pass; last a JSON summary.  A fault moves the gradients on
the card as on the CPU, while float32 order alone puts the card's and the
CPU's up to 3.6e-3 apart (scripts/grover_float32_drift.py), so a fault
that moves them by more than the limit plus that is caught there.
"""

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / 'scripts'))


def faults():
    """name: a function that plants the fault and returns its undo."""
    import torch
    from deepchem_tpu_torch.models import grover as gr

    def ghost_rows(table):
        """The rows whose every slot points at the row itself: the ghost
        row of each group (its slots are pads at the group's row 0)."""
        own = torch.arange(table.shape[0], device=table.device)
        return (table.long() == own[:, None]).all(1)

    def swap_sym(backward):
        base = gr._NeiSumSym

        class Faulty(torch.autograd.Function):
            forward = staticmethod(base.forward)

            @staticmethod
            def backward(ctx, g):
                table, = ctx.saved_tensors
                return backward(table, g), None, None
        gr._NeiSumSym = Faulty

        def undo():
            gr._NeiSumSym = base
        return undo

    def zero_ghost(table, g):
        dx = gr._k1(g.reshape(table.shape[0], -1), table, gr.nei_sum_sym,
                    'backward_launches')
        dx[ghost_rows(table)] = 0
        return dx.reshape(g.shape)

    def first_dropped(table, g):
        t = table[:, 1:].contiguous()
        return gr._k1(g.reshape(table.shape[0], -1), t, gr.nei_sum_sym,
                      'backward_launches').reshape(g.shape)

    def transpose(table, g):
        g2 = g.reshape(table.shape[0], -1)
        K = table.shape[1]
        dx = torch.zeros_like(g2).index_add_(
            0, table.reshape(-1).long(), g2.repeat_interleave(K, dim=0))
        return dx.reshape(g.shape)

    def swap_graph(edit):
        base = gr.FlatGraph

        class Faulty(base):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                edit(self, args[-1])
        gr.FlatGraph = Faulty

        def undo():
            gr.FlatGraph = base
        return undo

    def drop_row0(graph, groups):
        order, ptr = graph.revb_csr
        graph.revb_csr = (order[int(ptr[1]):].contiguous(),
                          torch.cat([ptr[:1] * 0, ptr[1:] - ptr[1]]))
        graph.revb_csr_g = gr.grouped_csr(*graph.revb_csr, groups)

    def drop_last(graph, groups):
        order, ptr = graph.b2a_csr
        ends = ptr[1:][ptr[1:] > ptr[:-1]] - 1      # each segment's last
        keep = torch.ones(order.shape[0], dtype=torch.bool)
        keep[ends.long()] = False
        lost = torch.cat([ptr[:1] * 0, torch.cumsum(
            (ptr[1:] > ptr[:-1]).to(ptr.dtype), 0)])
        graph.b2a_csr = (order[keep].contiguous(),
                         (ptr - lost).to(ptr.dtype))
        graph.b2a_csr_g = gr.grouped_csr(*graph.b2a_csr, groups)

    return {'ghost_cotangent_zeroed': lambda: swap_sym(zero_ghost),
            'true_transpose': lambda: swap_sym(transpose),
            'sym_first_slot_dropped': lambda: swap_sym(first_dropped),
            'b2revb_pads_dropped': lambda: swap_graph(drop_row0),
            'b2a_last_dropped': lambda: swap_graph(drop_last)}


def main() -> int:
    import torch
    import chip_smoke as cs
    from deepchem_tpu_torch import GroverModel
    from grover_float32_drift import step1_grads
    p = argparse.ArgumentParser()
    p.add_argument('--seeds', default='1,2')
    p.add_argument('--batch', type=int, default=8)
    p.add_argument('--threads', type=int, default=4)
    args = p.parse_args()
    torch.set_num_threads(args.threads)
    gd = cs.grover_data()
    B = args.batch
    X, y = gd['grover'][:B], gd['grover_y'][:B]
    limit = cs.GROVER_GRAD_ATOL
    runs = []
    for pretrain in (True, False):
        task = dict(task='pretraining', atom_vocab=gd['av'],
                    bond_vocab=gd['bv']) if pretrain else dict(
            task='finetuning', mode='classification',
            n_tasks=cs.GROVER_TASKS)
        for seed in [int(s) for s in args.seeds.split(',')]:
            model = GroverModel(**{**cs.GROVER, **task, 'batch_size': B},
                                packed=False, device='cpu', seed=seed)
            model.node_quantum = model.edge_quantum = cs.GROVER_CUT_QUANTUM
            weights = {k: v.clone()
                       for k, v in model.module.state_dict().items()}
            ref = step1_grads(model, X, y)
            print(json.dumps({'task': task['task'], 'seed': seed,
                              'below_limit': sorted(
                                  n for n, g in ref.items()
                                  if float(g.abs().max()) < limit)}),
                  flush=True)
            for name, plant in faults().items():
                model.module.load_state_dict(weights)
                model.module.zero_grad(set_to_none=True)
                undo = plant()
                try:
                    got = step1_grads(model, X, y)
                finally:
                    undo()
                errs = {n: float((g - ref[n]).abs().max())
                        / max(1.0, float(ref[n].abs().max()))
                        for n, g in got.items()}
                worst = max(errs, key=errs.get)
                res = {'task': task['task'], 'seed': seed, 'fault': name,
                       'max_err': errs[worst], 'where': worst,
                       'over_limit': sorted(n for n, e in errs.items()
                                            if e > limit)}
                print(json.dumps(res), flush=True)
                runs.append(res)
    print(json.dumps({'limit': limit, 'least_max_err_by_fault': {
        f: min(r['max_err'] for r in runs if r['fault'] == f)
        for f in faults()}, 'torch': torch.__version__}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
