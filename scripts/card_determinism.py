#!/usr/bin/env python3
"""Are the port's training steps bit-reproducible on the card?

    python3 scripts/card_determinism.py [--models pna,megnet,...]
        [--modes default,deterministic] [--swap NAME ...] [--steps 2]
        [--device cpu]

For each model, two fresh models from seed 0 ``fit`` the same first
``--steps`` batches on the card (``deterministic=True``: the same batch
order), and every parameter's gradient after each step is compared bit for
bit between the two runs, as are the weights after the last step.  A
kernel of the port's adds in a fixed order; an op whose CUDA backward is
``index_add_`` (the backward of ``index_select`` on a tensor that needs a
gradient) adds with float atomics, in an order that changes run to run.

Modes: ``default``, and ``deterministic`` (under
``torch.use_deterministic_algorithms(True, warn_only=True)``, where torch
routes ``index_add_`` to a sorted, fixed-order sum).  ``--swap NAME`` puts
one of the repaired gathers back to ``index_select`` for a run of its
own over the models it reaches (:func:`_swaps`), so a model that is the same bit for bit with the
repair and differs with that one gather swapped back shows where its
difference came from (``grover_gathers`` puts GROVER's flat gathers on
``index_select``, as the JAX package's ``jnp.take`` would run).  The
models' data and sizes are ``chip_smoke.py``'s; GROVER (pretraining, at
its phase 22 width) in both layouts, ``grover_flat`` and
``grover_packed``.

Prints one JSON line a run and, last, a JSON summary:
``{"runs": [{"model", "mode", "swap", "same_bits", "differing", ...}]}``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _rows(x, idx, *_):
    """``x[idx]`` by ``index_select``: its CUDA backward is ``index_add_``."""
    return x.index_select(0, idx.long())


def _table_rows(table, ids):
    return table.index_select(0, ids.reshape(-1).long()).reshape(
        tuple(ids.shape) + (-1,))


def _rows_g(x, idx, *_):
    """``x[:, idx]`` by ``index_select``: ``index_add_`` backward."""
    return x.index_select(1, idx.long())


def _swaps():
    """NAME -> (the patches: module, attribute and the plain
    ``index_select`` route that stood there before the repair, or that
    the JAX package's gathers would take; the models it reaches)."""
    from deepchem_tpu_torch.models import (dmpnn, gnn_modular, graph_layers,
                                           grover, material_models, pna)
    return {
        'grover_gathers': ([(grover, 'gather_rows', _rows),
                            (grover, 'gather_rows_g', _rows_g)],
                           ['grover_flat']),
        'pna_src': ([(pna, 'gather_src', _rows)],
                    ['pna', 'infomax3d_pretrain']),
        'pna_dst': ([(pna, 'gather_dst', _rows)],
                    ['pna', 'infomax3d_pretrain']),
        'megnet_state': ([(material_models, 'gather_graph_rows', _rows)],
                         ['megnet']),
        'gnn_modular_edges': ([(gnn_modular, 'gather_src', _rows),
                               (gnn_modular, 'gather_dst', _rows)],
                              ['gnn_edge_pred']),
        'gnn_modular_graphs': ([(gnn_modular, 'gather_graph_rows', _rows)],
                               ['gnn_infomax']),
        'dmpnn_take_src': ([(dmpnn, 'take_src', _rows)], ['dmpnn']),
        'dmpnn_rev': ([(dmpnn, 'permute_rows', _rows)], ['dmpnn']),
        'set_gather': ([(graph_layers, 'gather_graph_rows', _rows)],
                       ['mpnn']),
        'dtnn_embedding': ([(graph_layers, 'gather_table_rows', _table_rows)],
                           ['dtnn'])}


def _data():
    """name -> (make(device, seed), X, y) for every model checked."""
    import chip_smoke as cs
    from deepchem_tpu_torch import (AtomicConvModel, DMPNNFeaturizer,
                                    DMPNNModel, DTNNModel, GNNModular,
                                    GroverModel, InfoMax3DModular,
                                    MEGNetModel, MPNNModel,
                                    MolGraphConvFeaturizer, MXMNetModel,
                                    PNAModel)
    gnn_X, gnn_y = cs.table_data(MolGraphConvFeaturizer(), cs.SMILES)
    dm_X, dm_y = cs.table_data(DMPNNFeaturizer(),
                               cs.SMILES + cs.STEREO_SMILES)
    mp_X, mp_y = cs.mpnn_data()
    mat = cs.materials_data()
    cm_X, cm_y = cs.coulomb_data()[:2]
    s21 = cs.slice21_data()
    gd = cs.grover_data()

    def grover(packed):
        return (lambda d, s: GroverModel(
            **cs.GROVER, task='pretraining', atom_vocab=gd['av'],
            bond_vocab=gd['bv'], packed=packed, device=d, seed=s),
            gd['grover'], gd['grover_y'])
    out = {
        'grover_flat': grover(False), 'grover_packed': grover(True),
        'pna': (lambda d, s: PNAModel(**cs.PNA, device=d, seed=s),
                gnn_X, gnn_y),
        'infomax3d_pretrain': (lambda d, s: InfoMax3DModular(
            task='pretrain', **cs.INFOMAX3D, device=d, seed=s),
            mat['conformer'], mat['conformer_y']),
        'megnet': (lambda d, s: MEGNetModel(**cs.MEGNET, device=d, seed=s),
                   mat['cgcnn'], mat['y']),
        'gnn_edge_pred': (lambda d, s: GNNModular(
            **cs.GNN_EDGE_PRED, device=d, seed=s), gnn_X, gnn_y),
        'gnn_infomax': (lambda d, s: GNNModular(
            task='infomax', device=d, seed=s), gnn_X, gnn_y),
        'dmpnn': (lambda d, s: DMPNNModel(**cs.DMPNN, device=d, seed=s),
                  dm_X, dm_y),
        'dmpnn_coo': (lambda d, s: DMPNNModel(**cs.DMPNN, device=d, seed=s),
                      dm_X, dm_y),
        'dtnn': (lambda d, s: DTNNModel(**cs.DTNN, device=d, seed=s),
                 cm_X, cm_y),
        'mpnn': (lambda d, s: MPNNModel(**cs.MPNN, device=d, seed=s),
                 mp_X, mp_y),
        'mxmnet': (lambda d, s: MXMNetModel(**cs.MXMNET, device=d, seed=s),
                   s21['mxmnet'], s21['mxmnet_y']),
        'atomic_conv': (lambda d, s: AtomicConvModel(
            **cs.ATOMIC_CONV, device=d, seed=s), s21['complexes'],
            s21['complexes_y'])}
    return out


def _fit_grads(make, X, y, steps, dev, coo=False):
    """Every gradient after each of ``steps`` steps, and the weights
    after, of a fresh model from seed 0."""
    import chip_smoke as cs
    from deepchem_tpu_torch import DMPNNModel, NumpyDataset
    grads = []

    def grab(model, step):
        grads.append({n: p.grad.detach().clone()
                      for n, p in model.module.named_parameters()
                      if p.grad is not None})
    if coo:
        with cs.coo_branch(DMPNNModel):
            model = make(dev, 0)
            B = model.batch_size
            model.fit(NumpyDataset(X[:steps * B], y[:steps * B]),
                      nb_epoch=1, checkpoint_interval=0, deterministic=True,
                      callbacks=grab)
    else:
        model = make(dev, 0)
        B = model.batch_size
        model.fit(NumpyDataset(X[:steps * B], y[:steps * B]), nb_epoch=1,
                  checkpoint_interval=0, deterministic=True, callbacks=grab)
    weights = {n: p.detach().clone()
               for n, p in model.module.named_parameters()}
    return grads, weights


def _same(a, b):
    import torch
    return a.shape == b.shape and torch.equal(
        a.view(torch.int32), b.view(torch.int32))


def compare(make, X, y, steps, dev, coo=False):
    """Two runs from one seed: the parameters whose gradient (at any step)
    or final weight differs in any bit, and the largest difference."""
    first = _fit_grads(make, X, y, steps, dev, coo)
    second = _fit_grads(make, X, y, steps, dev, coo)
    differing, worst = {}, 0.0
    for step, (ga, gb) in enumerate(zip(first[0], second[0]), 1):
        for n, g in ga.items():
            if not _same(g, gb[n]):
                differing.setdefault(n, []).append(f'grad step {step}')
                worst = max(worst, float((g - gb[n]).abs().max()))
    for n, w in first[1].items():
        if not _same(w, second[1][n]):
            differing.setdefault(n, []).append('weight')
    return {'steps': len(first[0]), 'params': len(first[1]),
            'same_bits': not differing, 'differing': differing,
            'max_abs_grad_diff': worst}


def main() -> int:
    import torch
    p = argparse.ArgumentParser()
    p.add_argument('--models', default='')
    p.add_argument('--modes', default='default,deterministic')
    p.add_argument('--swap', action='append', default=[])
    p.add_argument('--steps', type=int, default=2)
    p.add_argument('--device', default='cuda',
                   help='cpu: a dry run of the script itself')
    args = p.parse_args()
    if args.device == 'cuda' and not torch.cuda.is_available():
        print('card_determinism: no CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    if dev.type == 'cuda':
        from deepchem_tpu_torch.kernels import build
        build.build_all()
    data = _data()
    names = [m for m in args.models.split(',') if m] or list(data)
    swaps = _swaps()
    unknown = [w for w in args.swap if w not in swaps]
    if unknown:
        print(f'card_determinism: no swap {unknown}; known: {sorted(swaps)}',
              file=sys.stderr)
        return 2
    runs = []
    plan = [(mode, None, names) for mode in args.modes.split(',') if mode]
    plan += [('default', w, [m for m in swaps[w][1] if m in names])
             for w in args.swap]
    for mode, swap, models in plan:
        torch.use_deterministic_algorithms(mode == 'deterministic',
                                           warn_only=True)
        patches = swaps[swap][0] if swap else []
        saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
        for mod, attr, plain in patches:
            setattr(mod, attr, plain)
        try:
            for name in models:
                make, X, y = data[name]
                t0 = time.perf_counter()
                res = compare(make, X, y, args.steps, dev,
                              coo=name == 'dmpnn_coo')
                res.update(model=name, mode=mode, swap=swap,
                           seconds=round(time.perf_counter() - t0, 2))
                print(json.dumps(res), flush=True)
                runs.append(res)
        finally:
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)
    torch.use_deterministic_algorithms(False)
    print(json.dumps({'runs': [{k: r[k] for k in (
        'model', 'mode', 'swap', 'same_bits', 'max_abs_grad_diff')}
        for r in runs], 'device': torch.cuda.get_device_name(0)
        if dev.type == 'cuda' else 'cpu'}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
