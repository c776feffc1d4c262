#!/usr/bin/env python3
"""How far float32 alone moves the materials models' answers and scores.

    python3 scripts/materials_float32_drift.py

On the CPU, with ``chip_smoke.py`` phase 20's crystals and seeds: each of
CGCNN, LCNN and MEGNet is trained as ``model_phase`` trains its scored
model (``fit``, 3 epochs, seed 1), then answers every crystal in float32
and, from the same weights, in float64.  Prints one JSON line a model:
the largest answer, the answers' spread (standard deviation), the largest
float32-float64 difference of an answer, and of the RMS, MAE and pearson
r2 over the 320 crystals.  A card-CPU comparison of two float32 runs
cannot be held closer than these differences; ``chip_smoke.py`` sets
CGCNN's and LCNN's score tolerance (``EVAL_SCALED_RTOL``) and the metrics
of LCNN and MEGNet from them.  The same for CGCNN's answers at its
initial weights (seed 0), which phase 20's requests compare.

Then each of phase 20's models (at its configuration there, seeds 1 to
4: the trainer's seed is 1, and another torch build draws other initial
weights from it) trains 3 ``fit_on_device`` epochs as ``model_phase``
runs them (1 epoch, then 2), once from its initial weights and once from
them times ``1 + 1e-7 * noise``: one JSON line a model with the largest
relative difference of each epoch's loss.  A trajectory that moves by
more than 1e-4 (``CPU_ATOL``) under such a perturbation cannot be held
to the CPU's within it; ``chip_smoke.py`` compares only the epochs before
that (``loss_epochs``).
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def answers(model, X, dtype):
    """``model``'s answers to ``X`` with its module and float inputs in
    ``dtype``."""
    import deepchem_tpu_torch as dc
    model.module.to(dtype)
    tensor = model._tensor

    def cast(a):
        t = tensor(a)
        return t.to(dtype) if t.is_floating_point() else t
    model._tensor = cast
    try:
        return model.predict(dc.NumpyDataset(X)).astype(np.float64)
    finally:
        model._tensor = tensor
        model.module.float()


def scores(p, y):
    return {'rms': float(np.sqrt(np.mean((p - y) ** 2))),
            'mae': float(np.mean(np.abs(p - y))),
            'pearson_r2': float(np.corrcoef(p.ravel(), y.ravel())[0, 1]
                                ** 2)}


def main() -> int:
    import chip_smoke
    from deepchem_tpu_torch import (CGCNNModel, LCNNModel, MEGNetModel,
                                    NumpyDataset)
    torch.set_num_threads(4)
    data = chip_smoke.materials_data()
    y = data['y'].astype(np.float64)
    for name, cls, X in (('cgcnn', CGCNNModel, data['cgcnn']),
                         ('lcnn', LCNNModel, data['lcnn']),
                         ('megnet', MEGNetModel, data['cgcnn'])):
        for stage, seed in (('initial', 0), ('trained', 1)):
            model = cls(n_tasks=1, device='cpu', seed=seed,
                        log_frequency=10)
            if stage == 'trained':
                model.fit(NumpyDataset(X, data['y']), nb_epoch=3,
                          checkpoint_interval=0)
            p32, p64 = (answers(model, X, dt)
                        for dt in (torch.float32, torch.float64))
            s32, s64 = scores(p32, y), scores(p64, y)
            print(json.dumps({
                'model': name, 'weights': stage,
                'max_abs_answer': float(np.abs(p64).max()),
                'answer_std': float(p64.std()),
                'answer_f32_f64': float(np.abs(p32 - p64).max()),
                **{f'{k}_f32_f64': abs(s32[k] - s64[k]) for k in s64},
                **{k: s64[k] for k in s64}}), flush=True)
    trajectories(data)
    return 0


def trajectories(data):
    import chip_smoke as cs
    from deepchem_tpu_torch import (CGCNNModel, ElemNetModel,
                                    InfoMax3DModular, LCNNModel,
                                    MEGNetModel, NumpyDataset)
    from deepchem_tpu_torch.models import MultitaskRegressor
    makers = {
        'cgcnn': (lambda s: CGCNNModel(**cs.CGCNN, device='cpu', seed=s),
                  data['cgcnn'], data['y']),
        'lcnn': (lambda s: LCNNModel(**cs.LCNN, device='cpu', seed=s),
                 data['lcnn'], data['y']),
        'megnet': (lambda s: MEGNetModel(**cs.MEGNET, device='cpu', seed=s),
                   data['cgcnn'], data['y']),
        'elemnet': (lambda s: ElemNetModel(**cs.ELEMNET, device='cpu',
                                           seed=s),
                    data['elemnet'], data['y']),
        **{key: (lambda s, w=data[key].shape[1]: MultitaskRegressor(
            n_features=w, **cs.MATERIAL_REGRESSOR, device='cpu', seed=s),
            data[key], data['y'])
           for key in ('sine_coulomb', 'element_property')},
        'infomax3d_pretrain': (lambda s: InfoMax3DModular(
            task='pretrain', **cs.INFOMAX3D, device='cpu', seed=s),
            data['conformer'], data['conformer_y']),
        'infomax3d_regression': (lambda s: InfoMax3DModular(
            task='regression', n_tasks=1, **cs.INFOMAX3D, device='cpu',
            seed=s), data['conformer'], data['conformer_y'])}
    for name, (make, X, y) in makers.items():
        ds = NumpyDataset(X, y)
        worst = [0.0, 0.0, 0.0]
        for seed in (1, 2, 3, 4):
            runs = []
            for eps in (0.0, 1e-7):
                model = make(seed)
                noise = torch.Generator().manual_seed(7)
                with torch.no_grad():
                    for p in model.module.parameters():
                        p.mul_(1 + eps * torch.randn(p.shape,
                                                     generator=noise))
                losses = []
                model.fit_on_device(ds, nb_epoch=1, all_losses=losses)
                model.fit_on_device(ds, nb_epoch=2, all_losses=losses)
                runs.append(losses)
            worst = [max(w, abs(a - b) / max(1.0, abs(b)))
                     for w, a, b in zip(worst, *runs)]
        print(json.dumps({'model': name, 'seeds': [1, 2, 3, 4],
                          'perturbation': 1e-7,
                          'epoch_loss_rel_diff': worst}), flush=True)


if __name__ == '__main__':
    sys.exit(main())
