#!/usr/bin/env python3
"""How far float32 alone moves the step-1 gradients of chip_smoke.py phase
23's image models from float64, on the CPU and on the card.

    python3 scripts/image_float32_drift.py [--models inception,unet]
        [--batch 4] [--seed 1] [--device cuda|cpu] [--per-layer]

For each model (at phase 23's width, on its first ``--batch`` seeded disc
images, weights from ``--seed``): the step-1 gradients of one ``fit`` step
in float32 on the CPU and on ``--device``, and the same gradients in
float64 on the CPU (the module and batch cast to float64), each as the
largest ``|g - g64| / max(1, |g64|)`` over the parameters, with the
parameter it falls on; and the card's float32 gradients against the
CPU's, as phase 23 holds them.  One JSON line a model, then one a
parameter whose card gradient lies more than 2e-6 of max(1, |g64|) from
float64.  With ``--per-layer``, each convolution of the model alone:
its input and output cotangent taken from the float64 step, its
forward, input gradient, weight gradient and bias gradient in float32
on ``--device`` (under the engine's cuDNN settings) and on the CPU, each
as ``|x - x64| / max|x64|``, with the device kernels the card ran for it
(cuDNN's kernel names give the algorithm); and, in the whole model's
float32 forward on each, the outputs whose sign differs from float64's
(a ReLU follows every convolution of InceptionV3, so each is a flipped
ReLU) and the largest ``|x64|`` among them.  One JSON line a
convolution.
"""

import argparse
import copy
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def grads_float32(make, device, seed, X, y):
    from deepchem_tpu_torch import NumpyDataset
    import chip_smoke as cs
    store = {}
    model = make(device, seed, batch_size=len(X), log_frequency=1)
    model.fit(NumpyDataset(X, y), nb_epoch=1, checkpoint_interval=0,
              deterministic=True, callbacks=cs.step1_grads(store))
    return store


def grads_float64(make, seed, X, y):
    import numpy as np
    import torch
    from deepchem_tpu_torch import NumpyDataset
    model = make('cpu', seed, batch_size=len(X))
    model.module.double().train()
    batch = next(model.default_generator(NumpyDataset(X, y)))
    inputs, labels, weights = (
        [torch.from_numpy(np.asarray(a, dtype=np.float64)
                          if np.asarray(a).dtype.kind == 'f'
                          else np.asarray(a)) for a in part]
        for part in batch)
    out = model.module(*inputs)
    out = list(out) if isinstance(out, (list, tuple)) else [out]
    model._compute_loss(out, labels, weights).backward()
    return {n: p.grad for n, p in model.module.named_parameters()}


def per_layer(make, seed, X, y, device):
    """Each ``Conv`` of the model alone, from its float64 input and output
    cotangent: the float32 errors on ``device`` and on the CPU and the
    device's kernels (see the module docstring)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from deepchem_tpu_torch import NumpyDataset
    from deepchem_tpu_torch.models.conv_layers import Conv
    from deepchem_tpu_torch.models.torch_model import cudnn_float32
    model = make('cpu', seed, batch_size=len(X))
    module = model.module.double().train()
    seen = {}
    convs = [(n, m) for n, m in module.named_modules()
             if isinstance(m, Conv)]
    for name, conv in convs:
        conv.register_forward_hook(
            lambda m, i, o, name=name: seen.setdefault(name, {}).update(
                x=i[0].detach(), y=o.detach()))
        conv.register_full_backward_hook(
            lambda m, gi, go, name=name: seen[name].update(
                gy=go[0].detach()))
    batch = next(model.default_generator(NumpyDataset(X, y)))
    inputs, labels, weights = (
        [torch.from_numpy(np.asarray(a, dtype=np.float64)
                          if np.asarray(a).dtype.kind == 'f'
                          else np.asarray(a)) for a in part]
        for part in batch)
    out = module(*inputs)
    out = list(out) if isinstance(out, (list, tuple)) else [out]
    model._compute_loss(out, labels, weights).backward()
    flips = {}
    for where in {torch.device(device), torch.device('cpu')}:
        twin = copy.deepcopy(module).float().to(where)
        outs = {}
        for name, conv in twin.named_modules():
            if isinstance(conv, Conv):
                conv._forward_hooks.clear()
                conv._backward_hooks.clear()
                conv.register_forward_hook(
                    lambda m, i, o, name=name: outs.update({name: o}))
        with torch.no_grad(), cudnn_float32():
            twin(*[a.float().to(where) if a.is_floating_point()
                   else a.to(where) for a in inputs])
        for name, o in outs.items():
            y64 = seen[name]['y']
            flip = (o.cpu().double() > 0) != (y64 > 0)
            flips.setdefault(name, {})[where.type] = [
                int(flip.sum()),
                float(y64[flip].abs().max() / y64.abs().max())
                if flip.any() else 0.0]

    def run(conv, x, gy):
        x = x.clone().requires_grad_()
        with cudnn_float32():
            out = conv(x)
            out.backward(gy)
        return [out.detach(), x.grad, conv.weight.grad, conv.bias.grad]
    dev = torch.device(device)
    for name, conv in convs:
        x64, gy64 = seen[name]['x'], seen[name]['gy']
        conv.zero_grad()
        ref = run(conv, x64, gy64)
        errs = {}
        for where in {dev, torch.device('cpu')}:
            c = copy.deepcopy(conv).float().to(where)
            c.zero_grad()
            got = run(c, x64.float().to(where), gy64.float().to(where))
            errs[where.type] = [
                float((g.double().cpu() - r).abs().max()
                      / max(float(r.abs().max()), 1e-30))
                for g, r in zip(got, ref)]
        kernels = []
        if dev.type == 'cuda':
            c = copy.deepcopy(conv).float().to(dev)
            xs, gys = x64.float().to(dev), gy64.float().to(dev)
            run(c, xs, gys)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run(c, xs, gys)
                torch.cuda.synchronize()
            kernels = sorted({e.key for e in prof.key_averages()
                              if e.device_type
                              == torch.autograd.DeviceType.CUDA})
        print(json.dumps({
            'conv': name, 'x': list(x64.shape),
            'weight': list(conv.weight.shape), 'strides': conv.strides,
            'errors [out, dx, dw, db]': errs,
            'sign_flips [n, max |y64| / max |y64|]': flips[name],
            'device_kernels': kernels}),
            flush=True)


def scaled(a, b, n):
    """``|a - b| / max(1, |b|)`` of parameter ``n``'s gradients."""
    return float((a[n].double() - b[n].double()).abs().max()) \
        / max(1.0, float(b[n].double().abs().max()))


def worst(a, b):
    errs = {n: scaled(a, b, n) for n in b}
    name = max(errs, key=errs.get)
    return errs[name], name


def main() -> int:
    import numpy as np
    import torch
    import chip_smoke as cs
    from deepchem_tpu_torch import (ChemCeption, InceptionV3Model,
                                    OneFormer, UNetModel)
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--models', default='inception,unet,chemception,'
                                        'oneformer')
    ap.add_argument('--batch', type=int, default=4)
    ap.add_argument('--seed', type=int, default=1)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--per-layer', action='store_true')
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    d = cs.seq_image_data()
    cases = {}
    im, mk = d['inception']
    cover = mk.mean(axis=(1, 2))
    cases['inception'] = (lambda dv, s, **kw: InceptionV3Model(
        device=dv, seed=s, **kw), im,
        (cover > np.median(cover)).astype(np.float32)[:, None])
    im, mk = d['unet']
    cases['unet'] = (lambda dv, s, **kw: UNetModel(device=dv, seed=s, **kw),
                     im, mk[..., None])
    cases['chemception'] = (lambda dv, s, **kw: ChemCeption(
        **cs.CHEMCEPTION, device=dv, seed=s, **kw), d['images'], d['reg'])
    im, mk = d['oneformer']
    cases['oneformer'] = (lambda dv, s, **kw: OneFormer(
        **cs.ONEFORMER, device=dv, seed=s, **kw),
        np.round(im * 255).astype(np.float32), mk.astype(np.int64))
    for name in args.models.split(','):
        make, X, y = cases[name]
        X, y = X[:args.batch], y[:args.batch]
        g64 = grads_float64(make, args.seed, X, y)
        cpu = grads_float32(make, 'cpu', args.seed, X, y)
        card = grads_float32(make, torch.device(args.device), args.seed, X,
                             y)
        card = {n: g.cpu() for n, g in card.items()}
        print(json.dumps({
            'model': name, 'batch': args.batch, 'seed': args.seed,
            'device': args.device if args.device == 'cpu'
            else torch.cuda.get_device_name(0),
            'cpu_f32_vs_f64': worst(cpu, g64),
            'device_f32_vs_f64': worst(card, g64),
            'device_vs_cpu_f32': worst(card, cpu)}), flush=True)
        for n in sorted(g64, key=lambda n: -scaled(card, g64, n)):
            if scaled(card, g64, n) <= 2e-6:
                break
            print(json.dumps({'model': name, 'parameter': n,
                              'shape': list(g64[n].shape),
                              'device_f32_vs_f64': scaled(card, g64, n),
                              'cpu_f32_vs_f64': scaled(cpu, g64, n),
                              'device_vs_cpu_f32': scaled(card, cpu, n)}),
                  flush=True)
        if args.per_layer:
            per_layer(make, args.seed, X, y, args.device)
    return 0


if __name__ == '__main__':
    sys.exit(main())
