#!/usr/bin/env python3
"""What P4's bf16 gradient limit must tell apart: the relative error of
sound gradients and of gradients with one fault put in.

    python3 scripts/flash_grad_controls.py [--cpu]

For each bfloat16 case of ``chip_smoke.py``'s phase 6 (the same inputs,
made from the same seed on the same device), every gradient ``g`` of q,
k and v is held against the float32 reference as ``chip_smoke.py`` makes
it (autograd through the plain forward), and the error is read as
``max|g - ref| / max|ref|``, per tensor, the measure that
``FLASH_GRAD_RTOL`` bounds.  Readings:

- ``port``: the port's backward (the kernels on the card; on the CPU the
  plain versions);
- ``plain``: the formulas of the plain versions, p and ds rounded to
  bf16 before the products, as the kernels round them;
- ``p_ds_3bit``: p and ds rounded to 3 mantissa bits (fp8 e4m3's
  precision, without its range) in place of bf16's 7;
- ``stale_stats``: queries 64 to 127 of every (batch, head) take m, 1/l
  and di of queries 0 to 63, what a slot whose statistics were not yet
  written would hold;
- ``stale_lane0``: only queries 64 and 96 (the two that lane 0 of the
  producer writes for the second tile) take the statistics of queries 0
  and 32;
- ``last_tile_lost``: the last 64-row tile of the other side (queries
  for dK and dV, keys for dQ) adds nothing.

Prints the card's name and power limit, one JSON line per case and a
last line with the largest sound reading (``port``, ``plain``) and the
least reading of each control.  The plain versions run on the first 2
batch rows from S = 2048 on, as in ``chip_smoke.py``; ``--cpu`` runs the
cases up to S = 256 on the CPU, on their first 2 batch rows.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def round_mantissa(x, bits: int):
    """``x`` rounded to ``bits`` stored mantissa bits, any exponent."""
    import torch
    m, e = torch.frexp(x)
    step = 2.0 ** (bits + 1)
    return torch.ldexp(torch.round(m * step) / step, e)


def formulas(q, k, v, do, m, l, di, scale, fault=None):
    """dq, dk and dv in bf16 from the plain versions' formulas, p and ds
    rounded to bf16 (or as ``fault`` says)."""
    import torch
    from deepchem_tpu_torch.ops.flash_attention import _probs_and_ds
    S = q.shape[2]
    if fault in ('stale_stats', 'stale_lane0'):
        m, l, di = (t.clone() for t in (m, l, di))
        rows = [64, 96] if fault == 'stale_lane0' else list(range(64, 128))
        for t in (m, l, di):
            t[..., rows] = t[..., [r - 64 for r in rows]]
    p, ds = _probs_and_ds(q, k, v, do, m, l, di, scale)
    if fault == 'p_ds_3bit':
        p, ds = round_mantissa(p, 3), round_mantissa(ds, 3)
    else:
        p, ds = (t.to(torch.bfloat16).float() for t in (p, ds))
    p_kv, ds_kv, ds_q = p, ds, ds
    if fault == 'last_tile_lost':
        last = (S - 1) // 64 * 64
        p_kv, ds_kv, ds_q = p.clone(), ds.clone(), ds.clone()
        p_kv[..., last:, :] = 0       # rows: queries
        ds_kv[..., last:, :] = 0
        ds_q[..., :, last:] = 0       # columns: keys
    dq = ds_q @ k.float()
    dk = ds_kv.transpose(-1, -2) @ q.float()
    dv = p_kv.transpose(-1, -2) @ do.float()
    return [t.to(torch.bfloat16) for t in (dq, dk, dv)]


def case(name, shape, dev, rows):
    """{reading: [rel dq, rel dk, rel dv]} for one case."""
    import torch
    from deepchem_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_forward, flash_attention_reference)
    B, H, S, D = shape
    gen = torch.Generator(dev).manual_seed(0)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                   .to(torch.bfloat16)[:rows] for _ in range(4))
    scale = D ** -0.5
    o, m, l = flash_attention_forward(q, k, v, scale)
    di = (o.float() * do.float()).sum(-1)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, m, l, di, scale)
    dq = flash_attention_bwd_dq(q, k, v, do, m, l, di, scale)
    ref_in = [t.float().requires_grad_() for t in (q, k, v)]
    flash_attention_reference(*ref_in, scale).backward(do.float())
    refs = [t.grad for t in ref_in]

    def rel(grads):
        return [((g.float() - r).abs().max() / r.abs().max()).item()
                for g, r in zip(grads, refs)]
    out = {'port': rel([dq, dk, dv])}
    for fault in (None, 'p_ds_3bit', 'stale_stats', 'stale_lane0',
                  'last_tile_lost'):
        out[fault or 'plain'] = rel(formulas(q, k, v, do, m, l, di, scale,
                                             fault))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--cpu', action='store_true')
    args = ap.parse_args()
    import torch
    from chip_smoke import CROSSOVER_S, CROSSOVER_TOKENS, FLASH_MAIN
    cases = [('encoder_bf16', FLASH_MAIN),
             ('unaligned_S200_D32_bfloat16', (3, 4, 200, 32))] \
        + [(f'crossover_S{s}', (CROSSOVER_TOKENS // s, 12, s, 64))
           for s in CROSSOVER_S]
    if args.cpu:
        dev = torch.device('cpu')
        cases = [(n, s) for n, s in cases if s[2] <= 256]
    elif torch.cuda.is_available():
        dev = torch.device('cuda', 0)
        print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, check=True).stdout.strip(),
              flush=True)
    else:
        print('flash_grad_controls: no CUDA device (--cpu runs the CPU)',
              file=sys.stderr)
        return 1
    summary = {}
    for name, shape in cases:
        rows = 2 if args.cpu or shape[2] >= 2048 else shape[0]
        res = case(name, shape, dev, rows)
        print(json.dumps({'case': name, 'shape': list(shape), 'rows': rows,
                          'device': str(dev), 'rel_dq_dk_dv': res}),
              flush=True)
        for reading, vals in res.items():
            pick = max if reading in ('port', 'plain') else min
            summary[reading] = pick([summary.get(reading, vals[0])] + vals)
    print(json.dumps({'sound_max': max(summary.pop('port'),
                                       summary.pop('plain')),
                      'control_min': summary}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
