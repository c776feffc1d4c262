#!/usr/bin/env python3
"""What P4's bf16 limits on o and on the gradients must tell apart: the
relative error of sound results and of results with one fault put in.

    python3 scripts/flash_controls.py [--cpu]

For each bfloat16 case of ``chip_smoke.py``'s phase 6 (the same inputs,
made from the same seed on the same device), the forward's o and every
gradient ``g`` of q, k and v are held against the float32 reference as
``chip_smoke.py`` makes it (the plain forward, and autograd through it),
and the error is read as ``max|x - ref| / max|ref|``, per tensor, the
measure that ``FLASH_FWD_RTOL`` and ``FLASH_GRAD_RTOL`` bound.

Readings of o:

- ``port``: the port's forward (the kernel on the card; on the CPU the
  plain version);
- ``plain``: p = exp(s - m) rounded to bf16, o = p v / l in float32,
  rounded to bf16, as the kernel rounds them;
- ``p_3bit``: p rounded to 3 mantissa bits (fp8 e4m3's precision,
  without its range) in place of bf16's 7;
- ``pv_tile_lost``: the last 64-key tile adds to l but not to o, what a
  missed product ``o += p v`` gives;
- ``v_rows_shifted``: the first 64-key tile's v rows taken 8 rows on
  (the tile's rows rolled), what a v descriptor started one 8-row group
  off gives;
- ``alpha_half``: the online softmax by 64-key tiles, with the upper half
  of o's columns never rescaled by alpha.

Readings of the gradients:

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
last line with, for o and for the gradients, the largest sound reading
(``port``, ``plain``) and the least reading of each control.  The plain
versions run on the first 2 batch rows from S = 2048 on, as in
``chip_smoke.py``; ``--cpu`` runs the cases up to S = 256 on the CPU, on
their first 2 batch rows.
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


def forward_formulas(q, k, v, scale, fault=None):
    """o in bf16 from the plain version's formulas, p rounded to bf16 (or
    as ``fault`` says)."""
    import torch
    from deepchem_tpu_torch.ops.flash_attention import _scores
    S = q.shape[2]
    last = (S - 1) // 64 * 64
    s = _scores(q, k, scale)
    vf = v.float()
    if fault == 'alpha_half':
        half = v.shape[-1] // 2
        acc = torch.zeros(q.shape, device=q.device)
        mx = torch.full(s.shape[:-1] + (1,), -float('inf'), device=q.device)
        lsum = torch.zeros_like(mx)
        for k0 in range(0, S, 64):
            st = s[..., k0:k0 + 64]
            mn = torch.maximum(mx, st.amax(-1, keepdim=True))
            alpha = torch.exp(mx - mn)
            p = torch.exp(st - mn).to(torch.bfloat16).float()
            lsum = lsum * alpha + torch.exp(st - mn).sum(-1, keepdim=True)
            acc[..., :half] *= alpha
            acc += p @ vf[..., k0:k0 + 64, :]
            mx = mn
        return (acc / lsum).to(torch.bfloat16)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    l = e.sum(-1, keepdim=True)
    p = round_mantissa(e, 3) if fault == 'p_3bit' \
        else e.to(torch.bfloat16).float()
    if fault == 'pv_tile_lost':
        p[..., last:] = 0
    if fault == 'v_rows_shifted':
        vf = vf.clone()
        vf[..., :64, :] = vf[..., :64, :].roll(-8, dims=-2)
    return (p @ vf / l).to(torch.bfloat16)


FWD_FAULTS = ('p_3bit', 'pv_tile_lost', 'v_rows_shifted', 'alpha_half')


def case(name, shape, dev, rows):
    """({reading: rel o}, {reading: [rel dq, rel dk, rel dv]}) for one
    case."""
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
    ref_o = flash_attention_reference(*ref_in, scale)
    ref_o.backward(do.float())
    ref_o = ref_o.detach()
    refs = [t.grad for t in ref_in]

    def rel_o(out):
        return ((out.float() - ref_o).abs().max()
                / ref_o.abs().max()).item()
    fwd = {'port': rel_o(o)}
    for fault in (None,) + FWD_FAULTS:
        fwd[fault or 'plain'] = rel_o(forward_formulas(q, k, v, scale,
                                                       fault))

    def rel(grads):
        return [((g.float() - r).abs().max() / r.abs().max()).item()
                for g, r in zip(grads, refs)]
    out = {'port': rel([dq, dk, dv])}
    for fault in (None, 'p_ds_3bit', 'stale_stats', 'stale_lane0',
                  'last_tile_lost'):
        out[fault or 'plain'] = rel(formulas(q, k, v, do, m, l, di, scale,
                                             fault))
    return fwd, out


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
        print('flash_controls: no CUDA device (--cpu runs the CPU)',
              file=sys.stderr)
        return 1
    summary = {'o': {}, 'grad': {}}
    for name, shape in cases:
        rows = 2 if args.cpu or shape[2] >= 2048 else shape[0]
        fwd, grad = case(name, shape, dev, rows)
        print(json.dumps({'case': name, 'shape': list(shape), 'rows': rows,
                          'device': str(dev), 'rel_o': fwd,
                          'rel_dq_dk_dv': grad}), flush=True)
        for what, res in (('o', {k: [x] for k, x in fwd.items()}),
                          ('grad', grad)):
            for reading, vals in res.items():
                pick = max if reading in ('port', 'plain') else min
                summary[what][reading] = pick(
                    [summary[what].get(reading, vals[0])] + vals)
    print(json.dumps({what: {'sound_max': max(s.pop('port'), s.pop('plain')),
                             'control_min': s}
                      for what, s in summary.items()}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
