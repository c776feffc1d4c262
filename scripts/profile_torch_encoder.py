#!/usr/bin/env python3
"""Where the encoder's request, or training step, time goes on one CUDA
card.

    python3 scripts/profile_torch_encoder.py [--mode serve|train]
        [--route einsum|flash] [--dtype bfloat16|float32] [--batch 16]
        [--steps 20]

Builds ``chip_smoke.py``'s encoder (BertEncoderMLM at the ChemBERTa-77M-
class width, seeded weights, computing in ``--dtype``) and runs
``--steps`` batches of ``--batch`` of its 48 SMILES in order, tokenized
and padded to 128, with 15 % of the real tokens masked:

- ``serve``: the forward pass under ``torch.no_grad`` as a request.  Host
  clock, per request: copying the batch to the card, the forward (ended
  by a synchronise) and copying the logits back.
- ``train``: one AdamW step (lr 1e-4) per batch on the MLM loss over the
  real tokens.  Host clock, per step: copy, forward and loss, backward,
  optimizer, each ended by a synchronise.
- both: ``torch.profiler`` over the same batches without the extra
  synchronises: device time by kernel, the device's busy share, and the
  share of P4's kernels (names ``flash_*``).

``--route einsum`` is the package's default attention, with the padding
mask; ``--route flash`` swaps in the flash route as ``chip_smoke.py``
does, without a mask.  Prints one JSON line and writes it to
``chiprun_out/profile_encoder_<mode>_<route>_<dtype>.json``.  Needs a
CUDA device; there is no CPU fallback.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

from profile_torch_pagtn import device_breakdown

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--mode', choices=('serve', 'train'), default='train')
    ap.add_argument('--route', choices=('einsum', 'flash'), default='flash')
    ap.add_argument('--dtype', choices=('bfloat16', 'float32'),
                    default='bfloat16')
    ap.add_argument('--batch', type=int, default=16)
    ap.add_argument('--steps', type=int, default=20)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print('profile_torch_encoder: no CUDA device', file=sys.stderr)
        return 1
    from chip_smoke import (ENCODER, ENCODER_LR, SMILES, flash_routed,
                            mlm_batch)
    from deepchem_tpu_torch import BertEncoderMLM, SmilesTokenizer
    from deepchem_tpu_torch.models import AdamW, mlm_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    tok = SmilesTokenizer.from_corpus(SMILES)
    ids, mask, mlm_in = mlm_batch(tok, SMILES, seed=0)
    model = BertEncoderMLM(**ENCODER, dtype=getattr(torch, args.dtype),
                           device=dev, seed=0)
    opt = AdamW(learning_rate=ENCODER_LR)._create_torch_optimizer(
        model.parameters())
    flash = args.route == 'flash'
    n = len(SMILES)
    picks = [[(i * args.batch + j) % n for j in range(args.batch)]
             for i in range(args.steps)]
    phases = (('to_device', 'forward', 'to_host') if args.mode == 'serve'
              else ('to_device', 'forward', 'backward', 'optimizer'))

    def step(idx, timed=False):
        sync = torch.cuda.synchronize if timed else (lambda: None)
        t = [time.perf_counter()]
        masked, tokens, real = (x[idx].to(dev) for x in (mlm_in, ids, mask))
        att = None if flash else real
        sync()
        t.append(time.perf_counter())
        if args.mode == 'serve':
            with torch.no_grad():
                logits = model.eval()(tokens, att)
            sync()
            t.append(time.perf_counter())
            logits.cpu()
            t.append(time.perf_counter())
            return t
        model.train()
        opt.zero_grad(set_to_none=True)
        loss = mlm_loss(model(masked, att), tokens, real)
        sync()
        t.append(time.perf_counter())
        loss.backward()
        sync()
        t.append(time.perf_counter())
        opt.step()
        sync()
        t.append(time.perf_counter())
        return t

    with flash_routed() if flash else contextlib.nullcontext():
        for idx in picks[:3]:                    # warm-up
            step(idx, timed=True)
        clock = dict.fromkeys(phases, 0.0)
        for idx in picks:
            t = step(idx, timed=True)
            for key, a, b in zip(phases, t, t[1:]):
                clock[key] += (b - a) * 1e3 / args.steps
        clock['total'] = sum(clock.values())
        wall_ms, kernels = device_breakdown(
            lambda: [step(idx) for idx in picks], args.steps)
    busy_us = sum(k['device_us_per_request'] for k in kernels)
    p4_us = sum(k['device_us_per_request'] for k in kernels
                if 'flash_' in k['name'])
    result = {
        'device': torch.cuda.get_device_name(0), 'mode': args.mode,
        'route': args.route, 'dtype': args.dtype, 'batch': args.batch,
        'steps': args.steps, 'host_ms_per_step': clock,
        'profiled_wall_ms_per_step': wall_ms / args.steps,
        'device_busy_ms_per_step': busy_us / 1e3,
        'device_busy_share': busy_us * args.steps / 1e3 / wall_ms
        if wall_ms else None,
        'p4_device_ms_per_step': p4_us / 1e3,
        'kernel_launches_per_step': sum(k['calls'] for k in kernels)
        / args.steps,
        'top_kernels': kernels[:25],
    }
    line = json.dumps(result)
    out = REPO / 'chiprun_out'
    out.mkdir(exist_ok=True)
    (out / f'profile_encoder_{args.mode}_{args.route}_{args.dtype}.json'
     ).write_text(line + '\n')
    print(line)
    if not kernels:
        print('profile_torch_encoder: the profiler recorded no device time',
              file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
