#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases:
  1. device  -- the card's name and power limit; TF32 off for matmuls and
                convolutions, so the card computes in full float32 (P4's
                float32 forward keeps f32's digits by three tf32 passes
                of its own, whatever these flags say).
  2. build   -- compiles every kernel under deepchem_tpu_torch/csrc/, one
                nvcc for each source, all at once, and prints ptxas's
                report; ptxas must have serialised no wgmma (info C7512).
  3. kernel  -- each kernel against its plain PyTorch version on the card:
                P1 csr_segment_softmax and P3 csr_segment_sum on the inputs
                the model hands them, P2 fused_gather_segment_sum at the
                shapes of scripts/bench_pallas_csr.py, plus wide and edge
                cases and, for P1 and P3, segments long enough to be split
                across a block (up to 40 000 edges).  Per case:
                max abs error, a bit-identical repeat, kernel, plain and
                library times (host-clock ms a call), the kernel's device
                µs a launch and the library call's device µs (profiler),
                bound.  Then P1's backward against autograd through its
                plain version, and P2's own path: one call per bench
                shape, its launches counted.
  4. serve   -- PagtnModel(n_tasks=12, mode='classification') at its
                default widths, seeded random weights, answers requests of
                1, 16 and 31 molecules with predict_on_batch; the outputs
                are checked and held against the same model on the CPU, and
                P1's and P3's launches are read.
  5. train   -- the same model with dropout 0.1 fits the 48 molecules with
                seeded 0/1 labels for 4 epochs (12 steps of 16); losses,
                step-1 gradients and launches are checked.  A dropout-free
                copy is held against the CPU, and a fixed batch must
                overfit.
  6. flash   -- P4's three kernels (flash_attention_fwd, _dkv, _dq) against
                the plain flash attention on the card: at the encoder's
                shape [32, 12, 128, 64] in bfloat16 and float32, at
                scripts/attn_crossover.py's shapes (H 12, D 64, 65 536
                tokens, S 128 to 4096) in bfloat16, and at S 200, D 32;
                in float32 also at S 512 and 4096.
                Per case and kernel: max abs error (and the forward's m
                and l row by row; in bfloat16 also against the output's
                own max |ref|; in float32 o, dK, dV and dQ and the plain
                version's, recorded against the plain version in
                float64), a bit-identical repeat, kernel, plain
                and library (SDPA) times, device µs a launch, bound; the
                device µs of whole calls of SDPA's forward, SDPA's
                backward and the port's backward (di, dK/dV and dQ).  Then
                P4's own path: forward and backward once per crossover
                shape, its launches counted.
  7. encoder -- BertEncoderMLM at the ChemBERTa-77M-class width (vocab 600,
                hidden 768, 12 layers, 12 heads, intermediate 3072),
                seeded random weights, float32, answers requests of 1, 16
                and 31 SMILES tokenized by SmilesTokenizer.from_corpus and
                padded to 128 with an attention mask (the einsum route);
                logits held against a CPU run of the same weights.
  8. encoder through P4 -- the module's attention swapped for the flash
                route (as scripts/mfu_ablation.py swaps it in JAX), no
                mask: a forward and one training step held against the
                einsum route on the card, 10 AdamW steps at lr 1e-4,
                batch 16, in bfloat16 and in float32, each with 12
                launches of each P4 kernel a step, and a fixed batch that
                must overfit.
  9. encoder gradients -- the einsum route in float32, card against CPU:
                every parameter's step-1 gradient.
 10. kernels -- one JSON line with each kernel's numbers.
The last line is the JSON device record.  Any failed check exits non-zero.
"""

import contextlib
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parent

# 48 drug-like and Tox21-like molecules, 9 to 33 heavy atoms
SMILES = [
    'CC(=O)Oc1ccccc1C(=O)O', 'CN1C=NC2=C1C(=O)N(C(=O)N2C)C',
    'CC(C)Cc1ccc(cc1)C(C)C(=O)O', 'CC(=O)Nc1ccc(O)cc1',
    'COc1ccc2cc(ccc2c1)C(C)C(=O)O', 'OC(=O)Cc1ccccc1Nc1c(Cl)cccc1Cl',
    'CN1C(=O)CN=C(c2ccccc2)c2cc(Cl)ccc21', 'CN1CCCC1c1cccnc1',
    'CN(C)C(=N)NC(=N)N', 'CC(=O)CC(c1ccccc1)c1c(O)c2ccccc2oc1=O',
    'CC12CCC3C(CCC4=CC(=O)CCC34C)C1CCC2O',
    'CC12CCC3c4ccc(O)cc4CCC3C1CCC2O', 'CC(C)(c1ccc(O)cc1)c1ccc(O)cc1',
    'Oc1cc(Cl)ccc1Oc1ccc(Cl)cc1Cl', 'CCNc1nc(Cl)nc(NC(C)C)n1',
    'ClC(Cl)(Cl)C(c1ccc(Cl)cc1)c1ccc(Cl)cc1',
    'CCC1(C(=O)NC(=O)NC1=O)c1ccccc1', 'CCN(CC)CC(=O)Nc1c(C)cccc1C',
    'CC(C)NCC(O)COc1cccc2ccccc12', 'CNCCC(Oc1ccc(cc1)C(F)(F)F)c1ccccc1',
    'CNC1CCC(c2ccc(Cl)c(Cl)c2)c2ccccc12',
    'CCC(=C(c1ccccc1)c1ccc(OCCN(C)C)cc1)c1ccccc1',
    'CN(C)CCCN1c2ccccc2Sc2ccc(Cl)cc21',
    'OC1(CCN(CCCC(=O)c2ccc(F)cc2)CC1)c1ccc(Cl)cc1',
    'COc1ccc2[nH]c(nc2c1)S(=O)Cc1ncc(C)c(OC)c1C',
    'OC(=O)c1cn(C2CC2)c2cc(N3CCNCC3)c(F)cc2c1=O',
    'Cc1cc(NS(=O)(=O)c2ccc(N)cc2)no1', 'COc1cc(Cc2cnc(N)nc2N)cc(OC)c1OC',
    'CC1(C)SC2C(NC(=O)C(N)c3ccc(O)cc3)C(=O)N2C1C(=O)O',
    'CCCCc1nc(Cl)c(CO)n1Cc1ccc(cc1)-c1ccccc1-c1nn[nH]n1',
    'COc1ccc(CCN(C)CCCC(C#N)(C(C)C)c2ccc(OC)c(OC)c2)cc1OC',
    'COC(=O)C1=C(C)NC(C)=C(C1c1ccccc1[N+](=O)[O-])C(=O)OC',
    'c1ccc2c(c1)cc1ccc3cccc4ccc2c1c34', 'Oc1ccc(cc1)[N+](=O)[O-]',
    'Oc1ccc(cc1)-c1coc2cc(O)cc(O)c2c1=O',
    'Oc1cc(O)c2c(c1)oc(-c1ccc(O)c(O)c1)c(O)c2=O',
    'CC1CC2C3CCC4=CC(=O)C=CC4(C)C3(F)C(O)CC2(C)C1(O)C(=O)CO',
    'CC(=O)C1CCC2C3CCC4=CC(=O)CCC4(C)C3CCC12C',
    'CC(C)C(=O)Nc1ccc(c(c1)C(F)(F)F)[N+](=O)[O-]',
    'CC1(OC(=O)N(C1=O)c1cc(Cl)cc(Cl)c1)C=C',
    'COc1ccc(cc1)C(c1ccc(OC)cc1)C(Cl)(Cl)Cl', 'CCCCCCCCCc1ccc(O)cc1',
    'CCCCOC(=O)c1ccccc1C(=O)OCCCC', 'NC(=O)N1c2ccccc2C=Cc2ccccc21',
    'OC(=O)CNCP(=O)(O)O', 'Oc1c(Cl)c(Cl)c(Cl)c(Cl)c1Cl',
    'O=C1NC(=O)C(N1)(c1ccccc1)c1ccccc1',
    'Cc1ccc(cc1)-c1cc(nn1-c1ccc(cc1)S(N)(=O)=O)C(F)(F)F',
]
REQUESTS = (1, 16, 31)          # molecules per predict_on_batch request
# scripts/bench_pallas_csr.py:76-78, (nodes, edges, features)
P2_BENCH_SHAPES = [(2048, 4096, 64), (2048, 4096, 256),
                   (8192, 16384, 256), (8192, 16384, 512),
                   (16384, 32768, 512)]
KERNEL_ATOL = 1e-6              # P1: same f32 inputs, another summation order
SUM_RTOL = 1e-5                 # P3, P2: atol 1e-5 * max(1, max |out|)
CPU_ATOL = 1e-4                 # whole model, f32, another summation order
GRAD_ATOL = 1e-5                # step-1 gradients, card against the CPU
TRAIN_RTOL = 1e-4               # 12-step loss trajectory, card against CPU
HBM_BYTES_PER_S = 3.35e12       # H100 SXM published peaks
F32_OPS_PER_S = 67e12           # FMA units
BF16_OPS_PER_S = 989e12         # dense, tensor cores
TF32_OPS_PER_S = 494.7e12       # dense, tensor cores
TF32_PASSES = 3                 # P4 in f32: 3xTF32 on the tensor cores
# scripts/bench_chemberta_mfu.py:44-70: the ChemBERTa-77M-class encoder
ENCODER = dict(vocab_size=600, hidden=768, layers=12, heads=12,
               intermediate=3072, max_positions=130)
SEQ = 128                       # tokens a sequence, padded
ENCODER_BATCH = 16              # training batch
ENCODER_LR = 1e-4               # the benches' optax.adamw rate
FLASH_MAIN = (32, 12, 128, 64)  # the encoder's attention, [B, H, S, D]
# scripts/attn_crossover.py:27-35: H = 12, D = 64, 65 536 tokens a call
CROSSOVER_TOKENS = 65536
CROSSOVER_S = (128, 256, 512, 1024, 2048, 4096)
F32_CROSSOVER_S = (512, 4096)   # P4 in f32 at these too
PLAIN_ROWS_FROM_S = 2048        # from here the plain version takes 2 rows
# P4 against the plain version in float32 from the same inputs, scaled by
# max(1, |ref|): forward, then gradients; bfloat16 rounds p, ds and outputs
FLASH_TOL = {'float32': (1e-5, 1e-4), 'bfloat16': (2e-2, 5e-2)}
# and the bfloat16 o and each bfloat16 gradient within these of their own
# max |ref|, no floor: at phase 6's shapes sound o reads up to 0.0031 of it
# and the forward with one fault put in 0.0107 or more, sound gradients up
# to 0.0057 and the formulas with one fault 0.024 or more (H100,
# scripts/flash_controls.py)
FLASH_FWD_RTOL = 7e-3
FLASH_GRAD_RTOL = 1e-2
ROUTE_TOL = {'float32': 1e-4, 'bfloat16': 2e-2}   # flash against einsum
# the forward's m and l against the plain version's, each within this of
# max(1, |ref|): the same scores summed in another order, exp by ex2.approx
STAT_RTOL = 1e-5


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f'check failed: {what}')


def time_ms(fn, iters: int = 200) -> float:
    """Mean ms per call of ``fn``, from CUDA events around ``iters``
    back-to-back calls after a warm-up.  Where a call's host work outlasts
    its kernels, this is the host's cost per call."""
    import torch
    for _ in range(10):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_us(fn, kernel: str, bound_us: float = 0.0, calls: int = 20,
              tries: int = 5) -> float:
    """Device µs per launch of the kernel whose name holds ``kernel``, from
    ``torch.profiler`` over ``calls`` calls of ``fn``; each call must
    launch it once.  The profiler has been seen to drop a kernel record
    of a run and to read a kernel at half its time (torch 2.11, CUDA
    12.8), so a run counts only if its mean is at least ``bound_us`` and
    it agrees with the card's clock where that can be read: where the
    host queued the calls in under half the time the card took for them
    (CUDA events around the run), the card was never idle, and its device
    records, a dropped launch counted at the mean, must fill at least 0.7
    of that time; elsewhere every launch must have been recorded.  A run
    that fails is profiled again, up to ``tries`` runs, and the check
    fails if none counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start.record()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            host_us = (time.perf_counter() - t0) * 1e6
            end.record()
            torch.cuda.synchronize()
        card_us = start.elapsed_time(end) * 1e3
        total, count, busy = 0.0, 0, 0.0
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                busy += evt.self_device_time_total
                if kernel in evt.key:
                    total += evt.self_device_time_total
                    count += evt.count
        mean = total / count if count else 0.0
        filled = (busy + (calls - count) * mean) / card_us
        runs.append((count, round(mean, 2), round(filled, 3),
                     round(host_us / card_us, 3)))
        if 0 < count <= calls and mean >= bound_us \
                and (filled >= 0.7 if host_us < 0.5 * card_us
                     else count == calls):
            return mean
    check(False, f'{kernel}: no profile of {calls} calls counted (launches, '
          f'µs a launch, share of the card time filled, host time / card '
          f'time): {runs}; bound {bound_us:.3f} µs')


def device_us_all(fn, calls: int = 20, tries: int = 2):
    """Device µs a call of ``fn`` over every CUDA kernel (and memset or
    copy) it launches, and the kernels a call, from ``torch.profiler``
    windows of ``calls`` calls.  Per kernel name: its mean time a record,
    times its launches a call (its records over ``calls``, rounded; the
    most of ``tries`` windows).  The profiler can drop a record or two of
    a window (see :func:`device_us`), which moves a mean little and the
    rounded count not at all."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = {}                     # name: (records, total µs)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                seen[e.key] = max(seen.get(e.key, (0, 0.0)),
                                  (e.count, e.self_device_time_total))
    per_call = {k: max(1, round(n / calls)) for k, (n, _) in seen.items()}
    check(bool(seen), 'the profiler recorded a device event')
    return (sum(t / n * per_call[k] for k, (n, t) in seen.items()),
            sum(per_call.values()))


def bound(nbytes: int, ops: int, ops_per_s: float = F32_OPS_PER_S):
    """The least time for the work, ms, and what sets it."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return max(bytes_ms, ops_ms), ('bytes' if bytes_ms >= ops_ms
                                   else 'operations')


def max_err(a, b) -> float:
    return (a - b).abs().max().item() if a.numel() else 0.0


def sum_tol(ref) -> float:
    return SUM_RTOL * max(1.0, ref.abs().max().item() if ref.numel()
                          else 0.0)


def library_softmax(logits, row_ptr):
    """The segment softmax as one PyTorch library call, for comparison
    only: ``torch.sparse.softmax`` over a sparse ``[N, E, H]`` tensor whose
    rows are the segments.  Unspecified entries count as -inf, so each
    row's softmax is its segment's.  The COO index it needs is built from
    ``row_ptr`` here, and is timed with the call."""
    import torch
    E, H = logits.shape
    N = row_ptr.shape[0] - 1
    edges = torch.arange(E, dtype=torch.int32, device=logits.device)
    seg = torch.searchsorted(row_ptr[1:], edges, right=True)
    coo = torch.sparse_coo_tensor(
        torch.stack([seg, edges.long()]), logits, (N, E, H),
        is_coalesced=True, check_invariants=False)
    return torch.sparse.softmax(coo, dim=1).values()


def library_segment_sum(msgs, row_ptr):
    """P3's function as one library call, for comparison only."""
    import torch
    return torch.segment_reduce(msgs, 'sum', offsets=row_ptr.long(), axis=0)


def library_neighbor_sum(h, src, row_ptr):
    """P2's function as one library call, for comparison only: a CSR
    adjacency times ``h``; the CSR tensor is built inside the timed call."""
    import torch
    E = src.shape[0]
    adj = torch.sparse_csr_tensor(
        row_ptr, src, torch.ones(E, dtype=h.dtype, device=h.device),
        (row_ptr.shape[0] - 1, h.shape[0]), check_invariants=False)
    return torch.sparse.mm(adj, h)


def softmax_case(name, logits, row_ptr):
    """P1 kernel and library call against the plain version on the card,
    with times and bound."""
    import torch
    from deepchem_tpu_torch.ops.csr_segment import (
        csr_segment_softmax, csr_segment_softmax_reference)
    y = csr_segment_softmax(logits, row_ptr)
    again = csr_segment_softmax(logits, row_ptr)
    torch.cuda.synchronize()
    y_ref = csr_segment_softmax_reference(logits, row_ptr)
    err = max_err(y, y_ref)
    # the library gives NaN where a segment's head has no finite logit;
    # the kernel, like the TPU's, gives 0 there
    y_lib = library_softmax(logits, row_ptr)
    nan = ~torch.isfinite(y_lib)
    check(bool((y_ref[nan] == 0).all()),
          f'{name}: library NaN only where no logit is finite')
    lib_err = (y_lib - y_ref)[~nan].abs().max().item()
    E, H = logits.shape
    N = row_ptr.shape[0] - 1
    # each input read once, the output written once; ~8 operations an
    # element (max, subtract, exp, add; subtract, exp, divide, rescale)
    bound_ms, bound_by = bound(2 * E * H * 4 + (N + 1) * 4, 8 * E * H)
    res = {'kernel': 'csr_segment_softmax', 'case': name, 'E': E, 'H': H,
           'N': N, 'max_abs_err': err,
           'repeat_identical': torch.equal(y, again),
           'ms': time_ms(lambda: csr_segment_softmax(logits, row_ptr)),
           'device_us': device_us(
               lambda: csr_segment_softmax(logits, row_ptr),
               'csr_segment_softmax_kernel', bound_ms * 1e3),
           'plain_ms': time_ms(
               lambda: csr_segment_softmax_reference(logits, row_ptr)),
           'library_err': lib_err,
           'library_ms': time_ms(lambda: library_softmax(logits, row_ptr)),
           'bound_ms': bound_ms, 'bound_by': bound_by}
    res['library_device_us'], res['library_kernels'] = device_us_all(
        lambda: library_softmax(logits, row_ptr))
    print(f'phase 3 kernel {json.dumps(res)}', flush=True)
    check(err <= KERNEL_ATOL, f'{name}: kernel error {err} > {KERNEL_ATOL}')
    check(lib_err <= KERNEL_ATOL,
          f'{name}: library error {lib_err} > {KERNEL_ATOL}')
    check(res['repeat_identical'], f'{name}: a repeat differs')
    return res


def softmax_grad_case(name, logits, row_ptr, seed=0):
    """P1's Function (kernel forward, P3 in the backward) against autograd
    through the plain version, both on the card."""
    import numpy as np
    import torch
    from deepchem_tpu_torch.ops.csr_segment import (
        csr_segment_softmax, csr_segment_softmax_reference)
    w = torch.from_numpy(np.random.RandomState(seed).randn(
        *logits.shape).astype(np.float32)).to(logits.device)
    grads = []
    for fn in (csr_segment_softmax, csr_segment_softmax_reference):
        x = logits.detach().clone().requires_grad_()
        (fn(x, row_ptr) * w).sum().backward()
        grads.append(x.grad)
    err, tol = max_err(*grads), sum_tol(grads[1])
    res = {'kernel': 'csr_segment_softmax backward', 'case': name,
           'max_abs_err': err, 'finite': bool(torch.isfinite(grads[0]).all())}
    print(f'phase 3 kernel {json.dumps(res)}', flush=True)
    check(res['finite'], f'{name}: finite gradient')
    check(err <= tol, f'{name}: backward error {err} > {tol}')
    return res


def sum_case(name, msgs, row_ptr):
    """P3 kernel and library call against the plain version on the card."""
    import torch
    from deepchem_tpu_torch.ops.csr_segment import (
        csr_segment_sum, csr_segment_sum_reference)
    out = csr_segment_sum(msgs, row_ptr)
    again = csr_segment_sum(msgs, row_ptr)
    torch.cuda.synchronize()
    ref = csr_segment_sum_reference(msgs, row_ptr)
    err, tol = max_err(out, ref), sum_tol(ref)
    used = int(row_ptr[-1])                   # edges past row_ptr[N] unread
    lib_in = msgs[:used]
    lib_err = max_err(library_segment_sum(lib_in, row_ptr), ref)
    E, F = msgs.shape
    N = row_ptr.shape[0] - 1
    bound_ms, bound_by = bound(4 * (used * F + N * F + N + 1), used * F)
    res = {'kernel': 'csr_segment_sum', 'case': name, 'E': E, 'F': F,
           'N': N, 'max_abs_err': err, 'tol': tol,
           'repeat_identical': torch.equal(out, again),
           'ms': time_ms(lambda: csr_segment_sum(msgs, row_ptr)),
           'device_us': device_us(lambda: csr_segment_sum(msgs, row_ptr),
                                  'csr_segment_sum_kernel', bound_ms * 1e3),
           'plain_ms': time_ms(
               lambda: csr_segment_sum_reference(msgs, row_ptr)),
           'library_err': lib_err,
           'library_ms': time_ms(
               lambda: library_segment_sum(lib_in, row_ptr)),
           'bound_ms': bound_ms, 'bound_by': bound_by}
    res['library_device_us'], res['library_kernels'] = device_us_all(
        lambda: library_segment_sum(lib_in, row_ptr))
    print(f'phase 3 kernel {json.dumps(res)}', flush=True)
    check(err <= tol, f'{name}: kernel error {err} > {tol}')
    check(lib_err <= tol, f'{name}: library error {lib_err} > {tol}')
    check(res['repeat_identical'], f'{name}: a repeat differs')
    return res


def gather_case(name, h, src, row_ptr):
    """P2 kernel and library call against the plain version on the card."""
    import torch
    from deepchem_tpu_torch.ops.csr_segment import (
        csr_neighbor_sum_reference, fused_gather_segment_sum)
    out = fused_gather_segment_sum(h, src, row_ptr)
    again = fused_gather_segment_sum(h, src, row_ptr)
    torch.cuda.synchronize()
    ref = csr_neighbor_sum_reference(h, src, row_ptr)
    err, tol = max_err(out, ref), sum_tol(ref)
    lib_err = max_err(library_neighbor_sum(h, src, row_ptr), ref)
    Nh, F = h.shape
    N = row_ptr.shape[0] - 1
    used = int(row_ptr[-1])
    rows = src[:used].unique().numel()        # rows of h the sums read
    rest = 4 * (used + N * F + N + 1)         # src, out, row_ptr
    bound_ms, bound_by = bound(4 * rows * F + rest, used * F)
    res = {'kernel': 'fused_gather_segment_sum', 'case': name,
           'N_h': Nh, 'E': src.shape[0], 'F': F, 'N': N,
           'max_abs_err': err, 'tol': tol,
           'repeat_identical': torch.equal(out, again),
           'ms': time_ms(lambda: fused_gather_segment_sum(h, src, row_ptr)),
           'device_us': device_us(
               lambda: fused_gather_segment_sum(h, src, row_ptr),
               'fused_gather_segment_sum_kernel', bound_ms * 1e3),
           'plain_ms': time_ms(
               lambda: csr_neighbor_sum_reference(h, src, row_ptr)),
           'library_err': lib_err,
           'library_ms': time_ms(
               lambda: library_neighbor_sum(h, src, row_ptr)),
           'bound_ms': bound_ms, 'bound_by': bound_by,
           # each edge reading its row of h again, with no reuse
           'bound_no_reuse_ms': bound(4 * used * F + rest, used * F)[0]}
    res['library_device_us'], res['library_kernels'] = device_us_all(
        lambda: library_neighbor_sum(h, src, row_ptr))
    print(f'phase 3 kernel {json.dumps(res)}', flush=True)
    check(err <= tol, f'{name}: kernel error {err} > {tol}')
    check(lib_err <= tol, f'{name}: library error {lib_err} > {tol}')
    check(res['repeat_identical'], f'{name}: a repeat differs')
    return res


def library_attention(q, k, v, scale):
    """P4's forward as one library call, for comparison only: SDPA with
    its flash backend in bfloat16 and its memory-efficient backend in
    float32 (the flash backend takes no float32)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    backend = SDPBackend.FLASH_ATTENTION if q.dtype == torch.bfloat16 \
        else SDPBackend.EFFICIENT_ATTENTION
    with sdpa_kernel(backend):
        return F.scaled_dot_product_attention(q, k, v, scale=scale)


def flash_case(name, shape, dtype, dev, iters=200, seed=0):
    """P4's forward, dK/dV and dQ kernels against the plain versions on the
    card, with times and bounds: one result for each kernel.  The plain
    versions run on the first 2 batch rows from S = PLAIN_ROWS_FROM_S on (a
    [16, 12, 4096, 4096] float32 score array is 12.9 GB)."""
    import torch
    from deepchem_tpu_torch.ops.flash_attention import (
        _forward_reference, flash_attention, flash_attention_bwd_dkv,
        flash_attention_bwd_dkv_reference, flash_attention_bwd_dq,
        flash_attention_bwd_dq_reference, flash_attention_forward,
        flash_attention_reference)
    B, H, S, D = shape
    gen = torch.Generator(dev).manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for _ in range(4))
    scale = D ** -0.5

    def run():
        o, m, l = flash_attention_forward(q, k, v, scale)
        di = (o.float() * do.float()).sum(-1)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, m, l, di, scale)
        return (o, dk, dv, flash_attention_bwd_dq(q, k, v, do, m, l, di,
                                                  scale)), (m, l, di)
    outs, stats = run()
    again, again_st = run()
    torch.cuda.synchronize()
    o, (m, l) = outs[0], stats[:2]
    rows = 2 if S >= PLAIN_ROWS_FROM_S else B
    ref_in = [t[:rows].float().requires_grad_() for t in (q, k, v)]
    ref_o = flash_attention_reference(*ref_in, scale)
    ref_o.backward(do[:rows].float())
    kind = str(dtype).split('.')[-1]
    fwd_tol, grad_tol = FLASH_TOL[kind]

    def error(pairs, rtol):
        err = max(max_err(a[:rows].float(), r) for a, r in pairs)
        return err, rtol * max(1.0, max(r.abs().max().item()
                                        for _, r in pairs))

    def rel_error(pairs):
        return max(max_err(a[:rows].float(), r) / r.abs().max().item()
                   for a, r in pairs)
    dk, dv, dq = outs[1:]
    pairs = {'fwd': [(o, ref_o.detach())],
             'dkv': [(dk, ref_in[1].grad), (dv, ref_in[2].grad)],
             'dq': [(dq, ref_in[0].grad)]}
    errs = {part: error(p, grad_tol if part != 'fwd' else fwd_tol)
            for part, p in pairs.items()}
    rel = {part: rel_error(p) for part, p in pairs.items()}
    # the forward's statistics, which the backward reads, row by row
    _, ref_m, ref_l = _forward_reference(*(t[:rows] for t in (q, k, v)),
                                         scale)
    stat_err = max(((a[:rows] - r).abs() / r.abs().clamp_min(1.0)).max()
                   .item() for a, r in ((m, ref_m), (l, ref_l)))
    del ref_m, ref_l
    exact = {}
    if dtype == torch.float32:
        # o and the gradients against the plain version in float64, beside
        # the float32 plain version's own errors, each of max(1, |ref|):
        # where the two float32 results part, which is nearer the exact
        # one (recorded, not checked)
        in64 = [t[:rows].double().requires_grad_() for t in (q, k, v)]
        ref64 = torch.softmax(in64[0] @ in64[1].transpose(-1, -2) * scale,
                              dim=-1) @ in64[2]
        ref64.backward(do[:rows].double())
        got = {'fwd': [(o, ref_o.detach(), ref64.detach())],
               'dkv': [(dk, ref_in[1].grad, in64[1].grad),
                       (dv, ref_in[2].grad, in64[2].grad)],
               'dq': [(dq, ref_in[0].grad, in64[0].grad)]}

        def err64(pairs):
            return max(max_err(a.double(), r) / max(1.0, r.abs().max().item())
                       for a, r in pairs)
        exact = {part: {'err_f64': err64((a[:rows], r) for a, _, r in t),
                        'plain_err_f64': err64((p, r) for _, p, r in t)}
                 for part, t in got.items()}
        del in64, ref64, got
    same = {'fwd': torch.equal(o, again[0]) and torch.equal(m, again_st[0])
            and torch.equal(l, again_st[1]),
            'dkv': torch.equal(dk, again[1]) and torch.equal(dv, again[2]),
            'dq': torch.equal(dq, again[3])}
    del ref_in, ref_o, pairs, again
    # the library call: SDPA's forward, and its backward alone
    lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
    lib_o = library_attention(lq, lk, lv, scale)
    lib_err = max_err(lib_o[:rows].detach().float(),
                      flash_attention_reference(
                          *(t[:rows] for t in (q, k, v)), scale).float())
    lib_fwd_ms = time_ms(lambda: library_attention(q, k, v, scale), iters)
    # device time of whole calls: SDPA's forward, SDPA's backward (dQ, dK
    # and dV), and the port's backward through its autograd Function (di,
    # then the dK/dV and dQ kernels)
    lib_fwd_dev = device_us_all(lambda: library_attention(q, k, v, scale))
    lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
        lib_o, (lq, lk, lv), do, retain_graph=True)
    lib_bwd_ms = time_ms(lib_bwd, iters)
    lib_bwd_dev = device_us_all(lib_bwd)
    pq, pk, pv = (t.detach().requires_grad_() for t in (q, k, v))
    port_o = flash_attention(pq, pk, pv, scale)
    port_bwd_dev = device_us_all(lambda: torch.autograd.grad(
        port_o, (pq, pk, pv), do, retain_graph=True))
    del port_o, lib_o
    di = stats[2]
    small = [t[:rows] for t in (q, k, v, do, m, l, di)]
    fns = {'fwd': (lambda: flash_attention_forward(q, k, v, scale),
                   lambda: flash_attention_reference(*small[:3], scale)),
           'dkv': (lambda: flash_attention_bwd_dkv(q, k, v, do, m, l, di,
                                                   scale),
                   lambda: flash_attention_bwd_dkv_reference(*small, scale)),
           'dq': (lambda: flash_attention_bwd_dq(q, k, v, do, m, l, di,
                                                 scale),
                  lambda: flash_attention_bwd_dq_reference(*small, scale))}
    # bytes: each input read once, each output written once; operations:
    # the products of S x S by D each kernel has to do (4, 8 and 6 flops a
    # score: q k^T and p v; s and dp again, dV and dK; s, dp and dQ), at
    # the rate of the unit that runs them: the tensor cores, in bf16, or
    # in f32 by three tf32 passes
    esize, bhsd, bhs = q.element_size(), B * H * S * D, B * H * S
    bf16 = dtype == torch.bfloat16
    rate = BF16_OPS_PER_S if bf16 else TF32_OPS_PER_S / TF32_PASSES
    work = {'fwd': (4 * bhsd * esize + 2 * bhs * 4, 4 * bhs * S * D, rate),
            'dkv': (6 * bhsd * esize + 3 * bhs * 4, 8 * bhs * S * D, rate),
            'dq': (5 * bhsd * esize + 3 * bhs * 4, 6 * bhs * S * D, rate)}
    results = {}
    for part, (fn, plain) in fns.items():
        bound_ms, bound_by = bound(*work[part])
        res = {'kernel': f'flash_attention_{part}', 'case': name,
               'shape': list(shape), 'dtype': kind,
               'max_abs_err': errs[part][0], 'tol': errs[part][1],
               'repeat_identical': same[part],
               'ms': time_ms(fn, iters),
               'device_us': device_us(fn, f'flash_{part}_', bound_ms * 1e3),
               'plain_ms': time_ms(plain, iters), 'plain_rows': rows,
               'library_ms': lib_fwd_ms if part == 'fwd' else lib_bwd_ms,
               'bound_ms': bound_ms, 'bound_by': bound_by}
        res['bound_share'] = bound_ms * 1e3 / res['device_us']
        if bf16:
            res['rel_err'] = rel[part]
            res['rel_tol'] = FLASH_FWD_RTOL if part == 'fwd' \
                else FLASH_GRAD_RTOL
        lib_dev = lib_fwd_dev if part == 'fwd' else lib_bwd_dev
        res['library_device_us'], res['library_kernels'] = lib_dev
        res.update(exact.get(part, {}))
        if part == 'fwd':
            res['library_err'] = lib_err
            res['stat_err'], res['stat_tol'] = stat_err, STAT_RTOL
        else:
            res['library'] = 'SDPA backward: dQ, dK and dV in one call'
            res['backward_device_us'], res['backward_kernels'] = port_bwd_dev
        print(f'phase 6 kernel {json.dumps(res)}', flush=True)
        check(res['max_abs_err'] <= res['tol'],
              f'{name} {part}: error {res["max_abs_err"]} > {res["tol"]}')
        check(res.get('rel_err', 0.0) <= res.get('rel_tol', 0.0),
              f'{name} {part}: error {res.get("rel_err")} of max |ref| > '
              f'{res.get("rel_tol")}')
        check(res.get('stat_err', 0.0) <= STAT_RTOL,
              f'{name} {part}: m or l off by {res.get("stat_err")} of '
              f'max(1, |ref|)')
        check(same[part], f'{name} {part}: a repeat differs')
        results[part] = res
    return results


@contextlib.contextmanager
def flash_routed():
    """The encoder's attention through P4: the module-level
    ``flash_or_xla_attention`` swapped for one that passes
    ``use_flash=True``, as scripts/mfu_ablation.py swaps attention in the
    JAX package."""
    from deepchem_tpu_torch.models import bert_encoder
    einsum = bert_encoder.flash_or_xla_attention

    def flash(q, k, v, mask, use_flash=None):
        return einsum(q, k, v, mask, use_flash=True)
    bert_encoder.flash_or_xla_attention = flash
    try:
        yield
    finally:
        bert_encoder.flash_or_xla_attention = einsum


def mlm_batch(tok, smiles, seed):
    """Token ids padded to SEQ, the attention mask, and an MLM input with
    15 % of the real tokens replaced by [MASK]; the labels are the ids."""
    import numpy as np
    import torch
    ids = torch.tensor([tok.encode(s, max_length=SEQ) for s in smiles])
    mask = (ids != tok.pad_token_id).float()
    pick = torch.from_numpy(np.random.RandomState(seed).rand(*ids.shape)
                            < 0.15) & (mask > 0)
    return ids, mask, torch.where(pick, tok.mask_token_id, ids)


def encoder_step(model, inputs, labels, label_mask, mask=None):
    """Forward, MLM loss on the real tokens, backward: the logits, the loss
    and a copy of every parameter's gradient."""
    from deepchem_tpu_torch.models import mlm_loss
    model.zero_grad(set_to_none=True)
    logits = model(inputs, mask)
    loss = mlm_loss(logits, labels, label_mask)
    loss.backward()
    return logits.detach(), loss.detach(), {
        n: p.grad.detach().clone() for n, p in model.named_parameters()}


def scaled_err(a, b) -> float:
    """max |a - b| / max(1, max |b|)."""
    return max_err(a.float(), b.float()) / max(1.0, b.abs().max().item())


def recorded(module, attr, run):
    """Run ``run()`` with ``module.attr`` wrapped to record copies of its
    arguments; return them."""
    fn, seen = getattr(module, attr), []

    def record(*args):
        seen.append(tuple(a.detach().clone() for a in args))
        return fn(*args)

    # a wrapper counts its launches through its module's name for it, so
    # the stand-in shares the wrapper's attributes (``launches``)
    record.__dict__ = fn.__dict__
    setattr(module, attr, record)
    try:
        run()
    finally:
        setattr(module, attr, fn)
    return seen


def bench_graph(rng, n_nodes, n_edges, feat, dev):
    """scripts/bench_pallas_csr.py's graph: random src and dst, sorted by
    dst; h uniform in [0, 1)."""
    import numpy as np
    import torch
    from deepchem_tpu_torch.ops import edges_to_csr
    src = rng.randint(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.randint(0, n_nodes, n_edges).astype(np.int32)
    perm, row_ptr = edges_to_csr(dst, n_nodes)
    h = rng.rand(n_nodes, feat).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (h, src[perm], row_ptr)]


def _counted():
    from deepchem_tpu_torch.ops import (csr_segment_softmax, csr_segment_sum,
                                        flash_attention,
                                        flash_attention_bwd_dkv,
                                        flash_attention_bwd_dq,
                                        fused_gather_segment_sum)
    return {'csr_segment_softmax': csr_segment_softmax,
            'csr_segment_sum': csr_segment_sum,
            'fused_gather_segment_sum': fused_gather_segment_sum,
            'flash_attention_fwd': flash_attention,
            'flash_attention_dkv': flash_attention_bwd_dkv,
            'flash_attention_dq': flash_attention_bwd_dq}


def launch_counts():
    return {k: fn.launches for k, fn in _counted().items()}


def reset_launch_counts():
    for fn in _counted().values():
        fn.launches = 0


def step1_grads(store):
    """A fit callback that keeps a copy of every gradient after step 1."""
    def grab(model, step):
        if step == 1:
            store.update({n: p.grad.detach().cpu().clone()
                          for n, p in model.module.named_parameters()})
    return grab


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    if not (REPO / 'deepchem_tpu_torch' / '__init__.py').is_file():
        print('chip_smoke: the deepchem_tpu_torch package is missing beside '
              'this script', file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import numpy as np
    warnings.filterwarnings('ignore', message='Sparse CSR tensor support')

    # -- 1. device --------------------------------------------------------
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    name = torch.cuda.get_device_name(0)
    print(f'phase 1 device: {name}; torch {torch.__version__}, cuda '
          f'{torch.version.cuda}; tf32 off', flush=True)

    # -- 2. build ---------------------------------------------------------
    from deepchem_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    for kname in build.kernel_names():
        build.load(kname)
    print(f'phase 2 build: {len(build.kernel_names())} kernel(s) in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    check(len(build.kernel_names()) == 4, 'four kernel sources to build')
    for kname in build.kernel_names():
        ptxas = [ln.strip() for ln in build.build_log(kname).splitlines()
                 if 'registers' in ln or 'spill' in ln]
        print(f'phase 2 build {kname}: {" | ".join(ptxas)}', flush=True)
    # ptxas reports a wgmma it had to serialise only as an info line
    check('C7512' not in build.build_log('flash_attention'),
          'ptxas serialised no wgmma of the bf16 flash kernels (C7512)')

    # -- featurize the main path's molecules (host work) -------------------
    from deepchem_tpu_torch import (NumpyDataset, PagtnModel,
                                    PagtnMolGraphFeaturizer)
    from deepchem_tpu_torch.models import graph_models
    from deepchem_tpu_torch.ops import (NEG, csr_segment, csr_segment_softmax,
                                        flash_attention,
                                        fused_gather_segment_sum, segment)
    t0 = time.perf_counter()
    X = PagtnMolGraphFeaturizer().featurize(SMILES)
    sizes = [g.num_nodes for g in X if hasattr(g, 'num_nodes')]
    check(len(sizes) == len(SMILES), 'every molecule featurizes')
    check(min(sizes) >= 5 and max(sizes) <= 40, 'molecules of 5-40 atoms')
    print(f'featurized {len(X)} molecules of {min(sizes)}-{max(sizes)} '
          f'heavy atoms in {time.perf_counter() - t0:.2f} s', flush=True)
    labels = np.random.RandomState(0).randint(0, 2, (len(X), 12)).astype(
        np.float32)
    weights = np.ones_like(labels)
    model = PagtnModel(n_tasks=12, mode='classification', device=dev,
                       seed=0)
    n_layers = len(model.module.layers)

    # -- 3. kernels against their plain versions --------------------------
    # the inputs the model hands the wrappers in one batch of 16
    batch16 = X[1:17]
    softmax_in = recorded(segment, 'csr_segment_softmax',
                          lambda: model.predict_on_batch(batch16))
    agg_in = recorded(graph_models, 'csr_segment_sum',
                      lambda: model.predict_on_batch(batch16))
    probe = PagtnModel(n_tasks=12, mode='classification', device=dev,
                       seed=0)
    backward_in = recorded(csr_segment, 'csr_segment_sum',
                           lambda: probe.fit_on_batch(
                               batch16, labels[1:17], weights[1:17]))
    del probe
    for what, seen in (('softmax', softmax_in), ('aggregation', agg_in),
                       ('softmax backward sum', backward_in)):
        check(len(seen) == n_layers,
              f'{len(seen)} {what} calls for {n_layers} layers')

    softmax_cases = [softmax_case('pagtn_batch16_layer0', *softmax_in[0])]
    rng = np.random.RandomState(0)
    E, H, N = 16384, 8, 2048
    dst = np.sort(rng.randint(0, N, E))
    row_ptr = np.searchsorted(dst, np.arange(N + 1)).astype(np.int32)
    softmax_cases.append(softmax_case(
        'wide_E16384_H8',
        torch.from_numpy(rng.randn(E, H).astype(np.float32)).to(dev),
        torch.from_numpy(row_ptr).to(dev)))
    # segments: empty, one edge, 40 edges, all NEG, empty tail; one head
    # all -inf in the 40-edge segment
    counts = [0, 1, 40, 0, 7, 1, 0, 33, 0, 0]
    edge_logits = rng.randn(sum(counts), 4).astype(np.float32) * 30
    rp = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    edge_logits[rp[4]:rp[5]] = NEG
    edge_logits[rp[2]:rp[3], 2] = -np.inf
    edge_l, edge_rp = (torch.from_numpy(edge_logits).to(dev),
                       torch.from_numpy(rp).to(dev))
    softmax_cases.append(softmax_case('edge_segments', edge_l, edge_rp))
    # a ghost-sized segment of 1536 edges after 300 short ones, and one of
    # 40 000 edges among 511 short ones: the kernel splits both across a
    # block
    for short, long_len in ((300, 1536), (511, 40000)):
        lengths = list(rng.randint(0, 34, short)) + [long_len]
        long_rp = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
        softmax_cases.append(softmax_case(
            f'long_segment_{long_len}_H1',
            torch.from_numpy(rng.randn(int(long_rp[-1]), 1).astype(
                np.float32)).to(dev), torch.from_numpy(long_rp).to(dev)))
    y = csr_segment_softmax(edge_l, edge_rp).cpu().numpy()
    check(np.allclose(y[rp[4]:rp[5]], 1 / 7, atol=KERNEL_ATOL),
          'an all-NEG segment gives 1/count')
    check(np.all(y[rp[2]:rp[3], 2] == 0), 'an all -inf head gives 0')
    check(np.allclose(y[rp[1]], 1.0), 'a one-edge segment gives 1')
    backward_cases = [
        softmax_grad_case('pagtn_batch16_layer0', *softmax_in[0]),
        softmax_grad_case('edge_segments', edge_l, edge_rp)]

    sum_cases = [sum_case('pagtn_batch16_aggregation', *agg_in[0]),
                 sum_case('pagtn_batch16_softmax_backward',
                          *backward_in[0])]
    check(tuple(agg_in[0][0].shape) == (6144, 32)
          and tuple(backward_in[0][0].shape) == (6144, 1),
          'P3 shapes on the path: [6144, 32] and [6144, 1]')
    E, F, N = 32768, 512, 8192
    wide_rp = np.searchsorted(np.sort(rng.randint(0, N, E)),
                              np.arange(N + 1)).astype(np.int32)
    sum_cases.append(sum_case(
        'wide_E32768_F512',
        torch.from_numpy(rng.randn(E, F).astype(np.float32)).to(dev),
        torch.from_numpy(wide_rp).to(dev)))
    # a segment of 40 000 edges among 511 short ones, which the kernel
    # splits across a block, at F 32 (float4) and F 1
    lengths = list(rng.randint(0, 8, 511)) + [40000]
    long_rp = torch.from_numpy(np.concatenate([[0], np.cumsum(lengths)])
                               .astype(np.int32)).to(dev)
    for F in (32, 1):
        sum_cases.append(sum_case(
            f'long_segment_40000_F{F}',
            torch.from_numpy(rng.randn(int(long_rp[-1]), F).astype(
                np.float32)).to(dev), long_rp))
    # the segments of the softmax edge case, 5 more edges past row_ptr[N]
    E_edge = int(rp[-1]) + 5
    for F in (37, 3):
        sum_cases.append(sum_case(
            f'edge_segments_F{F}',
            torch.from_numpy(rng.randn(E_edge, F).astype(np.float32)).to(dev),
            edge_rp))
    flat = torch.from_numpy(rng.randn(E_edge * 8 + 1).astype(np.float32))
    sum_cases.append(sum_case('edge_segments_F8_unaligned',
                              flat.to(dev)[1:].view(E_edge, 8), edge_rp))

    gather_cases = [gather_case(f'bench_N{n}_E{e}_F{f}',
                                *bench_graph(rng, n, e, f, dev))
                    for n, e, f in P2_BENCH_SHAPES]
    # tests/test_pallas_ops.py test_empty_segments: edges into 3 and 7 only
    h = torch.ones(16, 8, device=dev)
    src = torch.tensor([0, 1, 2], dtype=torch.int32, device=dev)
    empty_rp = torch.tensor([0, 0, 0, 0, 2, 2, 2, 2] + [3] * 9,
                            dtype=torch.int32, device=dev)
    gather_cases.append(gather_case('empty_segments', h, src, empty_rp))
    out = fused_gather_segment_sum(h, src, empty_rp).cpu().numpy()
    check(np.allclose(out[3], 2.0) and np.allclose(out[7], 1.0)
          and np.all(out[[0, 1, 2, 4, 5, 6] + list(range(8, 16))] == 0),
          'P2 sums two rows into node 3, one into 7, zeros elsewhere')

    # P2's path: its entry point once at each bench shape
    p2_inputs = [bench_graph(rng, n, e, f, dev)
                 for n, e, f in P2_BENCH_SHAPES]
    torch.cuda.synchronize()
    reset_launch_counts()
    with torch.no_grad():
        p2_outs = [fused_gather_segment_sum(*a) for a in p2_inputs]
    torch.cuda.synchronize()
    p2_path = launch_counts()
    print(f'phase 3 p2 path: {len(p2_outs)} calls at the bench shapes, '
          f'launches {p2_path}', flush=True)
    check(p2_path['fused_gather_segment_sum'] == len(P2_BENCH_SHAPES),
          'P2 launched once per bench shape')
    for (h, _, rp_), o in zip(p2_inputs, p2_outs):
        check(tuple(o.shape) == (rp_.shape[0] - 1, h.shape[1])
              and bool(torch.isfinite(o).all()), 'P2 outputs finite')

    # -- 4. serve ---------------------------------------------------------
    model.predict_on_batch(X[1:17])             # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    reset_launch_counts()
    outs, request_ms, n_batches, start = [], [], 0, 0
    for n in REQUESTS:
        t0 = time.perf_counter()
        outs.append(model.predict_on_batch(X[start:start + n]))
        request_ms.append((time.perf_counter() - t0) * 1e3)
        n_batches += -(-n // model.batch_size)
        start += n
    serve = launch_counts()
    print(f'phase 4 serve: requests {list(REQUESTS)} molecules, '
          f'{n_batches} batches, ms per request '
          f'{[round(t, 3) for t in request_ms]}, launches {serve}',
          flush=True)
    for k in ('csr_segment_softmax', 'csr_segment_sum'):
        check(serve[k] == n_layers * n_batches,
              f'{k}: {serve[k]} launches != {n_layers} layers x '
              f'{n_batches} batches')
    cpu_model = PagtnModel(n_tasks=12, mode='classification', device='cpu')
    cpu_model.module.load_state_dict(
        {k: v.cpu() for k, v in model.module.state_dict().items()})
    worst, start = 0.0, 0
    for n, out in zip(REQUESTS, outs):
        check(out.shape == (n, 12, 2), f'output shape {out.shape}')
        check(bool(np.isfinite(out).all()), 'finite outputs')
        check(np.allclose(out.sum(-1), 1.0, atol=1e-5), 'rows sum to 1')
        ref = cpu_model.predict_on_batch(X[start:start + n])
        worst = max(worst, float(np.abs(out - ref).max()))
        start += n
    print(f'phase 4 serve: outputs [n, 12, 2], finite, rows sum to 1; max '
          f'abs diff against the CPU run {worst:.3g}', flush=True)
    check(worst <= CPU_ATOL, f'card vs CPU {worst} > {CPU_ATOL}')

    # -- 5. train ---------------------------------------------------------
    dataset = NumpyDataset(X, labels, weights)
    trainer = PagtnModel(n_tasks=12, mode='classification', device=dev,
                         seed=0, log_frequency=1)
    grads1, losses, marks = {}, [], []
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer.fit(dataset, nb_epoch=4, all_losses=losses,
                callbacks=[step1_grads(grads1),
                           lambda m, step: marks.append(time.perf_counter())])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train = launch_counts()
    steps = trainer.get_global_step()
    step_ms = np.diff([t0] + marks) * 1e3
    print(f'phase 5 train: {steps} steps of {trainer.batch_size} molecules, '
          f'{train_s * 1e3 / steps:.3f} ms a step; host ms per step '
          f'{[round(float(t), 3) for t in step_ms]}; loss per step '
          f'{[round(v, 5) for v in losses]}; launches {train}', flush=True)
    check(steps == 12 and len(losses) == 12, '12 steps, 12 losses')
    check(bool(np.all(np.isfinite(losses))), 'finite losses')
    # a constant added to every logit of a segment leaves its softmax as
    # it is, so attn.bias has an exact gradient of 0: only rounding moves it
    shift = [n for n in grads1 if n.endswith('attn.bias')]
    zero = [n for n, g in grads1.items()
            if n not in shift and not g.abs().max() > 0]
    check(len(grads1) == len(list(trainer.module.parameters())) and not zero,
          f'every parameter gets a non-zero gradient on step 1; zero: {zero}')
    print(f'phase 5 train: step 1 gave {len(grads1)} non-zero gradients; '
          f'attn.bias, 0 by shift invariance, max |grad| '
          f'{max(grads1[n].abs().max().item() for n in shift):.3g}',
          flush=True)
    check(train['csr_segment_softmax'] == n_layers * steps,
          f'P1 launches {train["csr_segment_softmax"]} != {n_layers} a step')
    check(train['csr_segment_sum'] == 2 * n_layers * steps,
          f'P3 launches {train["csr_segment_sum"]} != {2 * n_layers} a step')

    # a dropout-free copy on the card and on the CPU, from the same weights
    copies, copy_losses, copy_grads = [], [], []
    for device in (dev, 'cpu'):
        m = PagtnModel(n_tasks=12, mode='classification', device=device,
                       seed=0, dropout=0.0, log_frequency=1)
        m.module.load_state_dict({k: v.to(device) for k, v in
                                  model.module.state_dict().items()})
        copy_losses.append([])
        copy_grads.append({})
        m.fit(dataset, nb_epoch=4, checkpoint_interval=0,
              all_losses=copy_losses[-1],
              callbacks=step1_grads(copy_grads[-1]))
        copies.append(m)
    grad_err = max((copy_grads[0][n] - g).abs().max().item()
                   for n, g in copy_grads[1].items())
    loss_rel = float(np.max(np.abs(np.subtract(*copy_losses))
                            / np.abs(copy_losses[1])))
    print(f'phase 5 train: dropout 0, card against CPU: step-1 gradients '
          f'max abs diff {grad_err:.3g}, 12-step losses max rel diff '
          f'{loss_rel:.3g}', flush=True)
    check(grad_err <= GRAD_ATOL, f'step-1 gradients {grad_err} > '
          f'{GRAD_ATOL}')
    check(loss_rel <= TRAIN_RTOL, f'loss trajectory {loss_rel} > '
          f'{TRAIN_RTOL}')

    # one fixed batch of 16 at the JAX overfit test's rate
    overfit = PagtnModel(n_tasks=12, mode='classification', device=dev,
                         seed=0, learning_rate=0.003, log_frequency=1)
    fixed = []
    overfit.fit(NumpyDataset(X[:16], labels[:16], weights[:16]),
                nb_epoch=50, checkpoint_interval=0, all_losses=fixed)
    below = next((i + 1 for i, v in enumerate(fixed) if v < 0.9 * fixed[0]),
                 None)
    print(f'phase 5 train: one fixed batch, lr 0.003: loss {fixed[0]:.5f} '
          f'at step 1, {min(fixed):.5f} at best, below 0.9 of the first '
          f'at step {below}', flush=True)
    check(below is not None, 'the loss falls below 0.9 of its first value '
          'within 50 steps')

    # -- 6. P4 flash attention against its plain versions ----------------
    flash_cases = [flash_case(f'encoder_{kind}', FLASH_MAIN, dt, dev)
                   for kind, dt in (('bf16', torch.bfloat16),
                                    ('f32', torch.float32))]
    for dt in (torch.bfloat16, torch.float32):
        flash_cases.append(flash_case(
            f'unaligned_S200_D32_{str(dt)[6:]}', (3, 4, 200, 32), dt, dev))
    crossover = [(CROSSOVER_TOKENS // S, 12, S, 64) for S in CROSSOVER_S]
    for shape in crossover:
        flash_cases.append(flash_case(
            f'crossover_S{shape[2]}', shape, torch.bfloat16, dev,
            iters=200 if shape[2] <= 1024 else 50))
    # P4 in f32 (3xTF32 on the tensor cores) where it meets SDPA's
    for S in F32_CROSSOVER_S:
        flash_cases.append(flash_case(
            f'crossover_S{S}_f32', (CROSSOVER_TOKENS // S, 12, S, 64),
            torch.float32, dev, iters=200 if S <= 1024 else 50))
    # P4's own path: forward and backward once per crossover shape
    gen = torch.Generator(dev).manual_seed(1)
    torch.cuda.synchronize()
    reset_launch_counts()
    for shape in crossover:
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       .to(torch.bfloat16).requires_grad_(i < 3)
                       for i in range(4))
        out = flash_attention(q, k, v, shape[3] ** -0.5)
        out.backward(do)
        check(all(bool(torch.isfinite(t).all()) for t in
                  (out, q.grad, k.grad, v.grad)), 'P4 outputs finite')
    torch.cuda.synchronize()
    p4_path = launch_counts()
    del q, k, v, do, out
    print(f'phase 6 p4 path: forward and backward at {len(crossover)} '
          f'crossover shapes, launches {p4_path}', flush=True)
    for kname in ('flash_attention_fwd', 'flash_attention_dkv',
                  'flash_attention_dq'):
        check(p4_path[kname] == len(crossover),
              f'{kname} launched once per crossover shape')

    # -- 7. encoder serving, einsum route ---------------------------------
    from deepchem_tpu_torch import BertEncoderMLM, SmilesTokenizer
    from deepchem_tpu_torch.models import AdamW, mlm_loss
    tok = SmilesTokenizer.from_corpus(SMILES)
    longest = max(len(tok.tokenize(s)) for s in SMILES) + 2
    check(tok.vocab_size <= ENCODER['vocab_size'] and longest <= SEQ,
          f'{tok.vocab_size} tokens, sequences of up to {longest}')
    ids, mask, mlm_in = mlm_batch(tok, SMILES, seed=0)
    n_enc_layers = ENCODER['layers']
    server = BertEncoderMLM(**ENCODER, device=dev, seed=0).eval()
    with torch.no_grad():
        server(ids[:16].to(dev), mask[:16].to(dev))    # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    served, request_ms, start = [], [], 0
    for n in REQUESTS:
        t0 = time.perf_counter()
        with torch.no_grad():
            served.append(server(ids[start:start + n].to(dev),
                                 mask[start:start + n].to(dev)).cpu())
        request_ms.append((time.perf_counter() - t0) * 1e3)
        start += n
    enc_serve = launch_counts()
    cpu_server = BertEncoderMLM(**ENCODER, device='cpu').eval()
    cpu_server.load_state_dict({k: v.cpu() for k, v in
                                server.state_dict().items()})
    worst, start = 0.0, 0
    for n, out in zip(REQUESTS, served):
        check(tuple(out.shape) == (n, SEQ, ENCODER['vocab_size'])
              and bool(torch.isfinite(out).all()),
              f'finite logits [{n}, {SEQ}, {ENCODER["vocab_size"]}]')
        with torch.no_grad():
            ref = cpu_server(ids[start:start + n], mask[start:start + n])
        worst = max(worst, scaled_err(out, ref))
        start += n
    del cpu_server
    print(f'phase 7 encoder serve: {tok.vocab_size} tokens in the '
          f'vocabulary, requests {list(REQUESTS)} SMILES padded to {SEQ}, '
          f'ms per request {[round(t, 3) for t in request_ms]}, logits '
          f'finite; max abs diff against the CPU run / max(1, |ref|) '
          f'{worst:.3g}; launches {enc_serve}', flush=True)
    check(worst <= CPU_ATOL, f'encoder card vs CPU {worst} > {CPU_ATOL}')
    check(enc_serve['flash_attention_fwd'] == 0,
          'the default (einsum) route launches no P4 kernel')

    # -- 8. the encoder through P4 ---------------------------------------
    req = slice(REQUESTS[0] + REQUESTS[1], sum(REQUESTS))  # the 31 request
    with torch.no_grad():
        einsum_logits = server(ids[req].to(dev))
        torch.cuda.synchronize()
        reset_launch_counts()
        with flash_routed():
            flash_logits = server(ids[req].to(dev))
        torch.cuda.synchronize()
        serve_flash = launch_counts()
    del server
    serve_err = scaled_err(flash_logits, einsum_logits)
    print(f'phase 8 serve_flash: a request of {req.stop - req.start} SMILES, '
          f'no mask, float32: flash against einsum {serve_err:.3g}; '
          f'launches {serve_flash}', flush=True)
    check(serve_err <= ROUTE_TOL['float32'],
          f'flash route vs einsum {serve_err} > {ROUTE_TOL["float32"]}')
    check(serve_flash['flash_attention_fwd'] == n_enc_layers
          and serve_flash['flash_attention_dkv'] == 0,
          f'{n_enc_layers} P4 forward launches and no backward')

    b16 = slice(0, ENCODER_BATCH)
    batch = [t[b16].to(dev) for t in (mlm_in, ids, mask)]
    for kind, dt in (('float32', torch.float32),
                     ('bfloat16', torch.bfloat16)):
        model = BertEncoderMLM(**ENCODER, dtype=dt, device=dev,
                               seed=1).train()
        logits_e, loss_e, grads_e = encoder_step(model, *batch)
        with flash_routed():
            logits_f, loss_f, grads_f = encoder_step(model, *batch)
        logit_err = scaled_err(logits_f, logits_e)
        grad_err = max(scaled_err(grads_f[n], g) for n, g in grads_e.items())
        print(f'phase 8 step: {kind}, flash against einsum: logits '
              f'{logit_err:.3g}, step-1 gradients {grad_err:.3g} (of '
              f'max(1, |g|)); loss {loss_f.item():.5f} against '
              f'{loss_e.item():.5f}', flush=True)
        check(logit_err <= ROUTE_TOL[kind] and grad_err <= ROUTE_TOL[kind],
              f'{kind} flash route vs einsum: {logit_err}, {grad_err}')
        del model, grads_e, grads_f

    # 10 AdamW steps at batch 16 through P4, in bfloat16 and in float32
    batches = [[t[i:i + ENCODER_BATCH].to(dev) for t in (mlm_in, ids, mask)]
               for i in range(0, len(SMILES), ENCODER_BATCH)]
    train_paths = {}
    for kind, dt in (('bfloat16', torch.bfloat16),
                     ('float32', torch.float32)):
        trainer = BertEncoderMLM(**ENCODER, dtype=dt, device=dev,
                                 seed=2).train()
        opt = AdamW(learning_rate=ENCODER_LR)._create_torch_optimizer(
            trainer.parameters())
        enc_losses, per_step = [], []
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with flash_routed():
            for i in range(10):
                inputs, labels, label_mask = batches[i % len(batches)]
                opt.zero_grad(set_to_none=True)
                loss = mlm_loss(trainer(inputs), labels, label_mask)
                loss.backward()
                opt.step()
                enc_losses.append(loss.detach())
                per_step.append(launch_counts())
        torch.cuda.synchronize()
        enc_step_ms = (time.perf_counter() - t0) * 1e3 / 10
        train_paths[kind] = launch_counts()
        enc_losses = [v.item() for v in enc_losses]
        print(f'phase 8 train_flash: 10 AdamW steps of {ENCODER_BATCH} at '
              f'lr {ENCODER_LR}, {kind}, {enc_step_ms:.3f} ms a step; loss '
              f'per step {[round(v, 5) for v in enc_losses]}; launches '
              f'{train_paths[kind]}', flush=True)
        check(all(np.isfinite(enc_losses)), f'{kind}: finite losses')
        for i, counts in enumerate(per_step):
            for kname in ('flash_attention_fwd', 'flash_attention_dkv',
                          'flash_attention_dq'):
                check(counts[kname] == n_enc_layers * (i + 1),
                      f'{kind} {kname}: {n_enc_layers} launches a step')
        del trainer, opt
    train_flash, train_flash_f32 = (train_paths['bfloat16'],
                                    train_paths['float32'])

    overfit = BertEncoderMLM(**ENCODER, dtype=torch.bfloat16, device=dev,
                             seed=3).train()
    opt = AdamW(learning_rate=ENCODER_LR)._create_torch_optimizer(
        overfit.parameters())
    fixed, below = [], None
    with flash_routed():
        for step in range(1, 51):
            opt.zero_grad(set_to_none=True)
            loss = mlm_loss(overfit(batches[0][0]), *batches[0][1:])
            loss.backward()
            opt.step()
            fixed.append(loss.item())
            if fixed[-1] < 0.9 * fixed[0]:
                below = step
                break
    del overfit, opt
    print(f'phase 8 overfit: one fixed batch, lr {ENCODER_LR}: loss '
          f'{fixed[0]:.5f} at step 1, {fixed[-1]:.5f} at step '
          f'{len(fixed)}, below 0.9 of the first at step {below}',
          flush=True)
    check(below is not None, 'the loss falls below 0.9 of its first value '
          'within 50 steps')

    # -- 9. encoder gradients, card against CPU (einsum route, f32) -------
    small = [t[:4] for t in (mlm_in, ids, mask)]
    models = [BertEncoderMLM(**ENCODER, device=d, seed=4).train()
              for d in (dev, 'cpu')]
    steps = [encoder_step(m, *[t.to(m.head_bias.device) for t in small],
                          mask=small[2].to(m.head_bias.device))
             for m in models]
    grad_err = max(scaled_err(steps[0][2][n].cpu(), g)
                   for n, g in steps[1][2].items())
    zero = [n for n, g in steps[0][2].items() if not g.abs().max() > 0]
    print(f'phase 9 encoder gradients: batch 4 with a mask, float32, card '
          f'against CPU: loss {steps[0][1].item():.6f} against '
          f'{steps[1][1].item():.6f}, step-1 gradients max abs diff / '
          f'max(1, |g|) {grad_err:.3g} over {len(steps[1][2])} parameters',
          flush=True)
    check(not zero, f'every parameter gets a gradient; zero: {zero}')
    check(grad_err <= CPU_ATOL, f'encoder gradients {grad_err} > '
          f'{CPU_ATOL}')
    del models, steps

    # -- 10. kernels line -------------------------------------------------
    def entry(kname, cases, main_case, path_launches, source=None, **extra):
        return {'name': kname, 'route': 'cuda',
                'source': source or f'deepchem_tpu_torch/csrc/{kname}.cu',
                'launches': sum(path_launches.values()),
                'launches_by_path': path_launches,
                'max_abs_err': max(c['max_abs_err'] for c in cases),
                'ms': main_case['ms'], 'device_us': main_case['device_us'],
                'plain_ms': main_case['plain_ms'],
                'bound_ms': main_case['bound_ms'],
                'bound_by': main_case['bound_by'],
                'library_ms': main_case['library_ms'],
                **{k: main_case[k] for k in ('library_device_us',
                                             'backward_device_us')
                   if k in main_case}, **extra}
    p1 = entry('csr_segment_softmax', softmax_cases, softmax_cases[0],
               {'serve': serve['csr_segment_softmax'],
                'train': train['csr_segment_softmax']},
               replaces='deepchem_tpu/ops/pallas_segment.py:156',
               backward={'route': 'torch.autograd.Function: dx = y * (dy - '
                                  't[seg]), t from csr_segment_sum (cuda)',
                         'max_abs_err': max(c['max_abs_err']
                                            for c in backward_cases)})
    p3 = entry('csr_segment_sum', sum_cases, sum_cases[0],
               {'serve': serve['csr_segment_sum'],
                'train': train['csr_segment_sum']},
               replaces='deepchem_tpu/ops/pallas_segment.py:45')
    # P2 has no model path: its row is its widest bench shape
    p2 = entry('fused_gather_segment_sum', gather_cases,
               gather_cases[len(P2_BENCH_SHAPES) - 1],
               {'p2_bench_shapes': p2_path['fused_gather_segment_sum']},
               replaces='deepchem_tpu/ops/pallas_segment.py:94')
    # P4: the stock kernels, reached through bert_encoder.py:62; main case
    # the encoder's attention in bfloat16
    stock = {'fwd': 758, 'dkv': 1121, 'dq': 1456}
    f32_main = flash_cases[1]            # the encoder's attention in float32
    p4 = tuple(entry(
        f'flash_attention_{part}',
        [c[part] for c in flash_cases if part in c],
        flash_cases[0][part],
        {path: counts[f'flash_attention_{part}'] for path, counts in
         (('serve_flash', serve_flash), ('train_flash', train_flash),
          ('train_flash_f32', train_flash_f32), ('crossover', p4_path))},
        source='deepchem_tpu_torch/csrc/flash_attention.cu',
        replaces=f'jax/experimental/pallas/ops/tpu/flash_attention.py:'
                 f'{line} via deepchem_tpu/models/bert_encoder.py:62',
        float32={**{k: f32_main[part][k] for k in (
            'device_us', 'bound_ms', 'bound_by', 'library_device_us',
            'max_abs_err', 'err_f64')}, 'launches_by_path': {
                path: counts[f'flash_attention_{part}'] for path, counts in
                (('serve_flash', serve_flash),
                 ('train_flash_f32', train_flash_f32))}})
        for part, line in stock.items())
    print(json.dumps({'kernels': [
        {k: e[k] for k in ('name', 'route', 'source', 'replaces', 'launches',
                           'max_abs_err', 'ms', 'plain_ms', 'bound_ms',
                           'bound_by', 'library_ms')}
        | {k: v for k, v in e.items() if k in (
            'device_us', 'launches_by_path', 'backward', 'library_device_us',
            'backward_device_us', 'float32')}
        for e in (p1, p3, p2) + p4]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
