#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, one line each:
  1. device  -- the card's name and power limit; TF32 off for matmuls and
                convolutions, so the card computes in full float32.
  2. build   -- compiles every kernel under deepchem_tpu_torch/csrc/ and
                prints ptxas's report.
  3. kernel  -- each kernel against its plain PyTorch version on the card,
                on the inputs the main path hands it, a wide case and edge
                cases: max abs error, kernel, plain and library times,
                bytes bound.
  4. main    -- PagtnModel(n_tasks=12, mode='classification') at its
                default widths, seeded random weights, answers requests of
                1, 16 and 31 molecules with predict_on_batch; the outputs
                are checked and held against the same model on the CPU, and
                the kernel launch counts are read.
  5. kernels -- one JSON line with each kernel's numbers.
The last line is the JSON device record.  Any failed check exits non-zero.
"""

import json
import subprocess
import sys
import time
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
KERNEL_ATOL = 1e-6              # same f32 inputs, another summation order
CPU_ATOL = 1e-4                 # whole model, f32, another summation order
HBM_BYTES_PER_S = 3.35e12       # H100 SXM published peaks
F32_OPS_PER_S = 67e12


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


def softmax_case(name, logits, row_ptr):
    """Kernel and library call against the plain version on the card, with
    times and bound."""
    import torch
    from deepchem_tpu_torch.ops.csr_segment import (
        csr_segment_softmax, csr_segment_softmax_reference)
    y = csr_segment_softmax(logits, row_ptr)
    torch.cuda.synchronize()
    y_ref = csr_segment_softmax_reference(logits, row_ptr)
    err = (y - y_ref).abs().max().item() if y.numel() else 0.0
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
    nbytes = 2 * E * H * 4 + (N + 1) * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 8 * E * H / F32_OPS_PER_S * 1e3
    res = {'case': name, 'E': E, 'H': H, 'N': N, 'max_abs_err': err,
           'ms': time_ms(lambda: csr_segment_softmax(logits, row_ptr)),
           'plain_ms': time_ms(
               lambda: csr_segment_softmax_reference(logits, row_ptr)),
           'library_err': lib_err,
           'library_ms': time_ms(lambda: library_softmax(logits, row_ptr)),
           'bound_ms': max(bytes_ms, ops_ms),
           'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations'}
    print(f'phase 3 kernel {json.dumps(res)}', flush=True)
    check(err <= KERNEL_ATOL, f'{name}: kernel error {err} > {KERNEL_ATOL}')
    check(lib_err <= KERNEL_ATOL,
          f'{name}: library error {lib_err} > {KERNEL_ATOL}')
    return res


def main_path_softmax_inputs(model, molecules):
    """The ``(logits, row_ptr)`` that PAGTN's first layer hands the kernel
    in one ``predict_on_batch`` of ``molecules``, recorded where
    ``segment_softmax_sorted`` calls the kernel's wrapper."""
    from deepchem_tpu_torch.ops import segment
    kernel, seen = segment.csr_segment_softmax, []

    def record(logits, row_ptr):
        seen.append((logits.clone(), row_ptr.clone()))
        return kernel(logits, row_ptr)

    segment.csr_segment_softmax = record
    try:
        model.predict_on_batch(molecules)
    finally:
        segment.csr_segment_softmax = kernel
    check(len(seen) == len(model.module.layers),
          f'{len(seen)} softmax calls for {len(model.module.layers)} layers')
    return seen[0]


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
    for kname in build.kernel_names():
        build.load(kname)
    print(f'phase 2 build: {len(build.kernel_names())} kernel(s) in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    for kname in build.kernel_names():
        ptxas = [ln.strip() for ln in build.build_log(kname).splitlines()
                 if 'registers' in ln or 'spill' in ln]
        print(f'phase 2 build {kname}: {" | ".join(ptxas)}', flush=True)

    # -- featurize the main path's molecules (host work) -------------------
    from deepchem_tpu_torch import PagtnModel, PagtnMolGraphFeaturizer
    from deepchem_tpu_torch.ops import NEG, csr_segment_softmax
    t0 = time.perf_counter()
    X = PagtnMolGraphFeaturizer().featurize(SMILES)
    sizes = [g.num_nodes for g in X if hasattr(g, 'num_nodes')]
    check(len(sizes) == len(SMILES), 'every molecule featurizes')
    check(min(sizes) >= 5 and max(sizes) <= 40, 'molecules of 5-40 atoms')
    print(f'featurized {len(X)} molecules of {min(sizes)}-{max(sizes)} '
          f'heavy atoms in {time.perf_counter() - t0:.2f} s', flush=True)
    model = PagtnModel(n_tasks=12, mode='classification', device=dev,
                       seed=0)

    # -- 3. kernel against its plain version ------------------------------
    cases = [softmax_case('pagtn_batch16_layer0',
                          *main_path_softmax_inputs(model, X[1:17]))]
    rng = np.random.RandomState(0)
    E, H, N = 16384, 8, 2048
    dst = np.sort(rng.randint(0, N, E))
    row_ptr = np.searchsorted(dst, np.arange(N + 1)).astype(np.int32)
    cases.append(softmax_case(
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
    edge = softmax_case('edge_segments',
                        torch.from_numpy(edge_logits).to(dev),
                        torch.from_numpy(rp).to(dev))
    cases.append(edge)
    y = csr_segment_softmax(torch.from_numpy(edge_logits).to(dev),
                            torch.from_numpy(rp).to(dev)).cpu().numpy()
    check(np.allclose(y[rp[4]:rp[5]], 1 / 7, atol=KERNEL_ATOL),
          'an all-NEG segment gives 1/count')
    check(np.all(y[rp[2]:rp[3], 2] == 0), 'an all -inf head gives 0')
    check(np.allclose(y[rp[1]], 1.0), 'a one-edge segment gives 1')

    # -- 4. main path -----------------------------------------------------
    model.predict_on_batch(X[1:17])             # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    csr_segment_softmax.launches = 0
    outs, request_ms, n_batches, start = [], [], 0, 0
    for n in REQUESTS:
        t0 = time.perf_counter()
        outs.append(model.predict_on_batch(X[start:start + n]))
        request_ms.append((time.perf_counter() - t0) * 1e3)
        n_batches += -(-n // model.batch_size)
        start += n
    launches = csr_segment_softmax.launches
    n_layers = len(model.module.layers)
    print(f'phase 4 main: requests {list(REQUESTS)} molecules, '
          f'{n_batches} batches, ms per request '
          f'{[round(t, 3) for t in request_ms]}, csr_segment_softmax '
          f'launches {launches}', flush=True)
    check(launches == n_layers * n_batches,
          f'{launches} launches != {n_layers} layers x {n_batches} batches')
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
    print(f'phase 4 main: outputs [n, 12, 2], finite, rows sum to 1; max '
          f'abs diff against the CPU run {worst:.3g}', flush=True)
    check(worst <= CPU_ATOL, f'card vs CPU {worst} > {CPU_ATOL}')

    # -- 5. kernels line --------------------------------------------------
    main_case = cases[0]
    print(json.dumps({'kernels': [{
        'name': 'csr_segment_softmax', 'route': 'cuda',
        'source': 'deepchem_tpu_torch/csrc/csr_segment_softmax.cu',
        'replaces': 'deepchem_tpu/ops/pallas_segment.py:156',
        'launches': launches,
        'max_abs_err': max(c['max_abs_err'] for c in cases),
        'ms': main_case['ms'], 'plain_ms': main_case['plain_ms'],
        'bound_ms': main_case['bound_ms'],
        'bound_by': main_case['bound_by'],
        'library_ms': main_case['library_ms']}]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
