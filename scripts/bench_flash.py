#!/usr/bin/env python3
"""Device and host time of P4's kernels, forward, dK/dV and dQ: the source
as it is and, optionally, another version of it (a parent commit's) in
turns on one card.

    python3 scripts/bench_flash.py [--parent FILE] [--calls 20]
                                   [--dtype bfloat16|float32]

Each version of ``deepchem_tpu_torch/csrc/flash_attention.cu`` is compiled
by nvcc with the package's flags into ``build/bench_flash/<name>.so``
(all at once; ptxas's registers and spill stores of each kernel are
printed) and called through the same C entries as the package:
``base`` is the source as it is, ``parent`` the file given to
``--parent``.  The runs go parent, base, base, parent (base, base with
no parent), and the two runs of each are averaged.

Per run and shape it prints one JSON line with, for each kernel, the
profiler's device µs a launch (``chip_smoke.device_us``; null where no
profile passed its checks), the µs a call between CUDA events around 200
back-to-back calls (``chip_smoke.time_ms``: the card's time where the
kernel outlasts the host's call, else the host's), and the host µs a call
of the C entry: the mean of 200 back-to-back calls on the host clock,
with no synchronise between them (what a caller's thread spends to
encode and launch).  It also prints the card's name and power limit,
each version's ptxas registers and any wgmma serialisation ptxas reports
(info C7512), and a last JSON line with each version's means per shape.
``--dtype float32`` adds the device µs of SDPA's float32 forward and of
its backward (``chip_smoke.library_attention``; every kernel of one call)
in each run, and holds each version's outputs to the package's: within
2e-5 of max(1, |plain|) for the forward and 2e-4 for the gradients,
twice ``chip_smoke.py``'s limits against the plain version.
Shapes: the encoder's attention ``[32, 12, 128, 64]``,
``scripts/attn_crossover.py``'s (H 12, D 64, 65 536 tokens, S 128 to
4096) and ``[3, 4, 200, 32]``.  From S 2048 each timing takes 50 calls
instead of 200.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
CSRC = REPO / 'deepchem_tpu_torch' / 'csrc'
SOURCE = CSRC / 'flash_attention.cu'
OUT = REPO / 'build' / 'bench_flash'
SHAPES = [(32, 12, 128, 64)] + [(65536 // s, 12, s, 64) for s in
                                (128, 256, 512, 1024, 2048, 4096)] \
    + [(3, 4, 200, 32)]
HOST_CALLS = 200


FLASH_KERNELS = r'flash_\w+_kernelILi\d+(?:ELi\d+)*'


def nvcc(sources: dict, out: Path = OUT, kernel: str = FLASH_KERNELS) -> dict:
    """Compile {name: .cu path} into <out>/<name>.so with the package's
    flags, all at once; {name: ptxas summary of the kernels whose mangled
    names match ``kernel``}."""
    from deepchem_tpu_torch.kernels import build as kbuild
    out.mkdir(parents=True, exist_ok=True)
    procs = {n: subprocess.Popen(
        [kbuild._nvcc(), *kbuild.NVCC_FLAGS, '-I', str(CSRC),
         '-o', str(out / f'{n}.so'), str(cu)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for n, cu in sources.items()}
    report = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f'nvcc failed for {n}:\n{log[-4000:]}')
        regs = re.findall(rf"({kernel})\S*' for "
                          r"'sm_90a'\n.*\n.* (\d+) bytes spill stores.*\n"
                          r".*Used (\d+) registers", log)
        report[n] = {
            'registers': {k: int(r) for k, _, r in regs},
            'spill_stores': {k: int(b) for k, b, _ in regs if int(b)},
            'serialised': sorted(set(re.findall(
                rf'C7512\) .*?({kernel})', log)))}
    return report


def host_us(fn, calls: int) -> float:
    """Host µs a call over ``calls`` back-to-back calls of ``fn``, after a
    warm-up and a synchronise; the launches are not waited for."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    stop = time.perf_counter()
    torch.cuda.synchronize()
    return (stop - start) / calls * 1e6


def profiled_us(device_us, fn, kernel: str, calls: int):
    """``device_us``'s reading, or None where no profile passed its checks
    (the profiler has read kernels short; ``event_us`` stands beside it)."""
    try:
        return device_us(fn, kernel, calls=calls)
    except RuntimeError as err:
        print(f'{kernel}: {err}', file=sys.stderr, flush=True)
        return None


def _entries(lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd, dkv, dq = (lib.flash_attention_fwd, lib.flash_attention_dkv,
                    lib.flash_attention_dq)
    fwd.argtypes = [P] * 6 + [I] * 4 + [F, P]
    dkv.argtypes = [P] * 9 + [I] * 4 + [F, P]
    dq.argtypes = [P] * 8 + [I] * 4 + [F, P]
    fwd.restype = dkv.restype = dq.restype = ctypes.c_int
    return fwd, dkv, dq


def time_version(name: str, calls: int, dtype: str) -> dict:
    """{shape: {part: {metric: µs}}} for the library of ``name``."""
    import torch
    from chip_smoke import device_us, device_us_all, library_attention, \
        time_ms
    from deepchem_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_forward)
    lib = ctypes.CDLL(str(OUT / f'{name}.so'))
    fwd, dkv, dq = _entries(lib)
    dev = torch.device('cuda', 0)
    bf16 = int(dtype == 'bfloat16')
    out = {}
    for shape in SHAPES:
        gen = torch.Generator(dev).manual_seed(0)
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       .to(getattr(torch, dtype)) for _ in range(4))
        B, H, S, D = shape
        scale = D ** -0.5
        o, m, l = flash_attention_forward(q, k, v, scale)
        di = (o.float() * do.float()).sum(-1)
        o2, dk, dv, dqo = (torch.empty_like(t) for t in (q, k, v, q))
        m2, l2 = torch.empty_like(m), torch.empty_like(l)
        stream = torch.cuda.current_stream().cuda_stream
        qkv = [t.data_ptr() for t in (q, k, v)]
        fout = [t.data_ptr() for t in (o2, m2, l2)]
        ptrs = [t.data_ptr() for t in (q, k, v, do, m, l, di)]
        runs = {
            'fwd': lambda: fwd(*qkv, *fout, B * H, S, D, bf16, scale,
                               stream),
            'dkv': lambda: dkv(*ptrs, dk.data_ptr(), dv.data_ptr(), B * H, S,
                               D, bf16, scale, stream),
            'dq': lambda: dq(*ptrs, dqo.data_ptr(), B * H, S, D, bf16, scale,
                             stream)}
        for part, fn in runs.items():
            if fn():
                raise RuntimeError(f'{name} {part}: a launch failed at '
                                   f'{shape}')
        torch.cuda.synchronize()
        if not bf16:  # the version's outputs against the package's: each
            # within 1e-5 (forward) and 1e-4 (gradients) of max(1, |plain|)
            # in chip_smoke.py, so within twice that of each other
            pk, pv = flash_attention_bwd_dkv(q, k, v, do, m, l, di, scale)
            pq = flash_attention_bwd_dq(q, k, v, do, m, l, di, scale)
            for limit, pairs in ((2e-5, ((o2, o), (m2, m), (l2, l))),
                                 (2e-4, ((dk, pk), (dv, pv), (dqo, pq)))):
                err = max((a - b).abs().max().item()
                          / max(1.0, b.abs().max().item())
                          for a, b in pairs)
                if err > limit:
                    raise RuntimeError(f'{name}: output differs by {err} at '
                                       f'{shape}')
            del pk, pv, pq
        iters = HOST_CALLS if S < 2048 else 50
        res = out['x'.join(map(str, shape))] = {
            part: {'device_us': profiled_us(device_us, fn, f'flash_{part}_',
                                            calls),
                   'event_us': time_ms(fn, iters) * 1e3,
                   'host_us': host_us(fn, iters)}
            for part, fn in runs.items()}
        if not bf16:
            lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
            lib_o = library_attention(lq, lk, lv, scale)
            res['sdpa_fwd'] = {'device_us': device_us_all(
                lambda: library_attention(q, k, v, scale), calls)[0]}
            res['sdpa_bwd'] = {'device_us': device_us_all(
                lambda: torch.autograd.grad(lib_o, (lq, lk, lv), do,
                                            retain_graph=True), calls)[0]}
            del lq, lk, lv, lib_o
        del q, k, v, do, o, m, l, di, o2, m2, l2, dk, dv, dqo
    return out


def mean(values):
    """The mean of the readings that exist, or None."""
    values = [v for v in values if v is not None]
    return sum(values) / len(values) if values else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--parent', type=Path)
    ap.add_argument('--calls', type=int, default=20)
    ap.add_argument('--dtype', choices=('bfloat16', 'float32'),
                    default='bfloat16')
    args = ap.parse_args()
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {'base': SOURCE}
    if args.parent:
        sources['parent'] = OUT / 'parent.cu'
        sources['parent'].write_text(args.parent.read_text())
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for n, rep in nvcc(sources).items():
        print(json.dumps({'version': n, **rep}), flush=True)
    order = ['base', 'base']
    if args.parent:
        order = ['parent'] + order + ['parent']
    runs = {n: [] for n in sources}
    for n in order:
        runs[n].append(time_version(n, args.calls, args.dtype))
        print(json.dumps({'version': n, 'run': len(runs[n]),
                          'us': runs[n][-1]}), flush=True)
    print(json.dumps({'mean_us': {
        n: {shape: {part: {x: mean([r[shape][part][x] for r in rs])
                           for x in rs[0][shape][part]}
                    for part in rs[0][shape]}
            for shape in rs[0]}
        for n, rs in runs.items()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
