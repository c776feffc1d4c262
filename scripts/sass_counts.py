#!/usr/bin/env python3
"""Count the tensor-core, TMA and barrier instructions of each kernel in a
built library of the port, from its SASS.

    python3 scripts/sass_counts.py [name ...]    # default: flash_attention

Builds ``deepchem_tpu_torch/csrc/<name>.cu`` where needed
(``deepchem_tpu_torch/kernels/build.py``), disassembles the library with
``cuobjdump -sass`` (the CUDA toolkit's, or the copy in triton's package)
and prints one JSON line a kernel: its demangled name and how many
``HGMMA`` (wgmma), ``HMMA`` (mma.sync; ``HMMA_TF32`` those of them that
take tf32 operands), ``UTMALDG`` (TMA load), ``SYNCS`` (mbarrier) and
``FFMA`` (f32 fused multiply-add on the FMA units) instructions it holds.
Needs the toolkit, not a card.
"""

import json
import os
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

OPCODES = ('HGMMA', 'HMMA', 'HMMA_TF32', 'UTMALDG', 'SYNCS', 'FFMA')
_OPCODE = re.compile(r'\b(HGMMA|HMMA|UTMALDG|SYNCS|FFMA)\b')
_TF32 = re.compile(r'\bHMMA\.\w+\.F32\.TF32\b')


def _tool(name: str) -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = [os.path.join(CUDA_HOME, 'bin', name)] if CUDA_HOME else []
    candidates.append(shutil.which(name) or '')
    try:
        import triton
        candidates.append(os.path.join(os.path.dirname(triton.__file__),
                                       'backends', 'nvidia', 'bin', name))
    except ImportError:
        pass
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(f'{name} not found in the CUDA toolkit or triton')


def _demangle(names):
    cxxfilt = shutil.which('c++filt')
    if not cxxfilt:
        return list(names)
    out = subprocess.run([cxxfilt], input='\n'.join(names),
                         capture_output=True, text=True, check=True).stdout
    return out.splitlines()


def counts(name: str):
    """{demangled kernel: Counter of OPCODES} for csrc/<name>.cu."""
    from deepchem_tpu_torch.kernels import build
    build.build_all([name])
    sass = subprocess.run([_tool('cuobjdump'), '-sass',
                           str(build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    per, current = {}, None
    for line in sass.splitlines():
        head = re.search(r'Function : (\S+)', line)
        if head:
            current = head.group(1)
            per[current] = Counter()
        elif current:
            per[current].update(_OPCODE.findall(line))
            per[current]['HMMA_TF32'] += len(_TF32.findall(line))
    return dict(zip(_demangle(per), per.values()))


def main(argv) -> int:
    for name in argv or ['flash_attention']:
        for kernel, c in counts(name).items():
            print(json.dumps({'source': name, 'kernel': kernel,
                              **{op: c[op] for op in OPCODES}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
