"""Build the package's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled on
its own by ``nvcc`` into ``build/kernels/<name>-<hash>.so`` beside the
package, where ``<hash>`` covers the source and the flags, so an edited
source is rebuilt and an unchanged one is reused.  The library is loaded
with ``ctypes``; the wrapper of each kernel declares its entry's
``argtypes``.  Beside each library, ``<name>-<hash>.log`` keeps nvcc's
output, with ptxas's register and spill report.  Nothing is compiled when
this module is imported.

    python -m deepchem_tpu_torch.kernels.build     # build every kernel

:func:`build_all` starts one ``nvcc`` for each source at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / 'csrc'
BUILD_DIR = PACKAGE_DIR.parent / 'build' / 'kernels'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v']

_loaded: Dict[str, ctypes.CDLL] = {}


def kernel_names() -> List[str]:
    return sorted(p.stem for p in CSRC_DIR.glob('*.cu'))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = [os.path.join(CUDA_HOME, 'bin', 'nvcc')] if CUDA_HOME \
        else []
    candidates.append(shutil.which('nvcc') or '')
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError('nvcc not found: the CUDA toolkit is needed to '
                       'build the kernels')


def library_path(name: str) -> Path:
    src = CSRC_DIR / f'{name}.cu'
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob('*.cuh')):
        h.update(header.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'{name}-{h.hexdigest()[:16]}.so'


def _start(name: str, out: Path) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp),
           str(CSRC_DIR / f'{name}.cu')]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, out: Path, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'nvcc failed for {name} '
                           f'(exit {proc.returncode}):\n{log}')
    out.with_suffix('.log').write_text(log)
    os.replace(tmp, out)       # atomic: a reader never sees half a file


def build_all(names: Optional[List[str]] = None) -> None:
    """Compile every missing library of ``names`` (default: all), one
    ``nvcc`` per source, all started together."""
    todo = [(n, library_path(n)) for n in (names or kernel_names())]
    procs = [(n, out, _start(n, out)) for n, out in todo
             if not out.exists()]
    for n, out, proc in procs:
        _finish(n, out, proc)


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, compiled on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


@functools.lru_cache(maxsize=None)
def c_entry(source: str, symbol: str, n_ptrs: int, n_ints: int,
            n_floats: int = 0):
    """The C function ``symbol`` of ``csrc/<source>.cu``, built at first
    use: ``n_ptrs`` pointers, ``n_ints`` ints, ``n_floats`` floats, then
    the stream, all declared (``c_void_p``, ``c_int``, ``c_float``) so that
    ctypes cuts no pointer; it returns the launch's ``cudaError_t`` as an
    int."""
    fn = getattr(load(source), symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch(source: str, symbol: str, tensors, ints, floats=()) -> None:
    """Launch the C entry ``symbol`` of ``csrc/<source>.cu`` on the current
    stream of the first tensor's device: the tensors' pointers (None for
    a null one), then ``ints``, then ``floats``; raise on the launch's
    error code.  Every kernel wrapper of the package launches through
    here."""
    import torch
    dev = tensors[0].device
    fn = c_entry(source, symbol, len(tensors), len(ints), len(floats))
    with torch.cuda.device(dev):
        err = fn(*(None if t is None else t.data_ptr() for t in tensors),
                 *ints, *floats, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'{symbol} launch failed: cudaError {err}')


def build_log(name: str) -> str:
    """nvcc's output from building ``csrc/<name>.cu``."""
    return library_path(name).with_suffix('.log').read_text()


if __name__ == '__main__':
    build_all()
    for kname in kernel_names():
        print(f'{kname}:\n{build_log(kname)}')
