"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/lib<name>-<hash>.so`` inside the package (the directory is ignored
by git), where the hash covers the source and the flags: an unchanged
kernel is built once per checkout. All sources compile concurrently, one
nvcc process each. Nothing is built when a module is imported; the first
launch of a kernel, or :func:`build`, does it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE_DIR = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, 'build')

# sm_90a: the Hopper target that also admits wgmma/setmaxnreg
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> list:
    """Names of all kernels in ``csrc/``."""
    return sorted(f[:-3] for f in os.listdir(SOURCE_DIR) if f.endswith('.cu'))


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, 'bin', 'nvcc') if CUDA_HOME else None
    path = cand if cand and os.path.exists(cand) else shutil.which('nvcc')
    if not path:
        raise RuntimeError('nvcc was not found: the CUDA toolkit is needed to '
                           'build the kernels')
    return path


def _target(name: str) -> str:
    with open(os.path.join(SOURCE_DIR, name + '.cu'), 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f'lib{name}-{digest.hexdigest()[:16]}.so')


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernels (default: all) that are not built yet, all
    at once; returns {name: library path}. Raises with nvcc's output when a
    build fails."""
    names = sources() if names is None else list(names)
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not os.path.exists(t)}
    if not todo:
        return targets
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n, t in todo.items():
        tmp = f'{t}.{os.getpid()}.tmp'
        cmd = [nvcc, *NVCC_FLAGS, '-o', tmp, os.path.join(SOURCE_DIR, n + '.cu')]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'{n}.cu (exit {proc.returncode}):\n'
                          f'{out.decode(errors="replace")}')
            continue
        os.replace(tmp, todo[n])  # atomic: a concurrent build never sees a partial file
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            _libs[name] = lib
        return lib
