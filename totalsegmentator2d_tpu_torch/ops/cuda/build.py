"""Build the package's native code and load it with ctypes.

Each ``csrc/<name>.cu`` is a CUDA kernel with a plain C interface; it
compiles on its own with nvcc into ``build/lib<name>-<hash>.so`` inside the
package (the directory is ignored by git), where the hash covers the source
and the flags: an unchanged kernel is built once per checkout. All kernel
sources compile concurrently, one nvcc process each. Each ``csrc/<name>.cc``
is a host library (the IO codecs and the host projection, io/native.py),
built the same way with the host C++ compiler (``$CXX`` or g++) and linked
with zlib, on any machine, card or not. Nothing is built when a module is
imported; the first use of a library, :func:`build` or :func:`build_host`,
does it.
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

# the host libraries: -ffp-contract=off keeps every float operation rounded
# on its own, as numpy and the device code round them; -pthread for the
# host passes' threads (the projection, the Result's masks)
CXX_FLAGS = ('-O3', '-fPIC', '-std=c++17', '-shared', '-ffp-contract=off',
             '-pthread')
CXX_LIBS = ('-lz',)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_host_libs: Dict[tuple, ctypes.CDLL] = {}


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


def _target(name: str, ext: str = '.cu', flags=NVCC_FLAGS) -> str:
    with open(os.path.join(SOURCE_DIR, name + ext), 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(flags).encode())
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


def cxx_path() -> str:
    cxx = os.environ.get('CXX') or 'g++'
    path = shutil.which(cxx)
    if not path:
        raise RuntimeError(f'the host C++ compiler {cxx!r} was not found: it '
                           f'is needed to build the host libraries')
    return path


def build_host(name: str, defines: Iterable[str] = ()) -> str:
    """Compile the host library ``csrc/<name>.cc`` (with ``-D`` for each
    of ``defines``) unless it is built; returns its path. Raises with the
    compiler's output when the build fails."""
    flags = CXX_FLAGS + tuple(f'-D{d}' for d in defines)
    target = _target(name, '.cc', flags + CXX_LIBS)
    if os.path.exists(target):
        return target
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{target}.{os.getpid()}.{threading.get_ident()}.tmp'
    cmd = [cxx_path(), *flags, '-o', tmp, os.path.join(SOURCE_DIR, name + '.cc'),
           *CXX_LIBS]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if proc.returncode != 0:
        raise RuntimeError(f'{name}.cc (exit {proc.returncode}):\n'
                           f'{proc.stdout.decode(errors="replace")}')
    os.replace(tmp, target)  # atomic, as for the kernels
    return target


def host_library(name: str, defines: Iterable[str] = ()) -> ctypes.CDLL:
    """The loaded host library, built on first use. ``ctypes.CDLL``
    releases the GIL during every call into it."""
    key = (name, tuple(defines))
    with _lock:
        lib = _host_libs.get(key)
        if lib is None:
            lib = ctypes.CDLL(build_host(name, key[1]))
            _host_libs[key] = lib
        return lib
