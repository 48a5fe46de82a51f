"""Cubic B-spline prefilter: the CUDA kernel (csrc/prefilter.cu) and its
plain PyTorch version.

Replaces the Pallas TPU kernel of the reference package
(``totalsegmentator2d_tpu/ops/pallas/prefilter.py``, ``_kernel``). Both
versions here compute exactly its recursion, in float32:

    causal      s[i] = g*x[i] + z*s[i-1]     z = sqrt(3)-2, g = (1-z)(1-1/z)
                s[0] = g * sum_{k<=horizon} z^k x[mirror(k)]
    anticausal  c[n-1] = (z*s[n-2] + s[n-1]) * z/(z^2-1)
                c[i]   = z*(c[i+1] - s[i])

with ``horizon = min(HORIZON, 2n-2)`` taps, ``HORIZON = ceil(log 1e-10 /
log|z|) = 18`` and the mirror index wrapping with period 2n-2: the
reference's series (its ``ops/resample.py:72`` and
``ops/pallas/prefilter.py:104``). For n < 10 that cap truncates the series
short of the tolerance (6.4e-3 off scipy at n = 2); the port keeps the
reference's result.

:func:`prefilter_axis` is the entry point: it launches the kernel for a CUDA
tensor (or raises) and takes the plain version only for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

_Z = float(np.sqrt(3.0) - 2.0)
_GAIN = (1.0 - _Z) * (1.0 - 1.0 / _Z)
# taps of the causal-init series: |z|^HORIZON <= 1e-10
HORIZON = int(math.ceil(math.log(1e-10) / math.log(abs(_Z))))


def horizon(n: int) -> int:
    """Taps of the causal-init series for a line of n samples."""
    return min(HORIZON, 2 * n - 2)


def _f32(v: float) -> float:
    return float(np.float32(v))


def _mirror_index(k: int, n: int) -> int:
    period = 2 * n - 2
    k %= period
    return k if k < n else period - k


def _lines(shape, axis: int):
    outer = math.prod(shape[:axis])
    inner = math.prod(shape[axis + 1:])
    return outer, int(shape[axis]), inner


def _check(x: torch.Tensor, axis: int) -> int:
    if x.dtype != torch.float32:
        raise TypeError(f'the prefilter takes float32, got {x.dtype}')
    if not -x.ndim <= axis < x.ndim:
        raise ValueError(f'axis {axis} out of range for {x.ndim} dims')
    return axis % x.ndim


def bspline_prefilter_plain(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Step-by-step PyTorch loop over the filter axis with the kernel's
    arithmetic (every product and sum rounded to float32 on its own)."""
    axis = _check(x, axis)
    outer, n, inner = _lines(x.shape, axis)
    if n == 1:
        return x
    v = x.contiguous().view(outer, n, inner)
    y = torch.empty_like(v)
    z, gain = _f32(_Z), _f32(_GAIN)
    s = v[:, 0] * gain
    zk = 1.0
    for k in range(1, horizon(n) + 1):
        zk *= _Z
        s = s + v[:, _mirror_index(k, n)] * _f32(_GAIN * zk)
    y[:, 0] = s
    for i in range(1, n):
        s = v[:, i] * gain + s * z
        y[:, i] = s
    c = (y[:, n - 2] * z + s) * _f32(_Z / (_Z * _Z - 1.0))
    y[:, n - 1] = c
    for i in range(n - 2, -1, -1):
        c = (c - y[:, i]) * z
        y[:, i] = c
    return y.view(x.shape)


@functools.lru_cache(maxsize=None)
def _kernel():
    from .build import library
    fn = library('prefilter').ts2d_prefilter
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bspline_prefilter_cuda(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Launch the CUDA kernel on a contiguous float32 CUDA tensor, on the
    current stream. Counts each launch in ``bspline_prefilter_cuda.launches``."""
    axis = _check(x, axis)
    if x.device.type != 'cuda':
        raise ValueError(f'the CUDA prefilter needs a CUDA tensor, got '
                         f'{x.device}')
    if not x.is_contiguous():
        raise ValueError('the CUDA prefilter needs a contiguous tensor')
    outer, n, inner = _lines(x.shape, axis)
    if n == 1:
        return x
    fn = _kernel()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), outer, n, inner, horizon(n),
                 stream)
    if err != 0:
        raise RuntimeError(f'prefilter kernel launch failed: CUDA error {err}')
    bspline_prefilter_cuda.launches += 1
    return y


bspline_prefilter_cuda.launches = 0


def prefilter_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """The prefilter along one axis: the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if x.device.type == 'cpu':
        return bspline_prefilter_plain(x, axis)
    return bspline_prefilter_cuda(x.contiguous(), axis)
