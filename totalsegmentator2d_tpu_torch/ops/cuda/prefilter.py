"""Cubic B-spline prefilter: the CUDA kernel (csrc/prefilter.cu) and its
plain PyTorch versions.

Replaces the Pallas TPU kernel of the reference package
(``totalsegmentator2d_tpu/ops/pallas/prefilter.py``, ``_kernel``). Every
version here computes its recursion, in float32:

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

:func:`bspline_prefilter_plain` walks each line in order.
:func:`bspline_prefilter_chunked_plain` cuts it into chunks that are
computed independently, each from a warm-up of ``WARM`` samples on either
side (the kernel's decomposition, see ``csrc/prefilter.cu``); it agrees
with the sequential version to float32 rounding and with the kernel bit for
bit. :func:`prefilter_axis` is the entry point: it launches the kernel for
a CUDA tensor (or raises) and takes the sequential plain version only for a
CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from . import count_launch

_Z = POLE = float(np.sqrt(3.0) - 2.0)
_GAIN = (1.0 - _Z) * (1.0 - 1.0 / _Z)
# taps of the causal-init series: |z|^HORIZON <= 1e-10
HORIZON = int(math.ceil(math.log(1e-10) / math.log(abs(_Z))))
# the kernel's chunk (outputs per work item) and warm-up on either side:
# |z|^(WARM+1) < 1.4e-11, below float32 rounding (csrc/prefilter.cu)
CHUNK = 32
WARM = 18


def horizon(n: int, taps: int = HORIZON) -> int:
    """Taps of the causal-init series for a line of n samples (of a series
    truncated at ``taps``)."""
    return min(taps, 2 * n - 2)


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


def _causal_init(v: torch.Tensor, n: int, taps: int) -> torch.Tensor:
    """s[0] of lines v (outer, n, ...): the mirrored series, tap weights
    rounded from double."""
    s = v[:, 0] * _f32(_GAIN)
    zk = 1.0
    for k in range(1, horizon(n, taps) + 1):
        zk *= _Z
        s = s + v[:, _mirror_index(k, n)] * _f32(_GAIN * zk)
    return s


def bspline_prefilter_plain(x: torch.Tensor, axis: int,
                            taps: int = HORIZON) -> torch.Tensor:
    """Step-by-step PyTorch loop over the filter axis, every product and sum
    rounded to float32 on its own; the causal init's series truncated at
    ``taps``."""
    axis = _check(x, axis)
    outer, n, inner = _lines(x.shape, axis)
    if n == 1:
        return x
    v = x.contiguous().view(outer, n, inner)
    y = torch.empty_like(v)
    z, gain = _f32(_Z), _f32(_GAIN)
    s = _causal_init(v, n, taps)
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


def bspline_prefilter_chunked_plain(x: torch.Tensor, axis: int,
                                    chunk: int = CHUNK) -> torch.Tensor:
    """The kernel's decomposition in vectorised PyTorch, one op per rounding.

    Chunk c holds outputs [c0, e) = [c*chunk, min(c0+chunk, n)) and works on
    the window [a, b) of its line: a = c0-1-WARM (or 0, with the mirrored
    init, where that is below WARM+1), b = e+WARM (or n, starting the
    anticausal pass from the closed form, where that reaches n-1). The
    causal pass runs forward over the window from zero state, the
    anticausal pass backward from zero state; all chunks of all lines move
    one window step at a time."""
    axis = _check(x, axis)
    outer, n, inner = _lines(x.shape, axis)
    if n == 1:
        return x
    v = x.contiguous().view(outer, n, inner)
    z, gain = _f32(_Z), _f32(_GAIN)
    cz = _f32(_Z / (_Z * _Z - 1.0))
    dev = v.device
    c0 = torch.arange(0, n, chunk, device=dev)
    nch = c0.numel()
    e = (c0 + chunk).clamp(max=n)
    from0 = c0 <= WARM
    tail = e + WARM >= n
    a = torch.where(from0, 0, c0 - 1 - WARM)
    last = torch.where(tail, n, e + WARM) - a - 1   # window index of b-1
    span = int(last.max()) + 1
    steps = torch.arange(span, device=dev)
    xw = v[:, (a[:, None] + steps).clamp(max=n - 1)]  # (outer, nch, span, inner)

    s = torch.where(from0[None, :, None], _causal_init(v, n, HORIZON)[:, None],
                    xw[:, :, 0] * gain)
    sw = torch.empty_like(xw)
    sw[:, :, 0] = s
    for k in range(1, span):
        s = xw[:, :, k] * gain + s * z
        sw[:, :, k] = s

    rows = torch.arange(nch, device=dev)
    closed = (sw[:, rows, (last - 1).clamp(min=0)] * z
              + sw[:, rows, last]) * cz
    is_closed = (tail[:, None] & (steps == last[:, None]))[None, :, :, None]
    beyond = (steps > last[:, None])[None, :, :, None]
    cw = torch.empty_like(xw)
    c = torch.zeros_like(s)
    for k in range(span - 1, -1, -1):
        c = torch.where(beyond[:, :, k], 0.0,
                        torch.where(is_closed[:, :, k], closed,
                                    (c - sw[:, :, k]) * z))
        cw[:, :, k] = c

    first = (c0 - a)[:, None] + torch.arange(chunk, device=dev)
    y = cw[:, rows[:, None], first.clamp(max=span - 1)]  # (outer, nch, chunk, inner)
    return y.reshape(outer, nch * chunk, inner)[:, :n].reshape(x.shape)


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
    current stream. Counts each launch in ``bspline_prefilter_cuda.launches``
    (:func:`count_launch`)."""
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
    args = (x.data_ptr(), y.data_ptr(), outer, n, inner, horizon(n),
            torch.cuda.current_stream(x.device).cuda_stream)
    if x.device.index == torch.cuda.current_device():
        err = fn(*args)
    else:  # the launch goes to the current device
        with torch.cuda.device(x.device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f'prefilter kernel launch failed: CUDA error {err}')
    count_launch(bspline_prefilter_cuda)
    return y


bspline_prefilter_cuda.launches = 0


def prefilter_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """The prefilter along one axis: the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if x.device.type == 'cpu':
        return bspline_prefilter_plain(x, axis)
    return bspline_prefilter_cuda(x.contiguous(), axis)
