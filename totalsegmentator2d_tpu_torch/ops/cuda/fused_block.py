"""Fused InstanceNorm-apply -> LeakyReLU -> conv3x3 (+ output statistics):
the CUDA kernel (csrc/fused_block.cu) and its plain PyTorch version.

Replaces the Pallas TPU kernel of the reference package
(``totalsegmentator2d_tpu/ops/pallas/fused_block.py``, ``_kernel``):

    y     = conv3x3_SAME(leaky_relu(x * scale + shift), w) + b
    stats = per (n, c_out): [sum(y), sum(y^2)] over H*W

with bf16 operands (x is rounded to bf16 first, the activation again after
normact), fp32 accumulation, y stored in bf16 and the statistics taken
from the fp32 values before that rounding. The SAME padding is zero in the
activated domain. ``apply_normact=False`` is a plain conv + statistics
(the first block of a stack). The layout is the reference's: x (N, H, W, C),
w (3, 3, C, Cout) HWIO, y (N, H, W, Cout), stats (N, 2, Cout).

The kernel reads w as bf16 (9C, Cout) rows ordered [ky, kx, c]: exactly the
memory of a contiguous bf16 HWIO tensor, which :func:`pack_weight` makes
once per model, so a launch casts and reshapes nothing.

:func:`fused_norm_act_conv` is the entry point: it launches the kernel for a
CUDA tensor (or raises) and takes the plain version only for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ...utils.device import exact_numerics


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, Cout) weight of any float dtype -> the kernel's bf16
    contiguous layout (its memory is the (9C, Cout) [ky, kx, c] matrix)."""
    return w.detach().to(torch.bfloat16).contiguous()


def fold_stats(stats: torch.Tensor, hw: int, gamma: Optional[torch.Tensor],
               beta: Optional[torch.Tensor], eps: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Accumulated [sum, sumsq] (N, 2, C) -> the next call's (scale, shift),
    each (N, C): scale = gamma * rsqrt(var + eps), shift = beta - mean *
    scale, with the biased one-pass variance clamped at 0."""
    mean = stats[:, 0] / hw
    var = torch.clamp(stats[:, 1] / hw - mean.square(), min=0.0)
    inv = torch.rsqrt(var + eps)
    g = inv if gamma is None else inv * gamma[None]
    s = -mean * g if beta is None else beta[None] - mean * g
    return g, s


def _check_shapes(x, scale, shift, w, b, apply_normact):
    if x.ndim != 4:
        raise ValueError(f'x must be (N, H, W, C), got shape {tuple(x.shape)}')
    N, _, _, C = x.shape
    if w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, C):
        raise ValueError(f'w must be (3, 3, {C}, Cout), got {tuple(w.shape)}')
    Cout = w.shape[3]
    if tuple(b.shape) != (Cout,):
        raise ValueError(f'b must be ({Cout},), got {tuple(b.shape)}')
    if apply_normact:
        for name, t in (('scale', scale), ('shift', shift)):
            if t is None or tuple(t.shape) != (N, C):
                raise ValueError(f'{name} must be ({N}, {C})')
    return N, C, Cout


def fused_norm_act_conv_plain(x: torch.Tensor, scale: Optional[torch.Tensor],
                              shift: Optional[torch.Tensor], w: torch.Tensor,
                              b: torch.Tensor, slope: float = 0.01,
                              apply_normact: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch (reference ``fused_block.reference``
    with the kernel's bf16 rounding of x): normact in fp32, rounded to bf16;
    a fp32 conv of the bf16-rounded activation and weight with TF32 off
    (products of bf16 values are exact in fp32, so only the order of the
    sums differs from the kernel); + b; fp32 statistics; y in bf16."""
    _check_shapes(x, scale, shift, w, b, apply_normact)
    z = x.to(torch.bfloat16).float()
    if apply_normact:
        z = z * scale[:, None, None, :] + shift[:, None, None, :]
        z = torch.where(z >= 0, z, z * slope).to(torch.bfloat16).float()
    wf = w.to(torch.bfloat16).float().permute(3, 2, 0, 1)  # HWIO -> OIHW
    with exact_numerics():
        out = F.conv2d(z.permute(0, 3, 1, 2), wf, padding=1)
    out = out.permute(0, 2, 3, 1) + b.float()
    stats = torch.stack([out.sum(dim=(1, 2)), out.square().sum(dim=(1, 2))],
                        dim=1)
    return out.to(torch.bfloat16), stats


@functools.lru_cache(maxsize=None)
def _library():
    from .build import library
    lib = library('fused_block')
    fn = lib.ts2d_fused_norm_act_conv
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.ts2d_fused_rows_per_tile.argtypes = [ctypes.c_int]
    lib.ts2d_fused_rows_per_tile.restype = ctypes.c_int
    return lib


def fused_norm_act_conv_cuda(x: torch.Tensor, scale: Optional[torch.Tensor],
                             shift: Optional[torch.Tensor], w: torch.Tensor,
                             b: torch.Tensor, slope: float = 0.01,
                             apply_normact: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream. x and w bf16, b (and
    scale, shift when ``apply_normact``) fp32, all contiguous CUDA tensors
    on one device; raises on anything else. Counts each launch in
    ``fused_norm_act_conv_cuda.launches``."""
    N, C, Cout = _check_shapes(x, scale, shift, w, b, apply_normact)
    named = [('x', x, torch.bfloat16), ('w', w, torch.bfloat16),
             ('b', b, torch.float32)]
    if apply_normact:
        named += [('scale', scale, torch.float32),
                  ('shift', shift, torch.float32)]
    for name, t, dtype in named:
        if t.device.type != 'cuda' or t.device != x.device:
            raise ValueError(f'the CUDA fused block needs {name} on the CUDA '
                             f'device of x, got {t.device}')
        if t.dtype != dtype:
            raise TypeError(f'{name} must be {dtype}, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if N > 65535 or C == 0:
        raise ValueError(f'unsupported shape N={N}, C={C}')
    _, H, W, _ = x.shape
    lib = _library()
    rows = lib.ts2d_fused_rows_per_tile(Cout)
    tiles = -(-(H * W) // rows)
    y = torch.empty((N, H, W, Cout), dtype=torch.bfloat16, device=x.device)
    stats = torch.empty((N, 2, Cout), dtype=torch.float32, device=x.device)
    partial = torch.empty((N, tiles, 2, Cout), dtype=torch.float32,
                          device=x.device)
    sc = scale.data_ptr() if apply_normact else None
    sh = shift.data_ptr() if apply_normact else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ts2d_fused_norm_act_conv(
            x.data_ptr(), sc, sh, w.data_ptr(), b.data_ptr(), y.data_ptr(),
            partial.data_ptr(), stats.data_ptr(), N, H, W, C, Cout,
            float(slope), int(bool(apply_normact)), stream)
    if err != 0:
        raise RuntimeError(f'fused block kernel launch failed: CUDA error {err}')
    fused_norm_act_conv_cuda.launches += 1
    return y, stats


fused_norm_act_conv_cuda.launches = 0


def fused_norm_act_conv(x: torch.Tensor, scale: Optional[torch.Tensor],
                        shift: Optional[torch.Tensor], w: torch.Tensor,
                        b: torch.Tensor, slope: float = 0.01,
                        apply_normact: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y, stats)`` of the fused block: the kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    fn = (fused_norm_act_conv_plain if x.device.type == 'cpu'
          else fused_norm_act_conv_cuda)
    return fn(x, scale, shift, w, b, slope=slope, apply_normact=apply_normact)
