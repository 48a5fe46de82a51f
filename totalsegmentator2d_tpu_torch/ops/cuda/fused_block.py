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
once per model, so a launch casts and reshapes nothing. It loads x and w by
TMA, which takes C % 32 == 0 and Cout % 8 == 0 (every flagship U-Net stage);
:func:`pad_channels` zero-pads other counts before the launch, chosen by
shape, and the wrapper slices y and stats back.

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
from . import count_launch


# channel multiples the kernel takes (TMA's 16-byte strides, and whole
# 32-channel chunks of k16 wgmma steps per tap)
C_MULTIPLE = 32
COUT_MULTIPLE = 8


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


def pad_channels(x: torch.Tensor, scale: Optional[torch.Tensor],
                 shift: Optional[torch.Tensor], w: torch.Tensor,
                 b: torch.Tensor, c_multiple: int = C_MULTIPLE,
                 cout_multiple: int = COUT_MULTIPLE):
    """Zero-pad the input channels to a multiple of ``c_multiple`` and the
    output channels to a multiple of ``cout_multiple``: x, w and b with
    zeros, and scale and shift with zeros, so a padded input channel's
    activation is leaky(0) = 0 and a padded output channel is 0. Returns
    the five operands (unchanged when no padding is needed); slice y and
    stats back to the first Cout channels afterwards."""
    C, Cout = w.shape[2], w.shape[3]
    pc, po = -C % c_multiple, -Cout % cout_multiple
    if pc == 0 and po == 0:
        return x, scale, shift, w, b
    x = F.pad(x, (0, pc))
    if scale is not None:
        scale = F.pad(scale, (0, pc))
    if shift is not None:
        shift = F.pad(shift, (0, pc))
    return x, scale, shift, F.pad(w, (0, po, 0, pc)), F.pad(b, (0, po))


@functools.lru_cache(maxsize=None)
def _library():
    from .build import library
    lib = library('fused_block')
    fn = lib.ts2d_fused_norm_act_conv
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.ts2d_fused_scratch_floats.argtypes = [ctypes.c_int] * 5
    lib.ts2d_fused_scratch_floats.restype = ctypes.c_longlong
    lib.ts2d_fused_kernel_info.argtypes = ([ctypes.c_int] * 5
                                           + [ctypes.POINTER(ctypes.c_int)])
    lib.ts2d_fused_kernel_info.restype = ctypes.c_int
    return lib


KERNEL_INFO_KEYS = ('bn', 'tile_pixels', 'mode', 'resident_weights',
                    'units', 'grid', 'registers', 'static_smem',
                    'dynamic_smem', 'local_bytes', 'blocks_per_sm')


def kernel_info(N: int, H: int, W: int, C: int, Cout: int) -> dict:
    """The launch configuration the kernel takes for this shape and its
    instantiation's resources (registers per thread at entry, shared memory,
    spills, blocks per SM), from cudaFuncGetAttributes and the occupancy
    calculator. Needs the card."""
    lib = _library()
    info = (ctypes.c_int * len(KERNEL_INFO_KEYS))()
    err = lib.ts2d_fused_kernel_info(N, H, W, C, Cout, info)
    if err != 0:
        raise RuntimeError(f'fused block kernel info failed: error {err}')
    return dict(zip(KERNEL_INFO_KEYS, info))


def fused_norm_act_conv_cuda(x: torch.Tensor, scale: Optional[torch.Tensor],
                             shift: Optional[torch.Tensor], w: torch.Tensor,
                             b: torch.Tensor, slope: float = 0.01,
                             apply_normact: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream. x and w bf16, b (and
    scale, shift when ``apply_normact``) fp32, all contiguous CUDA tensors
    on one device; raises on anything else. Channel counts the kernel does
    not take are zero-padded first (:func:`pad_channels`). Counts each
    launch in ``fused_norm_act_conv_cuda.launches`` (:func:`count_launch`)."""
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
    for name, t in (('x', x), ('w', w)):
        if t.data_ptr() % 16:
            raise ValueError(f'{name} must be 16-byte aligned (TMA)')
    if C == 0:
        raise ValueError('unsupported shape C=0')
    if not apply_normact:
        scale = shift = None
    x, scale, shift, w, b = pad_channels(x, scale, shift, w, b)
    Cp, Cop = w.shape[2], w.shape[3]
    _, H, W, _ = x.shape
    lib = _library()
    sc = scale.data_ptr() if apply_normact else None
    sh = shift.data_ptr() if apply_normact else None
    with torch.cuda.device(x.device):
        # the scratch size depends on the device's SM count
        floats = lib.ts2d_fused_scratch_floats(N, H, W, Cp, Cop)
        if floats < 0:
            raise ValueError(f'unsupported fused block launch N={N}, H={H}, '
                             f'W={W}, C={Cp}, Cout={Cop}')
        y = torch.empty((N, H, W, Cop), dtype=torch.bfloat16, device=x.device)
        stats = torch.empty((N, 2, Cop), dtype=torch.float32, device=x.device)
        scratch = torch.empty((floats,), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ts2d_fused_norm_act_conv(
            x.data_ptr(), sc, sh, w.data_ptr(), b.data_ptr(), y.data_ptr(),
            scratch.data_ptr(), stats.data_ptr(), N, H, W, Cp, Cop,
            float(slope), int(bool(apply_normact)), stream)
    if err != 0:
        what = (f'tensor-map encode failed: CUresult {err - 1000}'
                if err >= 1000 else f'CUDA error {err}')
        raise RuntimeError(f'fused block kernel launch failed: {what}')
    count_launch(fused_norm_act_conv_cuda)
    if Cop != Cout:
        y, stats = y[..., :Cout].contiguous(), stats[..., :Cout].contiguous()
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
