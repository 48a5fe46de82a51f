"""The plain reference of the whole predict chain that decides ``correct``.

It re-derives, from the int16 image and the checkpoint files the benchmark
wrote, what ``TS2D.predict`` should answer, using numpy, scipy and plain
torch only: nothing of the program, nothing of the JAX package. The chain
follows the published nnU-Net 2D inference semantics (the oracle that
``tests/reference_chain.py`` keeps for the CPU tests, frozen here):

    the model input (a CT volume's coronal MIP + AIP in RAI; a native 2D
    radiograph as its own single channel) -> crop to nonzero -> z-score per
    channel -> order-3 B-spline resize to the plan spacing (scipy, mirror
    boundary, half-pixel grid) -> symmetric zero pad to the patch ->
    sliding windows at step 0.5 -> U-Net forwards of every tile under every
    mirror, averaged -> Gaussian-weighted overlap-add -> unpad -> order-1
    resize of the logits back to the crop -> sigmoid > 0.5 per label ->
    re-embed, groups concatenated in model order (the merged mask), one
    group at a time.

The U-Net is the one the configuration names (database.arch): nnU-Net's
PlainConvUNet (``Arch``, ``RefUNet``) or its ResidualEncoderUNet (``ResArch``,
``RefResUNet``; Isensee et al., "nnU-Net Revisited", MICCAI 2024), with the
state-dict names of dynamic_network_architectures, run in float32 with TF32
off. ``quant`` rounds every conv and transposed-conv operand first, a
residual skip's 1x1 conv included: 'tf32' (10 mantissa bits) or 'fp8'
(e4m3, one scale per tensor). Those are the controls: the reference computed
one precision below the configuration's, which the comparison has to refuse.

The residual net follows the paper's equations: a 3x3 conv stem to
``features[0]``; per stage ``blocks[s]`` BasicBlockD blocks, the first
strided below stage 0, each ``act(IN(conv2(act(IN(conv1(x))))) + skip(x))``;
PlainConvUNet's decoder. These details are taken from the published code
(dynamic_network_architectures/building_blocks/residual.py, BasicBlockD;
its source is not in the repository), not from the paper:

- ``skip`` is the identity where the block keeps its stride at 1 and its
  channel count; otherwise an ``nn.Sequential`` of AvgPool(s, s) where the
  block is strided, then, where the channel count changes, a 1x1 conv
  without bias and an InstanceNorm (no activation). So ``skip.0`` is the
  pool or the conv, ``skip.1`` the conv after a pool; a strided block that
  keeps its channel count pools only and has no skip weights;
- the stem is a one-conv ``StackedConvBlocks`` (``encoder.stem.convs.0``),
  the blocks ``encoder.stages.<s>.blocks.<b>.conv1`` / ``.conv2``;
- conv1 and conv2 carry a bias (the plans' ``conv_bias``); conv2's norm is
  not activated: the block's activation comes after the add.

As for PlainConvUNet, the aliases a real checkpoint also holds
(``all_modules.<i>``, the decoder's ``decoder.encoder.``) are not written:
the port drops them on load.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import scipy.ndimage as ndi
import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclass(frozen=True)
class Arch:
    """One group model: PlainConvUNet, 3x3 convs, stride 2 below stage 0,
    InstanceNorm (affine) and LeakyReLU(0.01) after every conv."""
    in_channels: int
    out_channels: int
    features: Tuple[int, ...]
    n_conv: int = 2
    eps: float = 1e-5
    slope: float = 0.01


@dataclass(frozen=True)
class ResArch:
    """One group model: ResidualEncoderUNet, 3x3 convs, a stem, ``blocks[s]``
    BasicBlockD blocks a stage (the first strided below stage 0), and
    PlainConvUNet's decoder with ``n_conv_decoder`` convs a stage;
    InstanceNorm (affine) and LeakyReLU(0.01) as in ``Arch``."""
    in_channels: int
    out_channels: int
    features: Tuple[int, ...]
    blocks: Tuple[int, ...]
    n_conv_decoder: int = 1
    eps: float = 1e-5
    slope: float = 0.01


# -- operand rounding (the controls) ------------------------------------------

def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10 mantissa bits, to nearest even."""
    bits = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 under one scale per tensor (amax -> 448)."""
    scale = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


QUANT: Dict[Optional[str], Callable[[torch.Tensor], torch.Tensor]] = {
    None: lambda t: t, 'tf32': round_tf32, 'fp8': round_fp8}


# -- the network ----------------------------------------------------------------

class _ConvNorm(nn.Module):
    """conv -> InstanceNorm: ConvDropoutNormReLU without its activation."""

    def __init__(self, cin: int, cout: int, stride: int, arch,
                 kernel: int = 3, bias: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride,
                              padding=kernel // 2, bias=bias)
        self.norm = nn.InstanceNorm2d(cout, eps=arch.eps, affine=True)

    def forward(self, x, q):
        x = F.conv2d(q(x), q(self.conv.weight), self.conv.bias,
                     self.conv.stride, self.conv.padding)
        return F.instance_norm(x, weight=self.norm.weight, bias=self.norm.bias,
                               eps=self.norm.eps)


class _Block(_ConvNorm):
    """conv -> InstanceNorm -> LeakyReLU."""

    def __init__(self, cin: int, cout: int, stride: int, arch):
        super().__init__(cin, cout, stride, arch)
        self.slope = arch.slope

    def forward(self, x, q):
        return F.leaky_relu(super().forward(x, q), self.slope)


class _Stack(nn.Module):
    def __init__(self, n: int, cin: int, cout: int, stride: int, arch):
        super().__init__()
        self.convs = nn.Sequential(*[
            _Block(cin if i == 0 else cout, cout, stride if i == 0 else 1,
                   arch) for i in range(n)])

    def forward(self, x, q):
        for block in self.convs:
            x = block(x, q)
        return x


class _Decoder(nn.Module):
    """nnU-Net's UNetDecoder, deepest stage first: a 2x2 stride-2
    transposed conv, the encoder's skip concatenated, ``n_conv`` blocks;
    the last stage's 1x1 segmentation head (the deeper heads are kept for
    the checkpoint's names, and not run)."""

    def __init__(self, n_conv: int, arch):
        super().__init__()
        f = arch.features
        below = list(range(len(f) - 1, 0, -1))
        self.transpconvs = nn.ModuleList([
            nn.ConvTranspose2d(f[s], f[s - 1], 2, 2) for s in below])
        self.stages = nn.ModuleList([
            _Stack(n_conv, 2 * f[s - 1], f[s - 1], 1, arch) for s in below])
        self.seg_layers = nn.ModuleList([
            nn.Conv2d(f[s - 1], arch.out_channels, 1) for s in below])

    def forward(self, skips: List[torch.Tensor], q):
        x = skips[-1]
        for d, (up, stage) in enumerate(zip(self.transpconvs, self.stages)):
            x = F.conv_transpose2d(q(x), q(up.weight), up.bias, stride=2)
            x = stage(torch.cat([x, skips[-2 - d]], dim=1), q)
        head = self.seg_layers[-1]
        return F.conv2d(q(x), q(head.weight), head.bias)


class RefUNet(nn.Module):
    """nnU-Net's PlainConvUNet (2D), named as its checkpoints name it."""

    def __init__(self, arch: Arch):
        super().__init__()
        f = arch.features
        self.encoder = nn.Module()
        self.encoder.stages = nn.ModuleList([
            _Stack(arch.n_conv, arch.in_channels if s == 0 else f[s - 1],
                   f[s], 1 if s == 0 else 2, arch) for s in range(len(f))])
        self.decoder = _Decoder(arch.n_conv, arch)

    def forward(self, x: torch.Tensor, quant: Optional[str] = None):
        q = QUANT[quant]
        skips = []
        for stage in self.encoder.stages:
            x = stage(x, q)
            skips.append(x)
        return self.decoder(skips, q)


class _BasicBlockD(nn.Module):
    """``act(IN(conv2(act(IN(conv1(x))))) + skip(x))``; ``skip`` as the
    module docstring says (an empty Sequential is the identity)."""

    def __init__(self, cin: int, cout: int, stride: int, arch: ResArch):
        super().__init__()
        self.conv1 = _Block(cin, cout, stride, arch)
        self.conv2 = _ConvNorm(cout, cout, 1, arch)
        self.skip = nn.Sequential(
            *([nn.AvgPool2d(stride, stride)] if stride != 1 else []),
            *([_ConvNorm(cin, cout, 1, arch, kernel=1, bias=False)]
              if cin != cout else []))
        self.slope = arch.slope

    def forward(self, x, q):
        r = x
        for op in self.skip:
            r = op(r, q) if isinstance(op, _ConvNorm) else op(r)
        return F.leaky_relu(self.conv2(self.conv1(x, q), q) + r, self.slope)


class _Residual(nn.Module):
    """StackedResidualBlocks: ``n`` blocks, the first at ``stride``."""

    def __init__(self, n: int, cin: int, cout: int, stride: int,
                 arch: ResArch):
        super().__init__()
        self.blocks = nn.Sequential(*[
            _BasicBlockD(cin if i == 0 else cout, cout,
                         stride if i == 0 else 1, arch) for i in range(n)])

    def forward(self, x, q):
        for block in self.blocks:
            x = block(x, q)
        return x


class RefResUNet(nn.Module):
    """nnU-Net's ResidualEncoderUNet (2D), named as
    dynamic_network_architectures names it."""

    def __init__(self, arch: ResArch):
        super().__init__()
        f = arch.features
        self.encoder = nn.Module()
        self.encoder.stem = _Stack(1, arch.in_channels, f[0], 1, arch)
        self.encoder.stages = nn.ModuleList([
            _Residual(arch.blocks[s], f[s - 1] if s else f[0], f[s],
                      1 if s == 0 else 2, arch) for s in range(len(f))])
        self.decoder = _Decoder(arch.n_conv_decoder, arch)

    def forward(self, x: torch.Tensor, quant: Optional[str] = None):
        q = QUANT[quant]
        x = self.encoder.stem(x, q)
        skips = []
        for stage in self.encoder.stages:
            x = stage(x, q)
            skips.append(x)
        return self.decoder(skips, q)


def network(arch) -> nn.Module:
    """The reference's network of an ``Arch`` or a ``ResArch``."""
    return RefResUNet(arch) if isinstance(arch, ResArch) else RefUNet(arch)


def init_state(arch, generator: torch.Generator, head_shift: float,
               device) -> Dict[str, torch.Tensor]:
    """Random weights of ``network(arch)`` in one draw, in the state dict's
    order: He-normal weights of every conv and transposed conv, a residual
    skip's 1x1 conv included (std sqrt(2 / fan_in)), zero biases, unit norm
    scales, and every segmentation head's bias at ``head_shift`` so that
    each label's foreground is a small share of the image, as trained heads
    make it."""
    shapes = network(arch).state_dict()
    weights = [(k, v.shape) for k, v in shapes.items()
               if k.endswith('.weight') and v.dim() == 4]
    flat = torch.randn(sum(s.numel() for _, s in weights),
                       generator=generator, device=device)
    state, at = {}, 0
    for k, s in weights:
        fan_in = s[0] * s[2] * s[3] if '.transpconvs.' in k else s[1:].numel()
        state[k] = (flat[at:at + s.numel()].view(s)
                    * (2.0 / fan_in) ** 0.5).clone()
        at += s.numel()
    for k, v in shapes.items():
        if k in state:
            continue
        fill = 1.0 if k.endswith('norm.weight') else (
            head_shift if '.seg_layers.' in k else 0.0)
        state[k] = torch.full(v.shape, fill, device=device)
    return state


# -- the chain ------------------------------------------------------------------

def project(volume: np.ndarray) -> np.ndarray:
    """(z, y, x) int16 volume in RAI -> (z, x, 2) float32 coronal MIP, AIP
    (the mean of the integers in float64, rounded once)."""
    mip = volume.max(axis=1).astype(np.float32)
    aip = volume.mean(axis=1, dtype=np.float64).astype(np.float32)
    return np.stack([mip, aip], axis=-1)


def model_input(image: np.ndarray, spacing: Sequence[float]):
    """An int16 image of the traffic and its spacing in ITK order -> the
    (H, W, C) float32 array the models read and its (y, x) spacing: a
    (z, y, x) CT volume's (z, x, 2) coronal projection at the z and x
    spacing; a (rows, cols) radiograph as its own single channel."""
    arr = (project(image) if image.ndim == 3
           else image.astype(np.float32)[..., None])
    return arr, spacing_yx(spacing)


def spacing_yx(spacing: Sequence[float]) -> Tuple[float, float]:
    """A mix's spacing in ITK order -> the (rows, cols) spacing of its model
    inputs: a CT's coronal projection (z, x), a radiograph's (y, x)."""
    return ((spacing[2], spacing[0]) if len(spacing) == 3
            else (spacing[1], spacing[0]))


def nonzero_bbox(arr: np.ndarray):
    ys, xs = np.nonzero(np.any(arr != 0, axis=-1))
    if ys.size == 0:
        return (0, arr.shape[0]), (0, arr.shape[1])
    return (int(ys.min()), int(ys.max()) + 1), (int(xs.min()), int(xs.max()) + 1)


def zscore(arr: np.ndarray) -> np.ndarray:
    out = np.empty(arr.shape, np.float32)
    for c in range(arr.shape[-1]):
        x = arr[..., c].astype(np.float32)
        out[..., c] = (x - x.mean()) / max(float(x.std()), 1e-8)
    return out


def resize_cubic(arr: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Order-3 B-spline resize of the two leading axes: half-pixel sample
    positions clamped to the grid, the spline over the mirrored signal."""
    (H, W), (ny, nx) = arr.shape[:2], shape
    if (ny, nx) == (H, W):
        return arr.astype(np.float32)
    cy = np.clip((np.arange(ny) + 0.5) * (H / ny) - 0.5, 0, H - 1)
    cx = np.clip((np.arange(nx) + 0.5) * (W / nx) - 0.5, 0, W - 1)
    grid = np.meshgrid(cy, cx, indexing='ij')
    return np.stack([ndi.map_coordinates(arr[..., c].astype(np.float64), grid,
                                         order=3, mode='mirror')
                     for c in range(arr.shape[-1])], axis=-1).astype(np.float32)


def resize_linear(x: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Order-1 resize of the two trailing axes of (L, h, w) logits, by the
    same half-pixel clamped positions, one axis after the other."""
    for axis, n_out in ((-2, shape[0]), (-1, shape[1])):
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        pos = ((torch.arange(n_out, dtype=torch.float64, device=x.device)
                + 0.5) * (n_in / n_out) - 0.5).clamp(0, n_in - 1)
        i0 = pos.floor().long()
        i1 = (i0 + 1).clamp(max=n_in - 1)
        w = (pos - i0).to(x.dtype)
        shape_w = [1] * x.dim()
        shape_w[axis] = n_out
        w = w.view(shape_w)
        x = (x.index_select(axis, i0) * (1 - w)
             + x.index_select(axis, i1) * w)
    return x


def sliding_steps(size: int, tile: int, step: float) -> List[int]:
    """nnU-Net's compute_steps_for_sliding_window."""
    if size == tile:
        return [0]
    num = int(np.ceil((size - tile) / (tile * step))) + 1
    actual = (size - tile) / max(num - 1, 1)
    return [int(round(actual * i)) for i in range(num)]


def gaussian_importance(patch: Tuple[int, int]) -> np.ndarray:
    """nnU-Net's compute_gaussian: sigma = patch / 8, max 1, zeros raised
    to the smallest positive weight."""
    delta = np.zeros(patch, np.float32)
    delta[tuple(p // 2 for p in patch)] = 1.0
    g = ndi.gaussian_filter(delta, sigma=[p / 8 for p in patch],
                            mode='constant')
    g /= g.max()
    g[g == 0] = g[g > 0].min()
    return g.astype(np.float32)


def mirror_combos(axes: Sequence[int]) -> List[Tuple[int, ...]]:
    combos: List[Tuple[int, ...]] = [()]
    for ax in axes:
        combos += [c + (ax,) for c in combos]
    return combos


def resampled_shape(shape_hw: Sequence[int], spacing_yx: Sequence[float],
                    plan_spacing: Sequence[float]) -> Tuple[int, ...]:
    """The crop's shape at the plan spacing."""
    return tuple(int(round(n * o / s)) for n, o, s in
                 zip(shape_hw, spacing_yx, plan_spacing))


def tile_count(shape_hw: Tuple[int, int], spacing_yx: Sequence[float],
               patch: Tuple[int, int], plan_spacing: Sequence[float],
               step: float) -> int:
    """Tiles of one scan's sliding window: the crop resized to the plan
    spacing, padded up to the patch."""
    rs = resampled_shape(shape_hw, spacing_yx, plan_spacing)
    return int(np.prod([len(sliding_steps(max(n, p), p, step))
                        for n, p in zip(rs, patch)]))


@contextlib.contextmanager
def float32_only():
    """Convs and matmuls in float32: TF32 off while the block runs."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=False,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


@torch.no_grad()
def group_logits(arr: np.ndarray, spacing_yx: Sequence[float],
                 groups: Sequence[Sequence[nn.Module]], patch: Tuple[int, int],
                 plan_spacing: Sequence[float], step: float,
                 mirror_axes: Sequence[int], quant: Optional[str] = None,
                 chunk: int = 16) -> Iterator[torch.Tensor]:
    """(H, W, C) model input -> each group's (H, W, labels) float32 logits
    on the nets' device, in model order; -inf outside the crop, where every
    label is background. ``groups``: each group's networks, one a fold,
    averaged. One group's logits at a time: a radiograph's 117 labels
    together would take gigabytes a copy."""
    device = next(groups[0][0].parameters()).device
    (y0, y1), (x0, x1) = nonzero_bbox(arr)
    work = zscore(arr[y0:y1, x0:x1])
    crop = work.shape[:2]
    rs = resampled_shape(crop, spacing_yx, plan_spacing)
    work = resize_cubic(work, rs)
    padded = tuple(max(n, p) for n, p in zip(rs, patch))
    pads = [((t - n) // 2, t - n - (t - n) // 2) for n, t in zip(rs, padded)]
    work = np.pad(work, pads + [(0, 0)])
    image = torch.from_numpy(np.ascontiguousarray(
        work.transpose(2, 0, 1))).to(device)

    starts = [(ty, tx) for ty in sliding_steps(padded[0], patch[0], step)
              for tx in sliding_steps(padded[1], patch[1], step)]
    mirrors = mirror_combos(mirror_axes)
    tiles = torch.stack([image[:, ty:ty + patch[0], tx:tx + patch[1]]
                         for ty, tx in starts])
    batch = torch.cat([torch.flip(tiles, [a + 2 for a in m]) if m else tiles
                       for m in mirrors])        # mirror-major: (M * T, C, p, p)
    gauss = torch.from_numpy(gaussian_importance(patch)).to(device)
    wacc = torch.zeros(padded, device=device)
    for ty, tx in starts:
        wacc[ty:ty + patch[0], tx:tx + patch[1]] += gauss

    T = len(starts)
    for folds in groups:
        with float32_only():
            out = sum(torch.cat([net(batch[i:i + chunk], quant)
                                 for i in range(0, len(batch), chunk)])
                      for net in folds)
            tile_logits = sum(
                torch.flip(out[k * T:(k + 1) * T], [a + 2 for a in m])
                if m else out[k * T:(k + 1) * T]
                for k, m in enumerate(mirrors)) / (len(mirrors) * len(folds))
            acc = torch.zeros((out.shape[1],) + padded, device=device)
            for t, (ty, tx) in enumerate(starts):
                acc[:, ty:ty + patch[0], tx:tx + patch[1]] += (
                    tile_logits[t] * gauss)
            lg = acc / wacc.clamp_min(1e-8)
            lg = lg[:, pads[0][0]:pads[0][0] + rs[0],
                    pads[1][0]:pads[1][0] + rs[1]]
            full = torch.full((lg.shape[0],) + arr.shape[:2], float('-inf'),
                              device=device)
            full[:, y0:y1, x0:x1] = resize_linear(lg, crop)
        yield full.permute(1, 2, 0)
        del full       # before the next group's is made
