"""The benchmark's arithmetic: percentiles, rates, the device's busy time
from kernel intervals, and the operations and bytes of the work the program
should do, counted from shapes (never from what the program launched), with
the card's published peaks to divide them by."""

from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple

from . import reference

# NVIDIA H100 SXM data sheet, dense rates, 700 W: HBM3 bandwidth, float32
# outside the tensor cores (the 'exact' precision runs with TF32 off), bf16
# on the tensor cores
PEAKS = {'hbm_bytes_per_s': 3.35e12, 'fp32_flop_per_s': 67e12,
         'bf16_flop_per_s': 989e12}
# the precision a configuration states -> the peak its convs run at
PRECISION_PEAK = {'exact': 'fp32_flop_per_s', 'fast': 'bf16_flop_per_s'}
# the prefilter's causal initialisation: taps of the series (ops/cuda
# prefilter.py HORIZON)
PREFILTER_HORIZON = 18


def quantile(values: Sequence[float], q: float) -> float:
    """The q-th quantile (0 < q < 1) by linear interpolation between order
    statistics (numpy's default, statistics' 'inclusive' method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError('no values')
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile as a share of the
    median, by ``statistics.quantiles(values, n=4)``."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def rate(count: int, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError('a window of no time')
    return count / seconds


def merged(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def busy(spans: Iterable[Tuple[float, float]]) -> float:
    """Time covered by at least one interval."""
    return sum(e - s for s, e in merged(spans))


def gaps(spans: Iterable[Tuple[float, float]], start: float,
         end: float) -> List[Tuple[float, float]]:
    """The idle intervals of [start, end) that no interval covers."""
    out, at = [], start
    for s, e in merged(spans):
        if s > at:
            out.append((at, min(s, end)))
        at = max(at, e)
        if at >= end:
            break
    if at < end:
        out.append((at, end))
    return [(s, e) for s, e in out if e > s]


# -- the U-Net ---------------------------------------------------------------

def convs(arch, h: int, w: int) -> List[Tuple[int, int, int, int, int, int,
                                             bool]]:
    """Every conv of one forward of ``arch`` on an h x w input, in order:
    (kernel area, stride, H, W, C, Cout, fed). A conv's H x W is its
    output's; a transposed conv (stride 0) has its input's, since its
    operations are counted per input pixel. ``fed``: the conv's input is the
    raw output of the conv before it, whose norm and activation the fused
    route applies as it reads it, not an activation held in memory.

    ``arch``: a reference.Arch, PlainConvUNet: ``n_conv`` 3x3 convs a stage,
    stride 2 below stage 0. Or a reference.ResArch, ResidualEncoderUNet: a
    3x3 stem, then ``blocks[s]`` blocks a stage, each conv1 (3x3, stride 2
    in a stage's first block below stage 0), conv2 (3x3) and, where the
    channel count changes, the skip's 1x1 conv at conv1's output size. Both
    decode through 2x2 stride-2 transposed convs and stages of 3x3 convs on
    the concatenated skip, and end in the last 1x1 segmentation head."""
    out = []
    f = arch.features

    def stack(n, cin, cout, stride, hs, ws):
        out.extend((9, stride if i == 0 else 1, hs, ws,
                    cin if i == 0 else cout, cout, i > 0) for i in range(n))

    residual = isinstance(arch, reference.ResArch)
    cin = arch.in_channels
    if residual:
        stack(1, cin, f[0], 1, h, w)
        cin = f[0]
    for s, c in enumerate(f):
        hs, ws, stride = h >> s, w >> s, 1 if s == 0 else 2
        if not residual:
            stack(arch.n_conv, cin, c, stride, hs, ws)
        else:
            for b in range(arch.blocks[s]):
                ci = cin if b == 0 else c
                out += [(9, stride if b == 0 else 1, hs, ws, ci, c, False),
                        (9, 1, hs, ws, c, c, True)]
                if ci != c:
                    out.append((1, 1, hs, ws, ci, c, False))
        cin = c
    n_dec = arch.n_conv_decoder if residual else arch.n_conv
    for e in range(len(f) - 1, 0, -1):
        out.append((4, 0, h >> e, w >> e, f[e], f[e - 1], False))
        stack(n_dec, 2 * f[e - 1], f[e - 1], 1, h >> (e - 1), w >> (e - 1))
    out.append((1, 1, h, w, f[0], arch.out_channels, False))
    return out


def unet_flops(arch, h: int, w: int) -> int:
    """Operations (2 per multiply-add) of one forward of ``arch`` on an
    h x w input: every conv, transposed conv, residual skip's 1x1 conv and
    the last segmentation head (``convs``). Norms, activations, adds, pools
    and bias adds are not counted."""
    return sum(2 * k * c * co * hs * ws for k, _, hs, ws, c, co, _ in
               convs(arch, h, w))


def fused_launches(arch, patch: Tuple[int, int]
                   ) -> List[Tuple[int, int, int, int]]:
    """(H, W, C, Cout) of every 3x3 conv of one fast forward that the fused
    norm-act-conv kernel computes: at stride 1, fed by the conv before it
    (with that conv's norm-act: every later conv of a stack, a residual
    block's conv2), or on an activation held in memory (without norm-act)
    with C >= 16."""
    return [(hs, ws, c, co) for k, stride, hs, ws, c, co, fed in
            convs(arch, *patch)
            if k == 9 and stride == 1 and (fed or c >= 16)]


def fused_bound_s(n: int, h: int, w: int, c: int, co: int) -> float:
    """The least time of one fused block over a batch of n: its bytes (the
    bf16 input, weights, scale and shift, bias read once; the bf16 output
    and float32 statistics written once) over HBM, or its bf16 operations
    over the tensor cores, whichever is longer."""
    nbytes = (n * h * w * (c + co) * 2 + 9 * c * co * 2 + n * c * 8 + co * 4
              + n * 2 * co * 4)
    flops = 2 * 9 * c * co * n * h * w
    return max(nbytes / PEAKS['hbm_bytes_per_s'],
               flops / PEAKS['bf16_flop_per_s'])


def prefilter_bound_s(passes: Iterable[Tuple[int, int]]) -> float:
    """The least time of B-spline prefilter passes [(n, lines), ...]: each
    reads its float32 samples once and writes them once, and its operations
    (5 a sample and the initialisation series) go at the float32 rate."""
    passes = list(passes)
    nbytes = sum(2 * n * lines * 4 for n, lines in passes)
    flops = sum(lines * (5 * n + 2 * PREFILTER_HORIZON) for n, lines in passes)
    return max(nbytes / PEAKS['hbm_bytes_per_s'],
               flops / PEAKS['fp32_flop_per_s'])
