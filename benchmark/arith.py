"""The benchmark's arithmetic: percentiles, rates, the device's busy time
from kernel intervals, and the operations and bytes of the work the program
should do, counted from shapes (never from what the program launched), with
the card's published peaks to divide them by."""

from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple

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

def unet_flops(features: Sequence[int], in_channels: int, out_channels: int,
               h: int, w: int) -> int:
    """Operations (2 per multiply-add) of one PlainConvUNet forward on an
    h x w input: two 3x3 convs a stage, stride 2 below stage 0, 2x2
    stride-2 transposed convs, two 3x3 convs a decoder stage on the
    concatenated skip, and the last 1x1 segmentation head. Norms,
    activations and bias adds are not counted."""
    total, cin, res = 0, in_channels, []
    for s, f in enumerate(features):
        if s:
            h, w = h // 2, w // 2
        total += 2 * 9 * (cin * f + f * f) * h * w
        cin = f
        res.append((h, w))
    for s in range(len(features) - 1, 0, -1):
        (h, w), skip = res[s - 1], features[s - 1]
        total += 2 * features[s] * skip * 4 * (h // 2) * (w // 2)
        total += 2 * 9 * (2 * skip * skip + skip * skip) * h * w
    return total + 2 * features[0] * out_channels * h * w


def fused_launches(features: Sequence[int], in_channels: int,
                   patch: Tuple[int, int]) -> List[Tuple[int, int, int, int]]:
    """(H, W, C, Cout) of every norm-act-conv block of one fast forward that
    the fused route takes: a stack's first block when its stride is 1 and
    C >= 16 (without norm-act on its input), and every later block of a
    stack (with the norm-act of the block before)."""
    h, w = patch
    out, cin = [], in_channels
    for s, f in enumerate(features):
        hs, ws = h >> s, w >> s
        if s == 0 and cin >= 16:
            out.append((hs, ws, cin, f))
        out.append((hs, ws, f, f))
        cin = f
    for e in range(len(features) - 1, 0, -1):
        hs, ws, cs = h >> (e - 1), w >> (e - 1), features[e - 1]
        out += [(hs, ws, 2 * cs, cs), (hs, ws, cs, cs)]
    return out


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
