"""Gaussian importance map for sliding-window blending.

nnU-Net weights every predicted tile with a Gaussian centred on the patch:
a delta at ``n // 2`` (not the geometric centre ``(n - 1) / 2``) filtered
with sigma = patch/8, mode='constant' -- the sampled kernel truncated at
radius ``int(4*sigma + 0.5)`` -- normalised to max 1, with exact zeros
floored at the smallest positive value so no tile pixel has zero weight.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np


@functools.lru_cache(maxsize=64)
def gaussian_map(patch_size: Tuple[int, ...], sigma_scale: float = 0.125,
                 dtype=np.float32) -> np.ndarray:
    axes = []
    for n in patch_size:
        sigma = max(n * sigma_scale, 1e-8)
        radius = int(4.0 * sigma + 0.5)
        x = np.arange(n, dtype=np.float64) - (n // 2)
        vals = np.exp(-0.5 * (x / sigma) ** 2)
        vals[np.abs(x) > radius] = 0.0
        axes.append(vals)
    g = functools.reduce(np.multiply.outer, axes)
    g = g / g.max()
    if np.any(g > 0):
        g[g == 0] = g[g > 0].min()
    # the cache hands the same array to every caller: keep it read-only
    g = g.astype(dtype)
    g.flags.writeable = False
    return g
