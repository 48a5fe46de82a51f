"""Color palettes and conversions for segmentation labels.

Capability-parity with the reference color system
(ts2d/core/util/color.py:11-103): named palettes (via seaborn when present),
a deterministic default palette (6 named colors then seeded-random), and
conversions between names / float RGB / int RGB / hex.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

_DEFAULT_NAMED = [
    (255, 0, 0),      # red
    (0, 128, 0),      # green
    (0, 0, 255),      # blue
    (255, 255, 0),    # yellow
    (0, 255, 255),    # cyan
    (255, 0, 255),    # magenta
]

_CSS = {
    'red': (255, 0, 0), 'green': (0, 128, 0), 'blue': (0, 0, 255),
    'yellow': (255, 255, 0), 'cyan': (0, 255, 255), 'magenta': (255, 0, 255),
    'white': (255, 255, 255), 'black': (0, 0, 0), 'gray': (128, 128, 128),
    'orange': (255, 165, 0), 'purple': (128, 0, 128), 'brown': (165, 42, 42),
}

ColorLike = Union[str, int, Sequence]


def hex_to_rgb(value: str) -> tuple:
    v = value.strip().lstrip('#')
    if len(v) == 3:
        v = ''.join(c * 2 for c in v)
    if len(v) != 6:
        raise ValueError(f'Invalid hex color: {value!r}')
    return tuple(int(v[i:i + 2], 16) for i in (0, 2, 4))


def rgb_to_hex(rgb: Sequence[int]) -> str:
    r, g, b = (int(c) for c in rgb)
    return f'#{r:02x}{g:02x}{b:02x}'


def _random_color(seed: int) -> tuple:
    rnd = random.Random(seed)
    return tuple(rnd.randint(32, 200) for _ in range(3))


def default_color(index: int) -> tuple:
    """Deterministic color for a label index: fixed primaries first, then
    seeded-random colors so palettes are reproducible across runs."""
    assert index >= 0
    if index < len(_DEFAULT_NAMED):
        return _DEFAULT_NAMED[index]
    return _random_color(index)


def default_palette(size: Optional[int] = None) -> List[tuple]:
    size = len(_DEFAULT_NAMED) if size is None else size
    return [default_color(i) for i in range(size)]


def named_palette(name: Optional[str] = None, size: Optional[int] = None,
                  desat=None) -> List[tuple]:
    """A named seaborn palette as uint8 RGB tuples; falls back to the
    deterministic default palette for None/'ts2d'/'default' or when seaborn
    is unavailable."""
    if name is None or name in ('ts2d', 'default'):
        return default_palette(size)
    try:
        import seaborn as sns
    except ImportError:
        return default_palette(size)
    pal = sns.color_palette(name, size, desat)
    return [tuple(int(round(min(max(c, 0.0), 1.0) * 255)) for c in v) for v in pal]


def to_color(v: ColorLike) -> tuple:
    """Normalize any color-ish value to a uint8 RGB tuple."""
    if isinstance(v, str):
        s = v.strip().lower()
        if s.startswith('#'):
            return hex_to_rgb(s)
        if s in _CSS:
            return _CSS[s]
        try:
            from matplotlib import colors as mcolors
            return tuple_to_color(mcolors.to_rgb(s))
        except Exception as ex:
            raise ValueError(f'Unknown color name: {v!r}') from ex
    if np.isscalar(v):
        if isinstance(v, (int, np.integer)):
            return default_color(int(v))
        v = (float(v),) * 3
    return tuple_to_color(v)


def tuple_to_color(v: Sequence) -> tuple:
    vals = tuple(v)
    if len(vals) != 3:
        raise ValueError(f'Color tuples must have length 3, got {len(vals)}')
    if any(not isinstance(c, (int, np.integer)) for c in vals):
        return tuple(int(round(min(max(float(c), 0.0), 1.0) * 255)) for c in vals)
    return tuple(int(min(max(int(c), 0), 255)) for c in vals)


def to_color_str_rgb_floats(v: ColorLike, sep: str = ', ', precision: int = 3) -> str:
    """Format a color as float triple string, e.g. '0.5 0.25 1.0' — the
    3D-Slicer Segment metadata color convention."""
    rgb = to_color(v)
    parts = []
    for c in rgb:
        f = min(max(c / 255.0, 0.0), 1.0)
        s = f'{f:.{precision}f}'.rstrip('0').rstrip('.')
        parts.append(s if s else '0')
    return sep.join(parts)


def color_str_to_rgb(s: str) -> tuple:
    """Inverse of :func:`to_color_str_rgb_floats`."""
    return tuple_to_color(tuple(float(c) for c in s.replace(',', ' ').split()))


def to_palette(v: Union[Dict[int, ColorLike], Sequence[ColorLike]]) -> List[list]:
    """Dense palette (RGB triples indexed by label value) from a sparse
    {label: color} dict or a color list. Index 0 (background) is white, so
    visuals render on a white canvas; labels without a color get the
    default palette's."""
    if isinstance(v, dict):
        if any((not isinstance(k, (int, np.integer))) or k < 0 for k in v):
            raise ValueError('Dict palettes need non-negative integer keys')
        lim = max(v.keys()) if v else 0
        res = [[255, 255, 255]]
        for idx in range(1, lim + 1):
            c = v.get(idx)
            res.append(list(to_color(c) if c is not None else default_color(idx)))
        return res
    return [list(to_color(c)) for c in v]
