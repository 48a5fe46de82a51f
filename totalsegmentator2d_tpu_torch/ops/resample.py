"""Resampling as separable matmuls.

Interpolation along each axis is a dense (n_out, n_in) weight matrix built
on the host (:func:`axis_weights`) and applied by ``torch.matmul``
(:func:`apply_separable`). Cubic interpolation is true B-spline
interpolation (scipy order=3 semantics): the samples first pass through the
B-spline prefilter (:func:`bspline_prefilter`, the CUDA kernel in
ops/cuda/prefilter.py) to become coefficients.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .cuda.prefilter import prefilter_axis


def bspline_prefilter(arr: torch.Tensor, axes: Sequence[int]) -> torch.Tensor:
    """Cubic B-spline prefilter (mirror boundary) along each of ``axes``."""
    for ax in axes:
        arr = prefilter_axis(arr, ax)
    return arr


def _bspline3_kernel(t: np.ndarray) -> np.ndarray:
    at = np.abs(t)
    return np.where(
        at < 1.0, 2.0 / 3.0 - at * at + 0.5 * at ** 3,
        np.where(at < 2.0, ((2.0 - at) ** 3) / 6.0, 0.0))


def _mirror_index(idx: np.ndarray, n: int) -> np.ndarray:
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * n - 2
    return np.abs(((idx % period) + period) % period - (n - 1)) * -1 + (n - 1)


def axis_weights(n_in: int, coords: np.ndarray, order: int,
                 outside: str = 'zero') -> np.ndarray:
    """Dense (n_out, n_in) interpolation matrix for sample positions
    ``coords`` (continuous input indices).

    order: 0 nearest (ITK RoundHalfIntegerUp), 1 linear, 3 cubic B-spline
    (apply to *prefiltered* coefficients).
    outside: 'zero' masks positions outside [-0.5, n_in-0.5) to 0 (ITK
    default-value semantics); 'edge' clamps coordinates (skimage mode=edge).
    """
    coords = np.asarray(coords, dtype=np.float64)
    n_out = coords.shape[0]
    inside = (coords >= -0.5) & (coords <= n_in - 0.5)
    if outside == 'edge':
        coords = np.clip(coords, 0.0, n_in - 1.0)
        inside = np.ones_like(inside)

    W = np.zeros((n_out, n_in), dtype=np.float64)
    if order == 0:
        idx = np.floor(coords + 0.5).astype(int)
        idx = np.clip(idx, 0, n_in - 1)
        W[np.arange(n_out), idx] = 1.0
    elif order == 1:
        base = np.floor(coords).astype(int)
        frac = coords - base
        for off, w in ((0, 1.0 - frac), (1, frac)):
            idx = _mirror_index(base + off, n_in)
            np.add.at(W, (np.arange(n_out), idx), w)
    elif order == 3:
        base = np.floor(coords).astype(int)
        for off in range(-1, 3):
            idx = base + off
            w = _bspline3_kernel(coords - idx)
            idx = _mirror_index(idx, n_in)
            np.add.at(W, (np.arange(n_out), idx), w)
    else:
        raise ValueError(f'Unsupported interpolation order: {order}')
    W *= inside[:, None]
    return W


def apply_separable(arr: torch.Tensor,
                    weights: Sequence[Optional[torch.Tensor]],
                    axes: Sequence[int]) -> torch.Tensor:
    """Apply per-axis (n_out, n_in) weight matrices by matmul;
    ``weights[k]`` may be None (axis untouched). Callers run this under
    :func:`~..utils.device.exact_numerics`: interpolation weights are
    numerically sensitive, so the matmuls stay full fp32 (no TF32)."""
    for W, ax in zip(weights, axes):
        if W is None:
            continue
        out = torch.matmul(torch.movedim(arr, ax, -1), W.T)
        arr = torch.movedim(out, -1, ax)
    return arr
