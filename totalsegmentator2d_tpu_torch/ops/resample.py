"""Resampling as separable matmuls.

Interpolation along each axis is a dense (n_out, n_in) weight matrix built
on the host (:func:`axis_weights`) and applied by ``torch.matmul``
(:func:`apply_separable`). Cubic interpolation is true B-spline
interpolation (scipy order=3 semantics): the samples first pass through the
B-spline prefilter (:func:`bspline_prefilter`, the CUDA kernel in
ops/cuda/prefilter.py) to become coefficients. The device programs use
these pieces; :func:`resample` is the image-level resample (ITK
ResampleImageFilter semantics) of the visuals, and :func:`resize_to_shape`
the half-pixel resize of training's preprocessing (:func:`_resize` on
tensors, also augmentation's low-resolution transform), on the card unless
the caller names the CPU.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..io.image import MedicalImage, is_label_image
from ..utils.device import exact_numerics, resolve_device
from ..utils.logging import warn
from .cuda import prefilter as PF
from .cuda.prefilter import prefilter_axis


def bspline_prefilter(arr: torch.Tensor, axes: Sequence[int]) -> torch.Tensor:
    """Cubic B-spline prefilter (mirror boundary) along each of ``axes``."""
    for ax in axes:
        arr = prefilter_axis(arr, ax)
    return arr


def bspline_prefilter_1d(x: torch.Tensor, tol: float = 1e-10) -> torch.Tensor:
    """The cubic B-spline prefilter along the last axis (mirror boundary,
    float32), its causal init's series truncated where the pole's powers
    fall below ``tol``: scipy's ``spline_filter1d(order=3, mode='mirror')``
    as the reference computes it. The kernel on a CUDA tensor, whose
    causal init holds the default tol's 18 taps (another tol raises
    ValueError there); the plain version on the CPU."""
    taps = math.ceil(math.log(tol) / math.log(-PF.POLE))
    if x.device.type == 'cpu':
        return PF.bspline_prefilter_plain(x, -1, taps)
    if taps != PF.HORIZON:
        raise ValueError(f'the CUDA prefilter sums {PF.HORIZON} taps of the '
                         f'causal-init series, not {taps} (tol {tol})')
    return prefilter_axis(x, -1)


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


# ---------------------------------------------------------------------------
# array-level resize (the skimage / scipy zoom half-pixel convention)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _resize_weights(n_in: int, n_out: int, order: int, outside: str,
                    device: torch.device) -> torch.Tensor:
    """The (n_out, n_in) float32 weights of one resized axis, on the device:
    input position (i + 0.5) * n_in / n_out - 0.5 of output sample i."""
    coords = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    W = axis_weights(n_in, coords, order, outside).astype(np.float32)
    return torch.from_numpy(W).to(device)


def _resize(arr: torch.Tensor, shape: Tuple[int, ...], order: int,
            outside: str, axes: Tuple[int, ...]) -> torch.Tensor:
    """Resize ``arr`` along ``axes`` to ``shape`` on its device, in float32:
    order 3 prefilters only the axes that change size (the CUDA kernel on
    the card), then one full-fp32 matmul per changed axis (the reference's
    ``_resize_jit``)."""
    work = arr.float()
    if order == 3:
        work = bspline_prefilter(work, [ax for k, ax in enumerate(axes)
                                        if arr.shape[ax] != shape[k]])
    weights = [None if arr.shape[ax] == shape[k] else
               _resize_weights(int(arr.shape[ax]), int(shape[k]), int(order),
                               outside, work.device)
               for k, ax in enumerate(axes)]
    with exact_numerics():
        return apply_separable(work, weights, axes)


def resize_to_shape(arr: np.ndarray, shape: Sequence[int], order: int = 3,
                    outside: str = 'edge',
                    axes: Optional[Sequence[int]] = None,
                    device=None) -> np.ndarray:
    """skimage/zoom half-pixel resize (nnU-Net preprocessing semantics:
    ``resize(..., order=3, mode='edge', anti_aliasing=False)``), on
    ``device`` (None = the CUDA card, 'cpu' when asked); float32 out."""
    if axes is None:
        axes = tuple(range(len(shape)))
    device = resolve_device(device)
    with torch.inference_mode():
        x = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
        out = _resize(x, tuple(int(s) for s in shape), int(order), outside,
                      tuple(int(a) for a in axes))
        return out.cpu().numpy()


# ---------------------------------------------------------------------------
# MedicalImage-level resample (ITK ResampleImageFilter semantics)
# ---------------------------------------------------------------------------

def resample(img: MedicalImage,
             spacing: Union[float, Sequence[float]],
             labels: Optional[bool] = None,
             size: Optional[Sequence[Optional[int]]] = None,
             order: Optional[int] = None,
             center: Optional[Sequence[float]] = None,
             center_position: Optional[Sequence[float]] = None,
             device=None) -> MedicalImage:
    """Resample to a target spacing as the reference ``resample()``
    (image.py:293-372): output size ``int(0.5 + n*s_old/s_new)``, the
    centre kept, B-spline (order 3) for intensities and nearest neighbour
    for labels (uint8 forced to nearest), identity transform. The
    prefilter and the matmuls run on ``device`` (None = the CUDA card,
    'cpu' when asked) in full fp32; the weights are built on the host."""
    device = resolve_device(device)
    d = img.dim
    spacing_new = [float(spacing)] * d if np.isscalar(spacing) else \
        [float(s) for s in spacing]
    spacing_old = list(img.spacing)
    size_old = list(img.size)

    auto_size = [int(0.5 + size_old[i] * spacing_old[i] / spacing_new[i])
                 for i in range(d)]
    if size is None:
        size_new = auto_size
    else:
        size_new = [a if s is None else int(s) for s, a in zip(size, auto_size)]

    if center is not None and center_position is not None:
        raise ValueError('Either center or center_position may be specified - not both')
    if center_position is None:
        if center is None:
            center = np.multiply(size_old, 0.5)
        center_position = img.index_to_physical(np.asarray(center, dtype=int))

    # the new grid's origin puts its (integer) centre index on
    # center_position
    ref = MedicalImage(array=np.zeros(size_new[::-1], np.uint8),
                       spacing=tuple(spacing_new), origin=(0.0,) * d,
                       direction=img.direction.copy())
    c_idx = np.multiply(size_new, 0.5).astype(int)
    diff = ref.index_to_physical(c_idx) - np.zeros(d)
    origin_new = np.asarray(center_position, float) - diff

    if labels is None:
        labels = is_label_image(img)
    if order is None:
        order = 0 if labels else 3
    if img.array.dtype == np.uint8 and order != 0 and not labels:
        warn('uint8 images are resampled with nearest neighbor (label convention).')
        order = 0

    changed = (not np.allclose(spacing_new, spacing_old)
               or size_new != size_old
               or not np.allclose(origin_new, img.origin))
    if not changed:
        return img

    # per-axis affine map, output index -> input index (identity
    # transform, same direction), in the direction basis
    delta = np.linalg.inv(img.direction) @ (origin_new - np.asarray(img.origin))
    out = _resample_axes(img.array, d, size_old, size_new, spacing_old,
                         spacing_new, delta, int(order), device)

    out_dtype = np.uint8 if labels else img.array.dtype
    if np.issubdtype(out_dtype, np.integer):
        out = np.rint(out)
    return img.replace(array=out.astype(out_dtype), spacing=tuple(spacing_new),
                       origin=tuple(float(v) for v in origin_new))


def _resample_axes(array: np.ndarray, d: int, size_old, size_new,
                   spacing_old, spacing_new, delta, order: int,
                   device: torch.device) -> np.ndarray:
    """The separable resample of ``array`` (spatial axes first, channels
    last for a vector image): the prefilter along every axis of more than
    one sample at order 3, then one matmul per axis, in float32."""
    weights, axes = [], []
    for j in range(d):
        coords = (delta[j] + spacing_new[j] * np.arange(size_new[j])) / spacing_old[j]
        W = axis_weights(size_old[j], coords, order if size_old[j] > 1 else 0,
                         outside='zero')
        weights.append(torch.from_numpy(W.astype(np.float32)).to(device))
        axes.append(d - 1 - j)
    pre_axes = [d - 1 - j for j in range(d) if order == 3 and size_old[j] > 1]
    with torch.inference_mode(), exact_numerics():
        work = torch.from_numpy(np.ascontiguousarray(array, np.float32)).to(device)
        if pre_axes:
            work = bspline_prefilter(work, pre_axes)
        out = apply_separable(work, weights, axes)
        return out.cpu().numpy()


def resample_uniform(img: MedicalImage, **kwargs) -> MedicalImage:
    """Resample to isotropic spacing, the finest of the image's
    (reference image.py:374-380)."""
    return resample(img, min(img.spacing), **kwargs)
