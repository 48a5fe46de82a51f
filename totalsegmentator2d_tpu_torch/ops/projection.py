"""Intensity projections on the host (numpy): the MIP/AIP front end.

Mode set as in the reference tool: first / max|mip / min / avg|mean /
median / std / depth / multiclass / slice[:pos] ('xr' is rejected).

Geometry: the projected axis keeps size 1 and absorbs the full physical
extent (out_spacing[axis] = in_spacing[axis] * in_size[axis]), as ITK's
ProjectionImageFilter produces; the origin stays the input's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

from ..io.image import MedicalImage
from ..utils.params import parse_float
from .geometry import axis_name_to_index


def project_array_np(arr: np.ndarray, mode: str, axis: int) -> np.ndarray:
    """Project ``arr`` along ``axis`` (kept as size 1)."""
    mode = str(mode).lower().strip()
    if mode in ('max', 'mip'):
        return np.expand_dims(np.max(arr, axis=axis), axis)
    if mode == 'min':
        return np.expand_dims(np.min(arr, axis=axis), axis)
    if mode in ('avg', 'mean'):
        # double accumulation: exact for integer CTs, and the same values
        # as the reference package's int64-sum mean
        return np.expand_dims(
            np.mean(arr, axis=axis, dtype=np.float64).astype(np.float32), axis)
    if mode == 'median':
        return np.expand_dims(
            np.median(arr.astype(np.float32), axis=axis), axis).astype(np.float32)
    if mode == 'std':
        return np.expand_dims(
            np.std(arr.astype(np.float32), axis=axis, ddof=1), axis).astype(np.float32)
    if mode in ('first', 'depth'):
        idx = np.argmax(arr != 0, axis=axis, keepdims=True)
        return np.take_along_axis(arr, idx, axis=axis)
    if mode == 'xr':
        raise NotImplementedError(
            'Synthetic XR projection from 3D images is not supported.')
    raise ValueError(f'Unsupported projection mode: {mode}')


def project_multi(img: MedicalImage, modes: Sequence[str],
                  axis: Union[int, str] = -1) -> List[MedicalImage]:
    """:func:`project` for several modes at once, float32 outputs: the
    channel projections of the fused-ensemble path."""
    return [project(img, mode=m, axis=axis).astype(np.float32) for m in modes]


def project(img: MedicalImage, mode: str = 'max',
            axis: Union[int, str] = -1) -> MedicalImage:
    """Project a MedicalImage along an axis (name or ITK-order index)."""
    itk_axis = axis_name_to_index(axis) if isinstance(axis, str) else \
        list(range(img.dim))[axis]
    mode = str(mode).lower().strip()
    mode, *param = f'{mode}:'.split(':')[:-1]

    if mode == 'slice':
        return extract_slice_factor(img, pos=_slice_pos(param[0]), axis=itk_axis)
    if mode == 'multiclass':
        return _project_multiclass(img, num=int(param[0]) if param else None,
                                   axis=itk_axis)
    np_axis = img.dim - 1 - itk_axis  # channel tail (if any) is after spatial
    return _projected_image(img, project_array_np(img.array, mode, np_axis),
                            itk_axis)


def _projected_image(img: MedicalImage, arr: np.ndarray, itk_axis: int,
                     is_vector: Optional[bool] = None) -> MedicalImage:
    spacing = list(img.spacing)
    spacing[itk_axis] = spacing[itk_axis] * img.size[itk_axis]
    return img.replace(array=arr, spacing=tuple(spacing),
                       is_vector=img.is_vector if is_vector is None else is_vector)


def _slice_pos(pos: str) -> float:
    factor = parse_float(pos, err=None)
    if factor is None:
        factor = {'first': 0.0, 'middle': 0.5, 'last': 1.0}.get(pos)
    if factor is None:
        raise ValueError(f'Invalid slice position: {pos}')
    return factor


def extract_slice_index(img: MedicalImage, index: int, axis: int = -1) -> MedicalImage:
    """Extract one slice, keeping the axis at size 1."""
    dim = img.dim
    axis = list(range(dim))[axis]
    n = img.size[axis]
    if not (0 <= index < n):
        raise ValueError(f'Slice index outside the available range: [0, {n - 1}]')
    arr = np.take(img.array, [index], axis=dim - 1 - axis)
    step = np.zeros(dim)
    step[axis] = index
    return img.replace(array=arr, origin=tuple(img.index_to_physical(step)))


def extract_slice_factor(img: MedicalImage, pos: float, axis: int = -1) -> MedicalImage:
    n = img.size[list(range(img.dim))[axis]]
    index = int(np.clip(np.round(n * pos), 0, n - 1))
    return extract_slice_index(img, index=index, axis=axis)


def _project_multiclass(img: MedicalImage, num: Optional[int], axis: int) -> MedicalImage:
    """One-hot binary projection of a label volume: channel k marks where
    label k+1 occurs anywhere along the axis."""
    np_axis = img.dim - 1 - axis
    if img.ncomponents == 1:
        if num is None:
            raise ValueError('multiclass projection needs a channel count, '
                             "use mode 'multiclass:<num>'")
        labels = np.arange(1, num + 1)
        onehot = (img.array[..., None] == labels).any(axis=np_axis, keepdims=True)
        return _projected_image(img, onehot.astype(np.uint8), axis, is_vector=True)
    # already multichannel: max-project each channel
    return _projected_image(img, np.max(img.array, axis=np_axis, keepdims=True), axis)
