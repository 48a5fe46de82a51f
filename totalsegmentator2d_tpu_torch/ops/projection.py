"""Intensity projections: the MIP/AIP front end, on the host (numpy) or on
the device (torch).

Mode set as in the reference tool: first / max|mip / min / avg|mean /
median / std / depth / multiclass / slice[:pos] ('xr' is rejected).
The mean of an integer volume is exact on both: a 64-bit integer sum
divided in float64, then rounded to float32, so the device projection of
an int16 CT equals the host one bit for bit. On the host, the MAX and MEAN
of an int16 (Z, Y, X) volume along Y run in one native pass, threaded over
z slabs (io/native.project_max_mean, the same values as numpy's).

Geometry: the projected axis keeps size 1 and absorbs the full physical
extent (out_spacing[axis] = in_spacing[axis] * in_size[axis]), as ITK's
ProjectionImageFilter produces; the origin stays the input's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

import torch

from ..io.image import MedicalImage
from ..io.native import project_max_mean
from ..utils.device import resolve_device
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
        if arr.ndim == 3 and axis == 1 and arr.dtype == np.int16:
            res = project_max_mean(np.ascontiguousarray(arr))
            if res is not None:
                return np.expand_dims(res[1], 1)
        # double accumulation: exact for integer CTs, and the same values
        # as the native pass and the reference package's int64-sum mean
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


def project_array(arr: torch.Tensor, mode: str, axis: int) -> torch.Tensor:
    """:func:`project_array_np` on a tensor, on its device (kept as size 1
    along ``axis``): max/min/first keep the dtype, mean is float32 (exact
    for integer volumes), median and std (ddof 1) are float32."""
    mode = str(mode).lower().strip()
    if mode in ('max', 'mip'):
        return torch.amax(arr, dim=axis, keepdim=True)
    if mode == 'min':
        return torch.amin(arr, dim=axis, keepdim=True)
    if mode in ('avg', 'mean'):
        if arr.dtype.is_floating_point:
            total = torch.sum(arr, dim=axis, keepdim=True, dtype=torch.float64)
        else:
            total = torch.sum(arr, dim=axis, keepdim=True,
                              dtype=torch.int64).double()
        return (total / arr.shape[axis]).float()
    if mode == 'median':
        # numpy's median: the mean of the two middle values for an even count
        s = torch.sort(arr.float(), dim=axis).values
        n = arr.shape[axis]
        hi = s.narrow(axis, n // 2, 1)
        return hi if n % 2 else (s.narrow(axis, n // 2 - 1, 1) + hi) / 2
    if mode == 'std':
        return torch.std(arr.float(), dim=axis, keepdim=True, correction=1)
    if mode in ('first', 'depth'):
        idx = torch.argmax((arr != 0).to(torch.uint8), dim=axis, keepdim=True)
        return torch.take_along_dim(arr, idx, dim=axis)
    if mode == 'xr':
        raise NotImplementedError(
            'Synthetic XR projection from 3D images is not supported.')
    raise ValueError(f'Unsupported projection mode: {mode}')


def project_arrays_np(arr: np.ndarray, modes: Sequence[str],
                      axis: int) -> List[np.ndarray]:
    """Several projection modes of one volume. MAX and MEAN of an int16
    (Z, Y, X) volume along axis 1 come from one native pass, float32 (the
    engine takes float32 either way); other sets go mode by mode through
    :func:`project_array_np`, with its dtypes."""
    modes_l = [str(m).lower().strip() for m in modes]
    if (axis == 1 and arr.ndim == 3 and arr.dtype == np.int16
            and len(modes_l) > 1
            and set(modes_l) <= {'max', 'mip', 'avg', 'mean'}):
        res = project_max_mean(np.ascontiguousarray(arr))
        if res is not None:
            mx, mn = res
            by = {'max': mx, 'mip': mx, 'avg': mn, 'mean': mn}
            return [np.expand_dims(by[m], 1) for m in modes_l]
    return [project_array_np(arr, m, axis) for m in modes_l]


def project_multi(img: MedicalImage, modes: Sequence[str],
                  axis: Union[int, str] = -1) -> List[MedicalImage]:
    """:func:`project` for several modes at once, float32 outputs: the
    channel projections of the fused-ensemble path, in one native pass
    where it applies. Modes outside the plain reductions (``slice:``,
    ``multiclass:``, median, std, ...) go through :func:`project` one by
    one."""
    modes_l = [str(m).lower().strip() for m in modes]
    if not set(modes_l) <= {'max', 'mip', 'min', 'avg', 'mean'}:
        return [project(img, mode=m, axis=axis).astype(np.float32)
                for m in modes_l]
    itk_axis = axis_name_to_index(axis) if isinstance(axis, str) else \
        list(range(img.dim))[axis]
    outs = project_arrays_np(img.array, modes_l, img.dim - 1 - itk_axis)
    return [_projected_image(img, np.asarray(o, np.float32), itk_axis)
            for o in outs]


def project(img: MedicalImage, mode: str = 'max',
            axis: Union[int, str] = -1, backend: str = 'host',
            device=None) -> MedicalImage:
    """Project a MedicalImage along an axis (name or ITK-order index).

    :param backend: 'host' (numpy) or 'device' (upload, then
        :func:`project_array` on ``device``: None = the CUDA card, 'cpu'
        when asked); the same values either way"""
    if backend not in ('host', 'device'):
        raise ValueError(f"backend must be 'host' or 'device', got {backend!r}")
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
    if backend == 'host':
        out = project_array_np(img.array, mode, np_axis)
    else:
        dev = torch.from_numpy(np.ascontiguousarray(img.array)).to(
            resolve_device(device))
        out = project_array(dev, mode, np_axis).cpu().numpy()
    return _projected_image(img, out, itk_axis)


def make_projected_image(img: MedicalImage, arr: np.ndarray, itk_axis: int,
                         is_vector: Optional[bool] = None) -> MedicalImage:
    """Wrap an already projected array (size 1 along ``itk_axis``) in the
    geometry :func:`project` gives, for a projection computed inside a
    device program."""
    return _projected_image(img, arr, itk_axis, is_vector)


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


def flatten_vector_max(img: MedicalImage, index: bool = False) -> MedicalImage:
    """Collapse a vector image to one channel: the per-voxel max over its
    components, or (``index=True``) the 1-based index of the last nonzero
    component, 0 where all are zero (reference image.py:266-290)."""
    if img.ncomponents <= 1:
        return img
    arr = img.array
    if index:
        comp = np.arange(1, arr.shape[-1] + 1)
        out = np.max(np.where(arr != 0, comp, 0), axis=-1).astype(np.int64)
    else:
        out = np.max(arr, axis=-1)
    return img.replace(array=out, is_vector=False)
