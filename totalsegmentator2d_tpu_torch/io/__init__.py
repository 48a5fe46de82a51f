"""Host-side medical image IO: NRRD (``.nrrd``, ``.seg.nrrd``, ``.nhdr``),
NIfTI (``.nii``, ``.nii.gz``) and MetaImage (``.mha``, ``.mhd``) read and
write, DICOM read (a directory of slice files or one ``.dcm`` / ``.dicom``
/ ``.ima`` file, io/dicom.py, and a ``.zip`` holding one series), raster
inputs (``.png``, ``.bmp``, ``.tif``, ``.tiff``, the package's own decoders
in io/raster.py) and PNG export for visuals (the package's own encoder).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from .image import (MedicalImage, image_from_array, is_label_dtype,  # noqa: F401
                    is_label_image)
from . import dicom, metaimage, nifti, nrrd, raster

SUPPORTED_EXTENSIONS = ('nrrd', 'nhdr', 'nii', 'nii.gz', 'mha', 'mhd')

#: the declared decompressed size a zipped series may have: far above any
#: real series, far below a zip bomb
ZIP_MAX_TOTAL_BYTES = 8 << 30


def _ext(path: str) -> str:
    base = os.path.basename(path).lower()
    if base.endswith('.nii.gz'):
        return 'nii.gz'
    return base.rsplit('.', 1)[-1] if '.' in base else ''


def read_image(path: str) -> MedicalImage:
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    ext = _ext(path)
    if os.path.isdir(path) or '.' + ext in dicom.DICOM_EXTENSIONS:
        # a directory is a DICOM slice series (one case); a file may be
        # multi-frame
        return dicom.read_dicom_series(path)
    if ext == 'zip':
        # a zipped DICOM slice series (one case): extracted with the CRC,
        # traversal and declared-size guards, then the series inside read
        import tempfile
        from ..inference.database import extract_zip
        with tempfile.TemporaryDirectory(prefix='ts2d-zip-') as tmp:
            extract_zip(path, tmp, max_total_bytes=ZIP_MAX_TOTAL_BYTES)
            return dicom.read_dicom_series(dicom.resolve_series_root(tmp))
    if ext in ('nrrd', 'nhdr'):
        return nrrd.read(path)
    if ext in ('nii', 'nii.gz'):
        return nifti.read(path)
    if ext in ('mha', 'mhd'):
        return metaimage.read(path)
    if ext in raster.RASTER_EXTENSIONS:
        # plain 2D rasters (the nnU-Net v2 2D extension set): unit spacing,
        # identity geometry
        return raster.read_raster(path)
    raise ValueError(f'Unsupported image format: {path}')


def write_image(img: MedicalImage, path: str, compress: bool = True) -> None:
    ext = _ext(path)
    if ext in ('nrrd', 'nhdr'):
        return nrrd.write(img, path, compress=compress)
    if ext in ('nii', 'nii.gz'):
        return nifti.write(img, path)
    if ext in ('mha', 'mhd'):
        return metaimage.write(img, path, compress=compress)
    if ext == 'png':
        return write_png(img, path)
    raise ValueError(f'Unsupported image format: {path}')


_PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack('>I', len(data)) + kind + data
            + struct.pack('>I', zlib.crc32(kind + data)))


def encode_png(arr: np.ndarray) -> bytes:
    """The PNG file of an (H, W) gray or (H, W, 3) RGB uint8 array: 8 bits
    per sample, no interlace, filter 0 (none) on every row, one zlib IDAT."""
    arr = np.ascontiguousarray(arr, np.uint8)
    if arr.ndim == 2:
        color = 0
    elif arr.ndim == 3 and arr.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f'PNG export takes gray or RGB, got shape {arr.shape}')
    h, w = arr.shape[:2]
    rows = arr.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack('>IIBBBBB', w, h, 8, color, 0, 0, 0)
    return (_PNG_SIGNATURE + _png_chunk(b'IHDR', ihdr)
            + _png_chunk(b'IDAT', zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b'IEND', b''))


def write_png(img: MedicalImage, path: str) -> None:
    """Export a 2D uint8 image (scalar or RGB) as PNG; a 3D image with a
    size-1 axis counts as 2D. Other dtypes are clipped to [0, 255]."""
    if img.dim != 2 and not (img.dim == 3 and 1 in img.size):
        raise ValueError(f'PNG export needs a 2D image, got size {img.size}')
    arr = np.asarray(img.array)
    spatial = arr.shape[:-1] if img.is_vector else arr.shape
    keep = [s for s in spatial if s > 1]
    keep = [1] * (2 - len(keep)) + keep if len(keep) < 2 else keep
    arr = arr.reshape(keep + ([arr.shape[-1]] if img.is_vector else []))
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    with open(path, 'wb') as f:
        f.write(encode_png(arr))
