"""Pure-Python NIfTI-1 reader/writer (.nii / .nii.gz).

Covers scalar 2D/3D volumes plus 5th-dimension vector images; geometry comes
from the sform when present, else the qform quaternion, else pixdim scaling.
NIfTI world coordinates are RAS+; they are converted to the package's LPS
frame on read (and back on write), which is what ITK does internally.
``.nii.gz`` payloads go through the native host library (io/native.py).

The reference tool read NIfTI through SimpleITK with a nibabel fallback for
non-orthonormal direction matrices (reference image.py:196-238); this reader
accepts non-orthonormal affines natively, so no fallback path is needed.
"""

from __future__ import annotations

import struct

import numpy as np

from .image import MedicalImage, reader_guard
from . import native as _native

_DT = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64, 1280: np.uint64,
}
_DT_INV = {np.dtype(v): k for k, v in _DT.items()}

_RAS_TO_LPS = np.diag([-1.0, -1.0, 1.0, 1.0])


def _quaternion_affine(hdr: dict) -> np.ndarray:
    b, c, d = hdr['quatern_b'], hdr['quatern_c'], hdr['quatern_d']
    a2 = max(0.0, 1.0 - (b * b + c * c + d * d))
    a = np.sqrt(a2)
    R = np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
    ])
    qfac = hdr['pixdim'][0]
    qfac = 1.0 if qfac >= 0 else -1.0
    S = np.diag([hdr['pixdim'][1], hdr['pixdim'][2], hdr['pixdim'][3] * qfac])
    aff = np.eye(4)
    aff[:3, :3] = R @ S
    aff[:3, 3] = [hdr['qoffset_x'], hdr['qoffset_y'], hdr['qoffset_z']]
    return aff


def _parse_header(buf: bytes) -> dict:
    if len(buf) < 348:
        raise ValueError('Truncated NIfTI header')
    for endian in ('<', '>'):
        sizeof_hdr = struct.unpack(endian + 'i', buf[0:4])[0]
        if sizeof_hdr == 348:
            break
    else:
        raise ValueError('Not a NIfTI-1 file (bad sizeof_hdr)')
    hdr = {'endian': endian}
    hdr['dim'] = struct.unpack(endian + '8h', buf[40:56])
    hdr['datatype'] = struct.unpack(endian + 'h', buf[70:72])[0]
    hdr['bitpix'] = struct.unpack(endian + 'h', buf[72:74])[0]
    hdr['pixdim'] = struct.unpack(endian + '8f', buf[76:108])
    hdr['vox_offset'] = struct.unpack(endian + 'f', buf[108:112])[0]
    hdr['scl_slope'] = struct.unpack(endian + 'f', buf[112:116])[0]
    hdr['scl_inter'] = struct.unpack(endian + 'f', buf[116:120])[0]
    hdr['qform_code'] = struct.unpack(endian + 'h', buf[252:254])[0]
    hdr['sform_code'] = struct.unpack(endian + 'h', buf[254:256])[0]
    (hdr['quatern_b'], hdr['quatern_c'], hdr['quatern_d'],
     hdr['qoffset_x'], hdr['qoffset_y'], hdr['qoffset_z']) = \
        struct.unpack(endian + '6f', buf[256:280])
    hdr['srow'] = np.array(struct.unpack(endian + '12f', buf[280:328])).reshape(3, 4)
    hdr['magic'] = buf[344:348]
    return hdr


@reader_guard('NIfTI')
def read(path: str) -> MedicalImage:
    with open(path, 'rb') as f:
        raw = f.read()
    if raw[:2] == b'\x1f\x8b':
        raw = _native.gzip_decompress(raw)
    hdr = _parse_header(raw)

    ndim = hdr['dim'][0]
    sizes = [max(1, int(s)) for s in hdr['dim'][1:1 + max(ndim, 3)]]
    dtype = np.dtype(_DT[hdr['datatype']])
    if hdr['endian'] == '>':
        dtype = dtype.newbyteorder('>')

    # vector images use dim[5]; time series (dim[4]) are not supported
    ncomp = int(hdr['dim'][5]) if ndim >= 5 else 1
    if ndim >= 4 and int(hdr['dim'][4]) > 1:
        raise ValueError('NIfTI time series are not supported')

    spatial = sizes[:min(ndim, 3)]
    # NIfTI vector images always carry 3 spatial dims (dim[0]=5); collapse a
    # size-1 trailing axis so 2D vector images round-trip as 2D
    if ncomp > 1 and len(spatial) == 3 and spatial[2] == 1:
        spatial = spatial[:2]
    count = int(np.prod(spatial)) * ncomp
    off = int(hdr['vox_offset'])
    flat = np.frombuffer(raw, dtype=dtype, count=count, offset=off)
    if hdr['endian'] == '>':
        flat = flat.astype(dtype.newbyteorder('<'))

    slope, inter = hdr['scl_slope'], hdr['scl_inter']
    # NaN means 'unset' (nibabel/ITK convention)
    slope = 1.0 if (np.isnan(slope) or slope == 0.0) else slope
    inter = 0.0 if np.isnan(inter) else inter
    if slope != 1.0 or inter != 0.0:
        flat = flat.astype(np.float32) * slope + inter

    # x fastest on disk; component dim is slowest (dim 5) -> move last
    arr = flat.reshape(([ncomp] if ncomp > 1 else []) + spatial[::-1])
    if ncomp > 1:
        arr = np.moveaxis(arr, 0, -1)

    sdim = len(spatial)
    if hdr['sform_code'] > 0:
        aff = np.eye(4)
        aff[:3, :] = hdr['srow']
    elif hdr['qform_code'] > 0:
        aff = _quaternion_affine(hdr)
    else:
        aff = np.diag([hdr['pixdim'][1] or 1, hdr['pixdim'][2] or 1,
                       (hdr['pixdim'][3] or 1) if sdim > 2 else 1, 1])
    aff = _RAS_TO_LPS @ aff  # to LPS

    if sdim == 2:
        M3 = aff[:3, :2]
        spacing = np.linalg.norm(M3, axis=0)[:2]
        direction = (M3 / np.where(spacing == 0, 1, spacing))[:2, :2]
        origin = aff[:2, 3]
    else:
        spacing = np.linalg.norm(aff[:3, :3], axis=0)
        spacing = np.where(spacing == 0, 1.0, spacing)
        direction = aff[:3, :3] / spacing
        origin = aff[:3, 3]

    return MedicalImage(array=np.ascontiguousarray(arr),
                        spacing=tuple(float(s) for s in spacing),
                        origin=tuple(float(o) for o in origin),
                        direction=direction,
                        is_vector=ncomp > 1)


def write(img: MedicalImage, path: str, compress: bool = None) -> None:
    if compress is None:
        compress = path.endswith('.gz')
    arr = np.ascontiguousarray(img.array)
    if arr.dtype == np.bool_:
        arr = arr.astype(np.uint8)
    dtype = arr.dtype
    if dtype not in _DT_INV:
        raise ValueError(f'Unsupported dtype for NIfTI export: {dtype}')

    sdim = img.dim
    ncomp = img.ncomponents
    spatial = list(img.size)  # (x, y, z)

    # LPS geometry -> RAS affine
    aff = np.eye(4)
    D = np.eye(3)
    D[:sdim, :sdim] = img.direction
    sp = list(img.spacing) + [1.0] * (3 - sdim)
    aff[:3, :3] = D @ np.diag(sp)
    orig = list(img.origin) + [0.0] * (3 - sdim)
    aff[:3, 3] = orig
    aff = _RAS_TO_LPS @ aff

    ndim = 5 if ncomp > 1 else sdim
    dim = [1] * 8
    dim[0] = ndim
    for i, s in enumerate(spatial):
        dim[1 + i] = s
    if ncomp > 1:
        dim[5] = ncomp

    pixdim = [1.0] * 8
    for i, s in enumerate(img.spacing):
        pixdim[1 + i] = float(s)

    hdr = bytearray(348)
    struct.pack_into('<i', hdr, 0, 348)
    struct.pack_into('<8h', hdr, 40, *dim)
    struct.pack_into('<h', hdr, 70, _DT_INV[dtype])
    struct.pack_into('<h', hdr, 72, dtype.itemsize * 8)
    struct.pack_into('<8f', hdr, 76, *pixdim)
    struct.pack_into('<f', hdr, 108, 352.0)   # vox_offset
    struct.pack_into('<f', hdr, 112, 1.0)     # scl_slope
    struct.pack_into('<f', hdr, 116, 0.0)     # scl_inter
    struct.pack_into('<h', hdr, 252, 0)       # qform_code
    struct.pack_into('<h', hdr, 254, 2)       # sform_code = aligned
    struct.pack_into('<6f', hdr, 256, 0, 0, 0, *aff[:3, 3])
    struct.pack_into('<12f', hdr, 280, *aff[:3, :].reshape(-1))
    hdr[344:348] = b'n+1\x00'

    if ncomp > 1:
        arr = np.moveaxis(arr, -1, 0)  # component slowest on disk

    body = bytes(hdr) + b'\x00' * 4 + arr.tobytes()
    if compress:
        body = _native.gzip_compress(body, level=1)
    with open(path, 'wb') as f:
        f.write(body)
