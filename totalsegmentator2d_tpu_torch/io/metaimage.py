"""MetaImage (.mha/.mhd) reader/writer.

MetaImage stores geometry in the LPS frame already (ITK-native), so no frame
conversion is needed. Compressed payloads use zlib, through the native host
library (io/native.py). Detached .mhd headers reference a sibling .raw/.zraw
data file, inside the header's directory.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .image import MedicalImage, reader_guard, resolve_datafile
from . import native as _native

_MET_TYPES = {
    'MET_CHAR': np.int8, 'MET_UCHAR': np.uint8,
    'MET_SHORT': np.int16, 'MET_USHORT': np.uint16,
    'MET_INT': np.int32, 'MET_UINT': np.uint32,
    'MET_LONG_LONG': np.int64, 'MET_ULONG_LONG': np.uint64,
    'MET_FLOAT': np.float32, 'MET_DOUBLE': np.float64,
}
_MET_INV = {np.dtype(v): k for k, v in _MET_TYPES.items()}


@reader_guard('MetaImage')
def read(path: str) -> MedicalImage:
    header: Dict[str, str] = {}
    with open(path, 'rb') as f:
        payload_start = None
        while True:
            line = f.readline()
            if not line:
                break
            text = line.decode('utf-8', errors='replace').strip()
            if '=' not in text:
                continue
            k, v = (s.strip() for s in text.split('=', 1))
            header[k] = v
            if k == 'ElementDataFile':
                payload_start = f.tell()
                break
        if payload_start is None:
            raise ValueError('MetaImage header has no ElementDataFile')

        ndims = int(header['NDims'])
        sizes = [int(s) for s in header['DimSize'].split()]
        ncomp = int(header.get('ElementNumberOfChannels', 1))
        dtype = np.dtype(_MET_TYPES[header['ElementType']])
        msb = header.get('BinaryDataByteOrderMSB', 'False').lower() == 'true'
        compressed = header.get('CompressedData', 'False').lower() == 'true'

        datafile = header['ElementDataFile']
        if datafile.upper() == 'LOCAL':
            raw = f.read()
        else:
            dpath = resolve_datafile(path, datafile, 'MetaImage')
            try:
                with open(dpath, 'rb') as df:
                    raw = df.read()
            except OSError as ex:
                # the reference comes from the (untrusted) header, not
                # the caller: surface per the io error contract
                raise ValueError(
                    f'MetaImage data file not readable: {datafile!r} '
                    f'({ex})') from ex

    if compressed:
        if 'CompressedDataSize' in header:
            # the stream's length; bytes after it are not the image's
            size = int(header['CompressedDataSize'])
            if not 0 < size <= len(raw):
                raise ValueError(f'MetaImage CompressedDataSize {size} does '
                                 f'not fit the {len(raw)} data bytes')
            raw = raw[:size]
    count = int(np.prod(sizes)) * ncomp
    if compressed:
        raw = _native.gzip_decompress(raw, size=count * dtype.itemsize)
    flat = np.frombuffer(raw, dtype=dtype, count=count)
    if msb and dtype.itemsize > 1:
        flat = flat.view(dtype.newbyteorder('>')).astype(dtype)

    # MetaImage payload: component fastest, then x, y, z
    shape = sizes[::-1] + ([ncomp] if ncomp > 1 else [])
    arr = flat.reshape(shape)

    spacing = [float(s) for s in header.get(
        'ElementSpacing', ' '.join(['1'] * ndims)).split()]
    origin = [float(s) for s in header.get(
        'Offset', header.get('Position', ' '.join(['0'] * ndims))).split()]
    tm = header.get('TransformMatrix')
    if tm:
        # row-major ITK direction
        direction = np.array([float(v) for v in tm.split()]).reshape(ndims, ndims)
    else:
        direction = np.eye(ndims)

    return MedicalImage(array=np.ascontiguousarray(arr), spacing=tuple(spacing),
                        origin=tuple(origin), direction=direction,
                        is_vector=ncomp > 1)


def write(img: MedicalImage, path: str, compress: bool = True) -> None:
    arr = np.ascontiguousarray(img.array)
    if arr.dtype == np.bool_:
        arr = arr.astype(np.uint8)
    if arr.dtype.byteorder == '>':
        arr = arr.astype(arr.dtype.newbyteorder('<'))
    dtype = arr.dtype
    if dtype not in _MET_INV:
        raise ValueError(f'Unsupported dtype for MetaImage export: {dtype}')

    payload = arr.tobytes()
    if compress:
        payload = _native.zlib_compress(payload, level=1)

    detached = path.endswith('.mhd')
    lines = [
        'ObjectType = Image',
        f'NDims = {img.dim}',
        'BinaryData = True',
        'BinaryDataByteOrderMSB = False',
        f'CompressedData = {compress}',
    ]
    if compress:
        lines.append(f'CompressedDataSize = {len(payload)}')
    lines += [
        'TransformMatrix = ' + ' '.join(repr(float(v)) for v in img.direction.reshape(-1)),
        'Offset = ' + ' '.join(repr(float(v)) for v in img.origin),
        'ElementSpacing = ' + ' '.join(repr(float(v)) for v in img.spacing),
        'DimSize = ' + ' '.join(str(s) for s in img.size),
    ]
    if img.ncomponents > 1:
        lines.append(f'ElementNumberOfChannels = {img.ncomponents}')
    lines.append(f'ElementType = {_MET_INV[dtype]}')

    if detached:
        dfn = os.path.basename(path)[:-4] + ('.zraw' if compress else '.raw')
        lines.append(f'ElementDataFile = {dfn}')
        with open(path, 'w') as f:
            f.write('\n'.join(lines) + '\n')
        with open(os.path.join(os.path.dirname(path), dfn), 'wb') as f:
            f.write(payload)
    else:
        lines.append('ElementDataFile = LOCAL')
        with open(path, 'wb') as f:
            f.write(('\n'.join(lines) + '\n').encode('utf-8'))
            f.write(payload)
