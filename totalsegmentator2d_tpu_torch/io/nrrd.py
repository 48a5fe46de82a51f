"""Pure-Python NRRD reader/writer (no teem/ITK dependency).

Implements the subset of the NRRD4/5 format the TS2D pipeline uses
(reference relies on SimpleITK's NrrdImageIO): scalar and vector images,
raw/gzip/ascii encodings, `space`/`space dimension` geometry, key:=value
metadata. gzip payloads go through the native host library (io/native.py),
or Python's gzip/zlib where it cannot be had.

Format reference: https://teem.sourceforge.net/nrrd/format.html
"""

from __future__ import annotations

import io as _io
from typing import List, Optional, Tuple

import numpy as np

from . import native as _native
from .image import MedicalImage, reader_guard, resolve_datafile

_MAGIC = b'NRRD'

# nrrd type name -> numpy dtype (canonical subset + aliases)
_NRRD_TYPES = {
    'signed char': np.int8, 'int8': np.int8, 'int8_t': np.int8,
    'uchar': np.uint8, 'unsigned char': np.uint8, 'uint8': np.uint8, 'uint8_t': np.uint8,
    'short': np.int16, 'short int': np.int16, 'signed short': np.int16,
    'signed short int': np.int16, 'int16': np.int16, 'int16_t': np.int16,
    'ushort': np.uint16, 'unsigned short': np.uint16, 'unsigned short int': np.uint16,
    'uint16': np.uint16, 'uint16_t': np.uint16,
    'int': np.int32, 'signed int': np.int32, 'int32': np.int32, 'int32_t': np.int32,
    'uint': np.uint32, 'unsigned int': np.uint32, 'uint32': np.uint32, 'uint32_t': np.uint32,
    'longlong': np.int64, 'long long': np.int64, 'long long int': np.int64,
    'signed long long': np.int64, 'int64': np.int64, 'int64_t': np.int64,
    'ulonglong': np.uint64, 'unsigned long long': np.uint64, 'uint64': np.uint64,
    'uint64_t': np.uint64,
    'float': np.float32, 'double': np.float64,
}

_DTYPE_TO_NRRD = {
    np.dtype(np.int8): 'int8', np.dtype(np.uint8): 'unsigned char',
    np.dtype(np.int16): 'short', np.dtype(np.uint16): 'unsigned short',
    np.dtype(np.int32): 'int', np.dtype(np.uint32): 'unsigned int',
    np.dtype(np.int64): 'long long', np.dtype(np.uint64): 'unsigned long long',
    np.dtype(np.float32): 'float', np.dtype(np.float64): 'double',
}

_SPACE_SIGNS = {
    # world-frame conversion to LPS: per-axis sign flips
    'left-posterior-superior': (1, 1, 1), 'lps': (1, 1, 1),
    'right-anterior-superior': (-1, -1, 1), 'ras': (-1, -1, 1),
    'left-anterior-superior': (1, -1, 1), 'las': (1, -1, 1),
    'right-anterior-inferior': (-1, -1, -1),
    'left-anterior-inferior': (1, -1, -1),
    'right-posterior-superior': (-1, 1, 1),
    'right-posterior-inferior': (-1, 1, -1),
    'left-posterior-inferior': (1, 1, -1),
}


def _parse_vector(text: str) -> Optional[List[float]]:
    text = text.strip()
    if text.lower() == 'none':
        return None
    if not (text.startswith('(') and text.endswith(')')):
        raise ValueError(f'Invalid NRRD vector: {text!r}')
    return [float(v) for v in text[1:-1].split(',')]


def _fmt_vector(vec) -> str:
    return '(' + ','.join(repr(float(v)) for v in vec) + ')'


def read_header(f) -> Tuple[dict, dict]:
    """Parse the NRRD header from a binary stream positioned at the start.
    Returns (fields, keyvalues); leaves the stream at the payload."""
    magic = f.readline()
    if not magic.startswith(_MAGIC):
        raise ValueError('Not a NRRD file (bad magic)')
    fields: dict = {}
    keyvalues: dict = {}
    while True:
        line = f.readline()
        if not line:
            raise ValueError('Unexpected end of NRRD header')
        line = line.rstrip(b'\r\n')
        if line == b'':
            break
        text = line.decode('utf-8', errors='replace')
        if text.startswith('#'):
            continue
        if ':=' in text:
            k, v = text.split(':=', 1)
            keyvalues[k.strip()] = v.strip()
        elif ': ' in text or text.endswith(':'):
            k, _, v = text.partition(':')
            fields[k.strip().lower()] = v.strip()
        else:
            raise ValueError(f'Malformed NRRD header line: {text!r}')
    return fields, keyvalues


def _decode_payload(f, encoding: str, dtype: np.dtype, count: int,
                    byte_skip: int = 0, line_skip: int = 0) -> np.ndarray:
    encoding = encoding.lower()
    for _ in range(line_skip):
        f.readline()
    if byte_skip == -1:
        # teem convention: -1 = data is the LAST count*itemsize bytes
        if encoding != 'raw':
            raise ValueError('byte skip: -1 requires raw encoding')
        buf = f.read()
        return np.frombuffer(buf[-count * dtype.itemsize:], dtype=dtype,
                             count=count)
    if byte_skip:
        f.read(byte_skip)
    if encoding == 'raw':
        buf = f.read(count * dtype.itemsize)
        if len(buf) < count * dtype.itemsize:
            raise ValueError('Truncated NRRD raw payload')
        return np.frombuffer(buf, dtype=dtype, count=count)
    if encoding in ('gzip', 'gz'):
        # gzip members concatenated (pigz/bgzip) decode in full
        raw = _native.gzip_decompress(f.read(), size=count * dtype.itemsize)
        return np.frombuffer(raw, dtype=dtype, count=count)
    if encoding in ('ascii', 'text', 'txt'):
        return np.loadtxt(_io.TextIOWrapper(f), dtype=dtype).reshape(-1)[:count]
    raise ValueError(f'Unsupported NRRD encoding: {encoding}')


@reader_guard('NRRD')
def read(path: str) -> MedicalImage:
    with open(path, 'rb') as f:
        fields, keyvalues = read_header(f)

        ndim = int(fields['dimension'])
        sizes = [int(s) for s in fields['sizes'].split()]
        if len(sizes) != ndim:
            raise ValueError('NRRD sizes do not match dimension')
        dtype = np.dtype(_NRRD_TYPES[fields['type'].strip().lower()])

        byte_skip = int(fields.get('byte skip', fields.get('byteskip', 0)))
        line_skip = int(fields.get('line skip', fields.get('lineskip', 0)))
        if 'data file' in fields or 'datafile' in fields:
            rel = fields.get('data file', fields.get('datafile'))
            dpath = resolve_datafile(path, rel, 'NRRD')
            try:
                df = open(dpath, 'rb')
            except OSError as ex:
                # the reference comes from the (untrusted) header, not
                # the caller: surface per the io error contract
                raise ValueError(
                    f'NRRD data file not readable: {rel!r} ({ex})') from ex
            with df:
                flat = _decode_payload(df, fields.get('encoding', 'raw'),
                                       dtype, int(np.prod(sizes)),
                                       byte_skip, line_skip)
        else:
            flat = _decode_payload(f, fields.get('encoding', 'raw'),
                                   dtype, int(np.prod(sizes)),
                                   byte_skip, line_skip)

    endian = fields.get('endian', 'little').lower()
    if dtype.itemsize > 1 and endian == 'big':
        flat = flat.view(flat.dtype.newbyteorder('>')).astype(dtype)

    # axis roles: a 'none' space direction or non-domain kind marks the
    # component axis (only a single leading component axis is supported,
    # which covers everything ITK's NrrdImageIO produces for vector images)
    dirs_txt = fields.get('space directions')
    kinds = fields.get('kinds', '').split()
    vectors: List[Optional[List[float]]] = (
        [_parse_vector(tok) for tok in _tokenize_vectors(dirs_txt)]
        if dirs_txt else [None if (i < len(kinds) and kinds[i] not in ('domain', 'space'))
                          else [1.0 if j == i else 0.0 for j in range(ndim)]
                          for i in range(ndim)])
    domain_axes = [i for i, v in enumerate(vectors) if v is not None]
    comp_axes = [i for i, v in enumerate(vectors) if v is None]
    if comp_axes and comp_axes != [0]:
        raise ValueError('Only a single leading component axis is supported')
    is_vector = bool(comp_axes)

    sdim = len(domain_axes)
    # world frame: `space` names an anatomical frame (convert to LPS);
    # `space dimension` is frame-less (use as-is)
    signs = (1.0,) * sdim
    space = fields.get('space')
    if space:
        signs = _SPACE_SIGNS.get(space.strip().lower())
        if signs is None:
            raise ValueError(f'Unsupported NRRD space: {space}')
        signs = tuple(float(s) for s in signs[:sdim])

    dir_cols = np.array([vectors[i] for i in domain_axes], dtype=float).T  # (world, axis)
    dir_cols = dir_cols * np.asarray(signs)[:, None]
    spacing = np.linalg.norm(dir_cols, axis=0)
    spacing = np.where(spacing == 0, 1.0, spacing)
    direction = dir_cols / spacing

    origin_txt = fields.get('space origin')
    origin = (np.asarray(_parse_vector(origin_txt)) * np.asarray(signs)
              if origin_txt else np.zeros(sdim))

    # reshape: NRRD lists axes fastest-first; numpy C-order wants slowest-first
    arr = flat.reshape(sizes[::-1])
    if is_vector:
        # component axis is fastest (axis 0 in NRRD) -> last in numpy: done.
        pass

    meta = dict(keyvalues)
    return MedicalImage(array=arr, spacing=tuple(spacing), origin=tuple(origin),
                        direction=direction, is_vector=is_vector, meta=meta)


def _tokenize_vectors(text: str) -> List[str]:
    """Split 'none (1,0) (0,1)' into tokens."""
    toks, depth, cur = [], 0, ''
    for ch in text:
        if ch == '(':
            depth += 1
        elif ch == ')':
            depth -= 1
        if ch.isspace() and depth == 0:
            if cur:
                toks.append(cur)
                cur = ''
        else:
            cur += ch
    if cur:
        toks.append(cur)
    return toks


def write(img: MedicalImage, path: str, compress: bool = True,
          compression_level: int = 1) -> None:
    arr = np.ascontiguousarray(img.array)
    if arr.dtype.byteorder == '>':
        arr = arr.astype(arr.dtype.newbyteorder('<'))
    dtype = arr.dtype
    if dtype not in _DTYPE_TO_NRRD:
        raise ValueError(f'Unsupported dtype for NRRD export: {dtype}')

    sdim = img.dim
    ndim = arr.ndim
    sizes_np = arr.shape            # numpy order (slowest first)
    sizes = list(sizes_np[::-1])    # NRRD order (fastest first)

    dir_cols = img.direction * np.asarray(img.spacing)[None, :]
    vec_txt = []
    if img.is_vector:
        vec_txt.append('none')
    for j in range(sdim):
        vec_txt.append(_fmt_vector(dir_cols[:, j]))

    kinds = (['vector'] if img.is_vector else []) + ['domain'] * sdim

    lines = [
        'NRRD0004',
        '# produced by totalsegmentator2d_tpu_torch',
        f'type: {_DTYPE_TO_NRRD[dtype]}',
        f'dimension: {ndim}',
    ]
    if sdim == 3:
        lines.append('space: left-posterior-superior')
    else:
        lines.append(f'space dimension: {sdim}')
    lines.append('sizes: ' + ' '.join(str(s) for s in sizes))
    lines.append('space directions: ' + ' '.join(vec_txt))
    lines.append('kinds: ' + ' '.join(kinds))
    if dtype.itemsize > 1:
        lines.append('endian: little')
    lines.append(f'encoding: {"gzip" if compress else "raw"}')
    lines.append('space origin: ' + _fmt_vector(img.origin))

    payload = arr.tobytes()
    if compress:
        payload = _native.gzip_compress(payload, level=compression_level)

    with open(path, 'wb') as f:
        f.write('\n'.join(lines).encode('utf-8'))
        f.write(b'\n')
        for k, v in img.meta.items():
            k = str(k).replace('\n', ' ')
            v = str(v).replace('\n', ' ')
            f.write(f'{k}:={v}\n'.encode('utf-8'))
        f.write(b'\n')
        f.write(payload)
