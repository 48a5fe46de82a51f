"""Raster inputs: PNG, BMP and TIFF, decoded by the package itself.

The reference package reads these through Pillow (its ``io/__init__.py``
``_read_raster``: ``np.asarray(PIL.Image.open(path))``), which the card's
machine does not have. :func:`read_raster` returns the array Pillow gives,
mode for mode, with unit spacing and a zero origin:

- PNG, every colour type at bit depths 1-16, Adam7 interlace, all five row
  filters: 1-bit gray -> bool; 2- and 4-bit gray scaled to 0..255 (``L``);
  16-bit gray -> uint16 (``I;16``); 16-bit RGB / RGBA -> their high bytes;
  16-bit gray + alpha -> RGBA of the high bytes; palette images keep their
  indices (``P``).
- BMP with a BITMAPINFOHEADER, V2-V5 header at 1/4/8/24/32 bits, BI_RGB or
  BI_BITFIELDS, bottom-up or top-down: a palette that is the identity gray
  ramp (black and white at 1 bit) drops to ``1`` / ``L``, any other stays
  ``P`` indices; 32 bits -> RGB, or RGBA where the bitfields name alpha.
- TIFF, the first image, baseline strips (the last one holding the rows
  that are left) or tiles, uncompressed, PackBits,
  LZW or Deflate, horizontal predictor 2: 1-bit -> bool, 8-bit gray (white
  is zero inverted), 16-bit unsigned -> uint16 (big-endian ``>u2`` when
  uncompressed, as Pillow leaves it), int16 / int32 / uint32 -> int32
  (``I``), float32 -> float32 (``F``), RGB / RGBA / gray + alpha at 8 bits,
  palette indices.

Anything else (RLE BMPs, JPEG or CCITT TIFFs, planar TIFFs, bit-order 2,
premultiplied alpha, ...) raises ``ValueError`` naming the feature; a
corrupt or truncated file raises ``ValueError('Corrupt raster image file
...')``, as the reference does. That includes a TIFF field that is missing,
holds another number of values than is read, or is not an integer where
one is read (each named), and a TIFF whose strips or tiles are more or
fewer than its geometry has.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from .image import MedicalImage

RASTER_EXTENSIONS = ('png', 'bmp', 'tif', 'tiff')

#: Pillow's decompression-bomb limit: images of more pixels are refused
#: before anything of their size is allocated
MAX_PIXELS = 2 * 89478485


class _Corrupt(Exception):
    pass


def read_raster(path: str) -> MedicalImage:
    """A PNG, BMP or TIFF file as Pillow's array (see the module doc)."""
    with open(path, 'rb') as f:
        data = f.read()
    try:
        arr = decode_raster(data)
    except (_Corrupt, struct.error, zlib.error, IndexError) as ex:
        raise ValueError(
            f'Corrupt raster image file ({type(ex).__name__}: {ex})') from ex
    return MedicalImage(array=arr, is_vector=arr.ndim == 3)


def decode_raster(data: bytes) -> np.ndarray:
    if data.startswith(b'\x89PNG\r\n\x1a\n'):
        return _png(data)
    if data.startswith(b'BM'):
        return _bmp(data)
    if data[:4] in (b'II*\0', b'MM\0*'):
        return _tiff(data)
    raise _Corrupt('cannot identify image file')


def _check_size(w: int, h: int) -> None:
    if w * h > MAX_PIXELS:
        raise _Corrupt(f'image size ({w} x {h} pixels) exceeds the limit of '
                       f'{MAX_PIXELS} pixels, could be a decompression bomb')


def _need(data: bytes, end: int, what: str) -> None:
    if end > len(data):
        raise _Corrupt(f'image file is truncated ({what})')


def _unpack_bits(rows: np.ndarray, bits: int, count: int) -> np.ndarray:
    """(h, stride) uint8 rows of packed samples -> (h, count) uint8 sample
    values, most significant bits first."""
    if bits == 8:
        return rows[:, :count]
    per = 8 // bits
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & np.uint8((1 << bits) - 1)
    return vals.reshape(rows.shape[0], rows.shape[1] * per)[:, :count]


# -- PNG ----------------------------------------------------------------------

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}


def _png(data: bytes) -> np.ndarray:
    pos, ihdr, idat = 8, None, []
    while True:
        _need(data, pos + 8, 'PNG chunk header')
        n, kind = struct.unpack_from('>I4s', data, pos)
        _need(data, pos + 12 + n, f'PNG {kind!r} chunk')
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack_from('>I', data, pos + 8 + n)
        if zlib.crc32(kind + body) != crc:
            raise _Corrupt(f'broken PNG file (CRC of {kind!r})')
        pos += 12 + n
        if kind == b'IHDR':
            ihdr = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
    if ihdr is None or not idat:
        raise _Corrupt('PNG without IHDR or IDAT')
    w, h, depth, ctype, method, flt, interlace = ihdr
    if ctype not in _PNG_DEPTHS or depth not in _PNG_DEPTHS[ctype]:
        raise _Corrupt(f'unknown PNG mode (bit depth {depth}, colour type '
                       f'{ctype})')
    if method != 0 or flt != 0 or interlace not in (0, 1):
        raise ValueError(f'PNG: compression method {method}, filter method '
                         f'{flt} or interlace method {interlace} is not '
                         f'supported')
    _check_size(w, h)
    nch = _PNG_CHANNELS[ctype]
    raw = zlib.decompress(b''.join(idat))
    bitspp = depth * nch
    if interlace == 0:
        samples, used = _png_pass(raw, 0, w, h, bitspp, depth, nch)
    else:
        samples = np.zeros((h, w * nch), np.uint16 if depth == 16 else np.uint8)
        used = 0
        for xs, ys, dx, dy in _ADAM7:
            pw, ph = -(-(w - xs) // dx), -(-(h - ys) // dy)
            if pw <= 0 or ph <= 0:
                continue
            sub, used = _png_pass(raw, used, pw, ph, bitspp, depth, nch)
            view = samples.reshape(h, w, nch)
            view[ys::dy, xs::dx] = sub.reshape(ph, pw, nch)
    return _png_mode(samples.reshape(h, w, nch), depth, ctype)


def _png_pass(raw: bytes, pos: int, w: int, h: int, bitspp: int, depth: int,
              nch: int) -> Tuple[np.ndarray, int]:
    """Unfilter one (sub-)image of h rows at raw[pos:]: (h, w*nch) samples
    and the position after it."""
    stride = -(-(w * bitspp) // 8)
    bpp = max(1, bitspp // 8)
    _need(raw, pos + h * (stride + 1), 'PNG image data')
    rows = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1)
        pos += stride + 1
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum per byte lane
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prior
        elif ftype in (3, 4):
            cur = np.frombuffer(_png_unfilter_seq(ftype, line.tobytes(),
                                                  prior.tobytes(), bpp),
                                np.uint8)
        else:
            raise _Corrupt(f'unknown PNG filter type {ftype}')
        rows[y] = cur
        prior = rows[y]
    if depth == 16:
        samples = rows.view('>u2').astype(np.uint16)
    else:
        samples = _unpack_bits(rows, depth, w * nch)
    return samples, pos


def _png_unfilter_seq(ftype: int, line: bytes, prior: bytes,
                      bpp: int) -> bytes:
    """Average (3) and Paeth (4): each byte depends on the one bpp before."""
    cur = bytearray(line)
    n = len(cur)
    if ftype == 3:
        for i in range(min(bpp, n)):
            cur[i] = (cur[i] + (prior[i] >> 1)) & 255
        for i in range(bpp, n):
            cur[i] = (cur[i] + ((cur[i - bpp] + prior[i]) >> 1)) & 255
        return bytes(cur)
    for i in range(min(bpp, n)):
        cur[i] = (cur[i] + prior[i]) & 255
    for i in range(bpp, n):
        a, b, c = cur[i - bpp], prior[i], prior[i - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        cur[i] = (cur[i] + pred) & 255
    return bytes(cur)


def _png_mode(s: np.ndarray, depth: int, ctype: int) -> np.ndarray:
    """(h, w, nch) samples -> Pillow's array for the PNG mode."""
    if ctype in (0, 3):
        s = s[..., 0]
        if ctype == 3:
            return s.astype(np.uint8)
        if depth == 1:
            return s != 0
        if depth in (2, 4):
            return (s * (255 // ((1 << depth) - 1))).astype(np.uint8)
        return s.astype(np.uint16 if depth == 16 else np.uint8)
    if depth == 16:
        s = (s >> 8).astype(np.uint8)
        if ctype == 4:  # LA;16B opens as RGBA
            return np.ascontiguousarray(s[..., [0, 0, 0, 1]])
        return s
    return s.astype(np.uint8)


# -- BMP ----------------------------------------------------------------------

#: BI_BITFIELDS masks (r, g, b, a) Pillow takes, and the byte order of each
#: pixel they give (as Pillow's raw modes)
_BMP_MASKS32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): 'BGRX',
    (0xFF000000, 0xFF0000, 0xFF00, 0x0): 'XBGR',
    (0xFF000000, 0xFF00, 0xFF, 0x0): 'BGXR',
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): 'ABGR',
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): 'RGBA',
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): 'BGRA',
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): 'BGAR',
    (0x0, 0x0, 0x0, 0x0): 'BGRA',
}


def _bmp(data: bytes) -> np.ndarray:
    _need(data, 18, 'BMP header')
    (offset,) = struct.unpack_from('<I', data, 10)
    (hsize,) = struct.unpack_from('<I', data, 14)
    if hsize not in (40, 52, 56, 64, 108, 124):
        raise ValueError(f'BMP: header of {hsize} bytes is not supported '
                         f'(BITMAPINFOHEADER and V2-V5 are)')
    _need(data, 14 + hsize, 'BMP info header')
    hdr = data[18:14 + hsize]
    width, height_raw = struct.unpack_from('<II', hdr, 0)
    top_down = hdr[7] == 0xFF
    height = 2 ** 32 - height_raw if top_down else height_raw
    _check_size(width, height)
    bits, compression = struct.unpack_from('<HI', hdr, 10)
    (colors,) = struct.unpack_from('<I', hdr, 28)
    pos = 14 + hsize
    if compression == 3:  # BI_BITFIELDS
        if len(hdr) >= 48:
            masks = list(struct.unpack_from('<III', hdr, 36))
            masks.append(struct.unpack_from('<I', hdr, 48)[0]
                         if len(hdr) >= 52 else 0)
        else:
            _need(data, pos + 12, 'BMP bitfields')
            masks = list(struct.unpack_from('<III', data, pos)) + [0]
            pos += 12
    elif compression != 0:
        raise ValueError(f'BMP: compression {compression} (RLE) is not '
                         f'supported')
    if bits not in (1, 4, 8, 24, 32):
        raise ValueError(f'BMP: {bits}-bit pixels are not supported')
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    stride = ((width * bits + 31) >> 3) & ~3
    _need(data, offset + stride * height, 'BMP pixel data')
    rows = np.frombuffer(data, np.uint8, stride * height, offset).reshape(
        height, stride)
    if not top_down:
        rows = rows[::-1]
    if bits <= 8:
        if compression == 3:
            raise ValueError('BMP: bitfields on a palette image are not '
                             'supported')
        if not 0 < colors <= 65536:
            raise _Corrupt(f'unsupported BMP palette size ({colors})')
        _need(data, pos + 4 * colors, 'BMP palette')
        pal = np.frombuffer(data, np.uint8, 4 * colors, pos).reshape(-1, 4)
        ramp = np.array([0, 255] if colors == 2 else np.arange(colors) & 255)
        gray = bool((pal[:, :3] == ramp[:, None]).all())
        idx = _unpack_bits(rows, bits, width)
        if not gray:
            return np.ascontiguousarray(idx)
        if colors == 2 and bits == 1:
            return idx != 0
        if bits != 8:
            raise ValueError(f'BMP: a {bits}-bit image with a {colors}-entry '
                             f'gray palette is not supported')
        return np.ascontiguousarray(idx)
    px = rows[:, :width * bits // 8].reshape(height, width, bits // 8)
    if compression == 3:
        key = tuple(masks) if bits == 32 else tuple(masks[:3])
        if bits == 32 and key in _BMP_MASKS32:
            order = _BMP_MASKS32[key]
        elif bits == 24 and key == (0xFF0000, 0xFF00, 0xFF):
            order = 'BGR'
        else:
            raise ValueError(f'BMP: bitfields layout {tuple(hex(m) for m in masks)} '
                             f'is not supported')
    else:
        order = 'BGR' if bits == 24 else 'BGRX'
    out = 'RGBA' if 'A' in order else 'RGB'
    return np.ascontiguousarray(px[..., [order.index(c) for c in out]])


# -- TIFF ---------------------------------------------------------------------

_TIFF_TYPES = {1: 'B', 2: 'B', 3: 'H', 4: 'I', 5: 'II', 6: 'b', 7: 'B',
               8: 'h', 9: 'i', 10: 'ii', 11: 'f', 12: 'd'}
#: the integer field types: BYTE, SHORT, LONG, SBYTE, SSHORT, SLONG
_TIFF_INTS = (1, 3, 4, 6, 8, 9)
_COMPRESSIONS = {1: 'raw', 5: 'LZW', 8: 'Deflate', 32946: 'Deflate',
                 32773: 'PackBits'}


def _tiff_tags(data: bytes, bo: str) -> Dict[int, Tuple[int, tuple]]:
    """{tag: (field type, values)} of the first directory."""
    (ifd,) = struct.unpack_from(bo + 'I', data, 4)
    _need(data, ifd + 2, 'TIFF directory')
    (n,) = struct.unpack_from(bo + 'H', data, ifd)
    _need(data, ifd + 2 + 12 * n, 'TIFF directory')
    tags = {}
    for k in range(n):
        tag, typ, count = struct.unpack_from(bo + 'HHI', data, ifd + 2 + 12 * k)
        if typ not in _TIFF_TYPES:
            continue
        fmt = _TIFF_TYPES[typ]
        size = struct.calcsize('<' + fmt) * count
        at = ifd + 2 + 12 * k + 8
        if size > 4:
            (at,) = struct.unpack_from(bo + 'I', data, at)
        _need(data, at + size, f'TIFF tag {tag}')
        tags[tag] = (typ, struct.unpack_from(bo + fmt * count, data, at))
    return tags


def _tiff_ints(t: dict, tag: int, name: str,
               default: Optional[tuple] = None, least: int = 0) -> tuple:
    """The values of an integer field, each at least ``least``; a missing
    field is ``default``, or refused where there is none."""
    if tag not in t:
        if default is None:
            raise _Corrupt(f'TIFF: missing {name} (tag {tag})')
        return default
    typ, vals = t[tag]
    if typ not in _TIFF_INTS:
        raise _Corrupt(f'TIFF: {name} (tag {tag}) is not an integer field '
                       f'(type {typ})')
    if vals and min(vals) < least:
        raise _Corrupt(f'TIFF: {name} (tag {tag}) holds {min(vals)}, less '
                       f'than {least}')
    return vals


def _tiff_int(t: dict, tag: int, name: str, default: Optional[int] = None,
              least: int = 0) -> int:
    """The one value of an integer field (see :func:`_tiff_ints`)."""
    vals = _tiff_ints(t, tag, name, None if default is None else (default,),
                      least)
    if len(vals) != 1:
        raise _Corrupt(f'TIFF: {name} (tag {tag}) holds {len(vals)} values '
                       f'where one is read')
    return vals[0]


def _tiff_blocks(t: dict, offsets_tag: int, counts_tag: int, what: str,
                 n: int) -> Tuple[tuple, tuple]:
    """The offsets and byte counts of the n strips or tiles the geometry
    has. Another number of them is refused: Pillow's own decoder paints
    extra blocks again from the top-left corner, libtiff drops them."""
    offsets = _tiff_ints(t, offsets_tag, f'{what}Offsets')
    counts = _tiff_ints(t, counts_tag, f'{what}ByteCounts')
    for name, vals in ((f'{what}Offsets', offsets),
                       (f'{what}ByteCounts', counts)):
        if len(vals) != n:
            raise _Corrupt(f'TIFF: {name} holds {len(vals)} values for '
                           f'{n} {what.lower()}s')
    return offsets, counts


def _tiff(data: bytes) -> np.ndarray:
    bo = '<' if data[:2] == b'II' else '>'
    t = _tiff_tags(data, bo)
    w = _tiff_int(t, 256, 'ImageWidth', least=1)
    h = _tiff_int(t, 257, 'ImageLength', least=1)
    _check_size(w, h)
    comp = _tiff_int(t, 259, 'Compression', 1)
    if comp not in _COMPRESSIONS:
        raise ValueError(f'TIFF: compression {comp} is not supported (none, '
                         f'PackBits, LZW and Deflate are)')
    photo = _tiff_int(t, 262, 'PhotometricInterpretation', 0)
    fillorder = _tiff_int(t, 266, 'FillOrder', 1)
    planar = _tiff_int(t, 284, 'PlanarConfiguration', 1)
    predictor = _tiff_int(t, 317, 'Predictor', 1)
    orientation = _tiff_int(t, 274, 'Orientation', 1)
    if fillorder != 1 or planar != 1 or orientation != 1:
        raise ValueError(f'TIFF: FillOrder {fillorder}, PlanarConfiguration '
                         f'{planar} or Orientation {orientation} is not '
                         f'supported (1 each is)')
    if predictor not in (1, 2):
        raise ValueError(f'TIFF: predictor {predictor} is not supported')
    spp = _tiff_int(t, 277, 'SamplesPerPixel', 1)
    if not 1 <= spp <= 4:
        raise ValueError(f'TIFF: {spp} samples per pixel are not supported '
                         f'(1 to 4 are)')
    bps = _tiff_ints(t, 258, 'BitsPerSample', (1,))
    extra = _tiff_ints(t, 338, 'ExtraSamples', ())
    fmt = _tiff_ints(t, 339, 'SampleFormat', (1,))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    if len(bps) > spp:
        bps = bps[:spp]
    elif len(bps) == 1 and spp > 1:
        bps = bps * spp
    if len(bps) != spp or len(set(bps)) != 1:
        raise ValueError(f'TIFF: bits per sample {bps} with {spp} samples '
                         f'per pixel are not supported')
    bits = bps[0]
    mode = _tiff_mode(bo, photo, fmt, bits, spp, extra)
    rowbytes = -(-(w * spp * bits) // 8)
    if predictor == 2 and bits < 8:
        raise ValueError('TIFF: predictor 2 on sub-byte samples is not '
                         'supported')

    def block(k: int, offsets, counts, bw: int, bh: int) -> np.ndarray:
        """Block k, bh rows of bw pixels, decompressed and checked."""
        start, n = offsets[k], counts[k]
        _need(data, start + n, 'TIFF strip or tile')
        raw = data[start:start + n]
        stride = -(-(bw * spp * bits) // 8)
        need = stride * bh
        if comp == 5:
            raw = _lzw(raw, need)
        elif comp in (8, 32946):
            # as libtiff, inflate no more than the block holds: a stream
            # that would give more is cut there, never buffered whole
            raw = zlib.decompressobj().decompress(raw, need)
        elif comp == 32773:
            raw = _packbits(raw, need)
        if len(raw) < need:
            raise _Corrupt('TIFF: strip or tile is truncated')
        rows = np.frombuffer(raw, np.uint8, need).reshape(bh, stride)
        if predictor == 2:
            rows = _undo_predictor(rows, bo, bits, spp)
        return rows

    if 273 in t or 324 not in t:
        rps = min(_tiff_int(t, 278, 'RowsPerStrip', h, least=1), h)
        n = -(-h // rps)
        offsets, counts = _tiff_blocks(t, 273, 279, 'Strip', n)
        img = np.zeros((h, rowbytes), np.uint8)
        for k in range(n):
            # the last strip holds the rows that are left
            y0 = k * rps
            rows = min(rps, h - y0)
            img[y0:y0 + rows] = block(k, offsets, counts, w, rows)
    else:
        # tiles are whole, at the edges too: the image crops them
        tw = _tiff_int(t, 322, 'TileWidth', least=1)
        th = _tiff_int(t, 323, 'TileLength', least=1)
        if bits * spp % 8:
            raise ValueError('TIFF: tiles of sub-byte pixels are not '
                             'supported')
        bpp = bits * spp // 8
        across = -(-w // tw)
        offsets, counts = _tiff_blocks(t, 324, 325, 'Tile',
                                       across * -(-h // th))
        img = np.zeros((h, rowbytes), np.uint8)
        for k in range(len(offsets)):
            rows = block(k, offsets, counts, tw, th)
            y0, x0 = (k // across) * th, (k % across) * tw
            hh, ww = min(th, h - y0), min(tw, w - x0)
            img[y0:y0 + hh, x0 * bpp:(x0 + ww) * bpp] = rows[:hh, :ww * bpp]
    return _tiff_pixels(img, bo, bits, spp, w, mode, photo, comp)


def _tiff_mode(bo: str, photo: int, fmt: tuple, bits: int, spp: int,
               extra: tuple) -> str:
    """Pillow's mode (its OPEN_INFO) for the layouts this reader takes."""
    f = fmt[0]
    if spp == 1 and photo in (0, 1):
        if bits in (1, 2, 4) and f == 1:
            return '1' if bits == 1 else 'L'
        if bits == 8 and (f == 1 or (f == 2 and photo == 1)):
            return 'L'
        if bits == 16 and f == 1 and (bo == '<' or photo == 1):
            return 'I;16'
        if bits == 16 and f == 2 and photo == 1:
            return 'I'
        if bits == 32 and f == 3:
            return 'F'
        if bits == 32 and photo == 1 and (f == 2 or (f == 1 and bo == '<')):
            return 'I'
    if photo == 3 and spp == 1 and bits in (1, 2, 4, 8) and f == 1:
        return 'P'
    if photo == 1 and spp == 2 and bits == 8 and extra == (2,):
        return 'LA'
    if photo == 2 and bits in (8, 16) and f == 1:
        if spp == 3 and not extra:
            return 'RGB'
        if spp == 4 and extra in ((), (2,), (999,)) and (
                bits == 8 or extra != (999,)):
            return 'RGBA'
        if spp == 4 and extra == (0,):
            return 'RGBX'
    raise ValueError(f'TIFF: photometric {photo}, sample format {fmt}, '
                     f'{bits}-bit samples x {spp}, extra samples {extra} '
                     f'is not a supported pixel layout')


def _tiff_pixels(img: np.ndarray, bo: str, bits: int, spp: int, w: int,
                 mode: str, photo: int, comp: int) -> np.ndarray:
    h = img.shape[0]
    if bits < 8:
        s = _unpack_bits(img, bits, w * spp).reshape(h, w)
        if photo == 0:
            s = (1 << bits) - 1 - s
        if mode == '1':
            return s != 0
        if mode == 'L':
            return (s * (255 // ((1 << bits) - 1))).astype(np.uint8)
        return s.astype(np.uint8)
    if bits == 8:
        s = img[:, :w * spp].reshape(h, w, spp)
        if mode in ('L', 'P'):
            s = s[..., 0]
            return 255 - s if (photo == 0 and mode == 'L') else s.copy()
        if mode == 'RGBX':
            return np.ascontiguousarray(s[..., :3])
        return s.copy()
    if bits == 16:
        raw = img[:, :w * spp * 2].copy()
        if mode == 'I':
            return raw.view(bo + 'i2').astype(np.int32)
        s = raw.view(bo + 'u2').reshape(h, w, spp)
        if mode in ('RGB', 'RGBA', 'RGBX'):
            s = (s >> 8).astype(np.uint8)
            return np.ascontiguousarray(s[..., :3] if mode == 'RGBX' else s)
        s = s[..., 0]
        if bo == '>' and comp == 1:  # Pillow keeps I;16B as it is in the file
            return s
        return s.astype(np.uint16)
    s = img[:, :w * 4].copy()
    if mode == 'F':
        return s.view(bo + 'f4').reshape(h, w).astype(np.float32)
    return s.view(bo + 'i4').reshape(h, w).astype(np.int32)


def _undo_predictor(rows: np.ndarray, bo: str, bits: int,
                    spp: int) -> np.ndarray:
    """Horizontal differencing (predictor 2): a running sum along each row,
    per sample, modulo 2**bits."""
    dt = {8: np.uint8, 16: np.uint16, 32: np.uint32}[bits]
    wire = np.dtype(dt).newbyteorder(bo)
    vals = np.ascontiguousarray(rows).view(wire).astype(dt)
    out = np.cumsum(vals.reshape(rows.shape[0], -1, spp), axis=1, dtype=dt)
    return out.astype(wire).reshape(rows.shape[0], -1).view(np.uint8)


def _packbits(buf: bytes, expected: int) -> bytes:
    out = bytearray()
    i, n = 0, len(buf)
    while i < n and len(out) < expected:
        c = buf[i]
        i += 1
        if c < 128:
            out += buf[i:i + c + 1]
            i += c + 1
        elif c > 128:
            if i >= n:
                break
            out += bytes((buf[i],)) * (257 - c)
            i += 1
    return bytes(out)


def _lzw(buf: bytes, expected: int) -> bytes:
    """TIFF LZW: MSB-first codes of 9-12 bits, clear 256, end 257, the code
    width growing one entry early."""
    out = bytearray()
    table: List[bytes] = [bytes((i,)) for i in range(256)] + [b'', b'']
    width, acc, nacc, i, n = 9, 0, 0, 0, len(buf)
    prev = None
    while len(out) < expected:
        while nacc < width:
            if i >= n:
                return bytes(out)
            acc = (acc << 8) | buf[i]
            i += 1
            nacc += 8
        nacc -= width
        code = (acc >> nacc) & ((1 << width) - 1)
        acc &= (1 << nacc) - 1
        if code == 256:
            del table[258:]
            width, prev = 9, None
            continue
        if code == 257:
            break
        if prev is None:
            if code >= 256:
                raise _Corrupt('TIFF LZW: bad first code')
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise _Corrupt('TIFF LZW: code out of range')
        out += entry
        prev = entry
        if len(table) >= (1 << width) - 1 and width < 12:
            width += 1
    return bytes(out)
