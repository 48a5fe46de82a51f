"""Raster inputs of the port (io/raster.py) against the reference package's
Pillow reader (``io._read_raster``: ``np.asarray(PIL.Image.open(path))``).

Files are written with Pillow where it writes the layout, and by the small
encoders below where it does not (PNG interlace, chosen row filters, 2/4/16
bit depths; BMP V4 / V5 headers, bitfields and top-down rows; tiled TIFFs).
Every case must give the same array, dtype (byte order included), shape,
``is_vector``, spacing and origin, bit for bit. Pillow is imported here
only, and these tests skip where it is absent."""

import struct
import zlib

import numpy as np
import pytest

from totalsegmentator2d_tpu import io as jax_io
from totalsegmentator2d_tpu_torch import io as port_io

Image = pytest.importorskip('PIL.Image')


def _same(path):
    ref = jax_io.read_image(str(path))
    ours = port_io.read_image(str(path))
    assert ours.array.dtype == ref.array.dtype, (ours.array.dtype,
                                                 ref.array.dtype)
    assert ours.array.shape == ref.array.shape
    np.testing.assert_array_equal(ours.array, ref.array)
    assert ours.is_vector == ref.is_vector
    assert ours.spacing == ref.spacing and ours.origin == ref.origin
    np.testing.assert_array_equal(ours.direction, ref.direction)
    return ours


def _pil_image(mode, rng, shape=(23, 37)):
    h, w = shape
    if mode == '1':
        return Image.fromarray(rng.random((h, w)) > 0.5)
    if mode == 'I;16':
        return Image.fromarray(rng.integers(0, 65536, (h, w)).astype(np.uint16))
    if mode == 'I':
        return Image.fromarray(
            rng.integers(-2 ** 31, 2 ** 31, (h, w)).astype(np.int32))
    if mode == 'F':
        return Image.fromarray(rng.standard_normal((h, w)).astype(np.float32))
    if mode == 'P':
        im = Image.fromarray(rng.integers(0, 200, (h, w)).astype(np.uint8), 'L')
        im = im.convert('P')
        im.putpalette(rng.integers(0, 256, 768).astype(np.uint8).tobytes())
        return im
    nch = {'L': 1, 'LA': 2, 'RGB': 3, 'RGBA': 4}[mode]
    arr = rng.integers(0, 256, (h, w, nch)).astype(np.uint8)
    return Image.fromarray(arr[..., 0] if nch == 1 else arr, mode)


# -- PNG ------------------------------------------------------------------------

@pytest.mark.parametrize('mode', ['1', 'L', 'LA', 'I;16', 'P', 'RGB', 'RGBA'])
def test_png_modes(tmp_path, mode):
    p = tmp_path / 'x.png'
    _pil_image(mode, np.random.default_rng(1)).save(p)
    _same(p)


def _chunk(kind, body):
    return (struct.pack('>I', len(body)) + kind + body
            + struct.pack('>I', zlib.crc32(kind + body)))


def _filter_rows(rows, bpp, filters):
    """rows: list of bytes; filter row y with filters[y % len]."""
    out, prior = [], bytes(len(rows[0]) if rows else 0)
    for y, row in enumerate(rows):
        f = filters[y % len(filters)]
        enc = bytearray()
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            if f == 0:
                pred = 0
            elif f == 1:
                pred = a
            elif f == 2:
                pred = b
            elif f == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            enc.append((x - pred) & 255)
        out.append(bytes([f]) + bytes(enc))
        prior = row
    return b''.join(out)


def _pack_rows(samples, depth):
    """(h, w*nch) integer samples -> list of packed row bytes."""
    rows = []
    for r in samples:
        if depth == 16:
            rows.append(r.astype('>u2').tobytes())
        elif depth == 8:
            rows.append(r.astype(np.uint8).tobytes())
        else:
            bits = ''.join(format(int(v), f'0{depth}b') for v in r)
            bits += '0' * (-len(bits) % 8)
            rows.append(int(bits, 2).to_bytes(len(bits) // 8, 'big')
                        if bits else b'')
    return rows


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_bytes(samples, depth, ctype, filters=(0,), interlace=False,
               palette=None):
    """samples (h, w, nch) -> a PNG file."""
    h, w, nch = samples.shape
    bpp = max(1, depth * nch // 8)
    if interlace:
        raw = b''
        for xs, ys, dx, dy in _ADAM7:
            sub = samples[ys::dy, xs::dx]
            if sub.size:
                raw += _filter_rows(_pack_rows(
                    sub.reshape(sub.shape[0], -1), depth), bpp, filters)
    else:
        raw = _filter_rows(_pack_rows(samples.reshape(h, -1), depth), bpp,
                           filters)
    out = (b'\x89PNG\r\n\x1a\n'
           + _chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, depth, ctype, 0,
                                         0, int(interlace))))
    if palette is not None:
        out += _chunk(b'PLTE', palette)
    return out + _chunk(b'IDAT', zlib.compress(raw)) + _chunk(b'IEND', b'')


@pytest.mark.parametrize('ctype,depth', [
    (0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1),
    (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)])
@pytest.mark.parametrize('interlace', [False, True])
def test_png_depths_filters_interlace(tmp_path, ctype, depth, interlace):
    """Every colour type and bit depth, the five row filters in turn, with
    and without Adam7 (11 x 13 leaves some passes one pixel wide)."""
    rng = np.random.default_rng(depth * 10 + ctype)
    nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    samples = rng.integers(0, 2 ** depth, (11, 13, nch))
    pal = rng.integers(0, 256, 3 * 2 ** depth).astype(np.uint8).tobytes() \
        if ctype == 3 else None
    p = tmp_path / 'x.png'
    p.write_bytes(_png_bytes(samples, depth, ctype, filters=(0, 1, 2, 3, 4),
                             interlace=interlace, palette=pal))
    _same(p)


def test_png_pillow_interlaced_and_optimized(tmp_path):
    """Pillow's own writer with its adaptive filters on a larger image."""
    rng = np.random.default_rng(3)
    arr = np.cumsum(rng.integers(-3, 4, (64, 80, 3)), axis=1) % 256
    p = tmp_path / 'x.png'
    Image.fromarray(arr.astype(np.uint8)).save(p, optimize=True)
    _same(p)


# -- BMP ------------------------------------------------------------------------

@pytest.mark.parametrize('mode', ['1', 'L', 'P', 'RGB'])
def test_bmp_pillow_modes(tmp_path, mode):
    p = tmp_path / 'x.bmp'
    _pil_image(mode, np.random.default_rng(2)).save(p)
    _same(p)


def _bmp_bytes(pixels, bits, header=40, top_down=False, masks=None,
               palette=None):
    """pixels: (h, stride-less row bytes) list, top row first."""
    h = len(pixels)
    w = pixels.shape[1] if bits >= 8 else None
    rows = [bytes(r) for r in pixels]
    stride = -(-max(len(r) for r in rows) // 4) * 4
    data = b''.join(r + bytes(stride - len(r))
                    for r in (rows if top_down else rows[::-1]))
    compression = 3 if masks else 0
    width = pixels.shape[1] * 8 // bits if bits < 8 else w // (bits // 8)
    info = struct.pack('<IiiHHIIiiII', header, width, -h if top_down else h, 1,
                       bits, compression, len(data), 2835, 2835,
                       0 if palette is None else len(palette) // 4, 0)
    if header >= 56 and masks:
        info += struct.pack('<IIII', *masks)
    info += bytes(header - len(info))
    extra = struct.pack('<III', *masks[:3]) if (masks and header == 40) else b''
    pal = palette or b''
    offset = 14 + header + len(extra) + len(pal)
    head = b'BM' + struct.pack('<IHHI', offset + len(data), 0, 0, offset)
    return head + info + extra + pal + data


@pytest.mark.parametrize('header', [40, 108, 124])
@pytest.mark.parametrize('top_down', [False, True])
@pytest.mark.parametrize('layout', ['1-gray', '1-color', '4', '8-gray',
                                    '8-color', '24', '32', '32-bgra',
                                    '32-rgba', '24-fields'])
def test_bmp_headers_depths_fields(tmp_path, header, top_down, layout):
    rng = np.random.default_rng(5)
    h, w = 7, 19
    pal, masks = None, None
    if layout.startswith('1'):
        bits = 1
        idx = rng.integers(0, 2, (h, w))
        pal = (bytes([0, 0, 0, 0, 255, 255, 255, 0]) if layout == '1-gray'
               else bytes([10, 20, 30, 0, 200, 100, 50, 0]))
        px = np.array([np.packbits(r) for r in idx.astype(np.uint8)])
    elif layout == '4':
        bits = 4
        idx = rng.integers(0, 16, (h, w + 1))
        pal = rng.integers(0, 256, 64).astype(np.uint8).tobytes()
        px = (idx[:, 0::2] << 4 | idx[:, 1::2]).astype(np.uint8)
    elif layout.startswith('8'):
        bits = 8
        px = rng.integers(0, 256, (h, w)).astype(np.uint8)
        pal = (bytes(np.repeat(np.arange(256), 4).astype(np.uint8)) if
               layout == '8-gray' else
               rng.integers(0, 256, 1024).astype(np.uint8).tobytes())
    else:
        bits = 24 if layout.startswith('24') else 32
        px = rng.integers(0, 256, (h, w * bits // 8)).astype(np.uint8)
        masks = {'32-bgra': (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                 '32-rgba': (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                 '24-fields': (0xFF0000, 0xFF00, 0xFF, 0)}.get(layout)
        if masks and header == 40:   # three masks after the header, no alpha
            masks = masks[:3] + (0,)
    p = tmp_path / 'x.bmp'
    p.write_bytes(_bmp_bytes(px, bits, header, top_down, masks, pal))
    if masks == (0xFF, 0xFF00, 0xFF0000, 0):  # a layout Pillow refuses too
        for io_ in (jax_io, port_io):
            with pytest.raises(ValueError):
                io_.read_image(str(p))
        return
    _same(p)


# -- TIFF -----------------------------------------------------------------------

@pytest.mark.parametrize('mode', ['1', 'L', 'I;16', 'I', 'F', 'RGB', 'RGBA',
                                  'LA', 'P'])
@pytest.mark.parametrize('compression', [None, 'packbits', 'tiff_lzw',
                                         'tiff_adobe_deflate'])
def test_tiff_pillow(tmp_path, mode, compression):
    p = tmp_path / 'x.tif'
    _pil_image(mode, np.random.default_rng(4)).save(p, compression=compression)
    _same(p)


@pytest.mark.parametrize('mode', ['L', 'I;16', 'RGB'])
@pytest.mark.parametrize('compression', ['tiff_lzw', 'tiff_adobe_deflate'])
def test_tiff_predictor(tmp_path, mode, compression):
    p = tmp_path / 'x.tif'
    _pil_image(mode, np.random.default_rng(6), (40, 300)).save(
        p, compression=compression, tiffinfo={317: 2})
    _same(p)


@pytest.mark.parametrize('compression', [None, 'packbits'])
def test_tiff_big_endian_16(tmp_path, compression):
    arr = np.random.default_rng(7).integers(0, 65536, (9, 11)).astype('>u2')
    p = tmp_path / 'x.tif'
    Image.frombytes('I;16B', (11, 9), arr.tobytes()).save(
        p, compression=compression)
    _same(p)


def _tiff_bytes(arr, bits, fmt, tile, big_endian=False, strip_rows=None):
    """A tiled (tile=(th, tw)) or striped uncompressed gray TIFF."""
    bo = '>' if big_endian else '<'
    h, w = arr.shape
    sample = np.dtype(arr.dtype).newbyteorder(bo)
    blocks, tags = [], {}
    if tile:
        th, tw = tile
        for y in range(0, h, th):
            for x in range(0, w, tw):
                b = np.zeros((th, tw), arr.dtype)
                part = arr[y:y + th, x:x + tw]
                b[:part.shape[0], :part.shape[1]] = part
                blocks.append(b.astype(sample).tobytes())
        tags.update({322: (4, [tw]), 323: (4, [th])})
        off_tag, cnt_tag = 324, 325
    else:
        rps = strip_rows or h
        for y in range(0, h, rps):
            blocks.append(arr[y:y + rps].astype(sample).tobytes())
        tags[278] = (4, [rps])
        off_tag, cnt_tag = 273, 279
    tags.update({256: (4, [w]), 257: (4, [h]), 258: (3, [bits]),
                 259: (3, [1]), 262: (3, [1]), 277: (3, [1]),
                 339: (3, [fmt])})
    n = len(tags) + 2
    data_at = 8 + 2 + 12 * n + 4 + 8 * len(blocks)
    offsets, at = [], data_at
    for b in blocks:
        offsets.append(at)
        at += len(b)
    tags[off_tag] = (4, offsets)
    tags[cnt_tag] = (4, [len(b) for b in blocks])
    ext_at = 8 + 2 + 12 * n + 4
    ifd = struct.pack(bo + 'H', n)
    ext = b''
    for tag in sorted(tags):
        typ, vals = tags[tag]
        if len(vals) == 1:
            v = struct.pack(bo + ('I' if typ == 4 else 'H'), vals[0])
            ifd += struct.pack(bo + 'HHI', tag, typ, 1) + v + bytes(4 - len(v))
        else:
            ifd += struct.pack(bo + 'HHII', tag, typ, len(vals),
                               ext_at + len(ext))
            ext += struct.pack(bo + 'I' * len(vals), *vals)
    ifd += struct.pack(bo + 'I', 0)
    ext += bytes(8 * len(blocks) - len(ext))
    head = (b'MM\0*' if big_endian else b'II*\0') + struct.pack(bo + 'I', 8)
    return head + ifd + ext + b''.join(blocks)


@pytest.mark.parametrize('dtype,bits,fmt', [
    (np.uint8, 8, 1), (np.uint16, 16, 1), (np.int16, 16, 2),
    (np.uint32, 32, 1), (np.int32, 32, 2), (np.float32, 32, 3)])
@pytest.mark.parametrize('tile', [None, (16, 16)])
def test_tiff_sample_formats_tiles_strips(tmp_path, dtype, bits, fmt, tile):
    """Unsigned, signed and float samples, in tiles cut at the edges and in
    strips of 3 rows, which divide the 21 rows (a short last strip:
    test_tiff_bytes_short_last_strip)."""
    rng = np.random.default_rng(bits + fmt)
    if np.issubdtype(dtype, np.floating):
        arr = rng.standard_normal((21, 35)).astype(dtype)
    else:
        info = np.iinfo(dtype)
        arr = rng.integers(info.min, info.max, (21, 35), dtype=np.int64)
        arr = arr.astype(dtype)
    p = tmp_path / 'x.tif'
    p.write_bytes(_tiff_bytes(arr, bits, fmt, tile, strip_rows=3))
    _same(p)


# -- strips: the last one short --------------------------------------------------

_MODE_BITS = {'1': 1, 'L': 8, 'P': 8, 'LA': 16, 'I;16': 16, 'I': 32, 'F': 32,
              'RGB': 24, 'RGBA': 32}


def _rows_per_strip(path):
    with Image.open(path) as im:
        return im.tag_v2[278], im.size[1]


def _assert_short_last_strip(path):
    rps, h = _rows_per_strip(path)
    assert h % rps != 0, (h, rps)   # else the case loses its point


@pytest.mark.parametrize('mode', ['1', 'L', 'I;16', 'I', 'F', 'RGB', 'RGBA',
                                  'LA', 'P'])
@pytest.mark.parametrize('compression', [None, 'packbits', 'tiff_lzw',
                                         'tiff_adobe_deflate'])
def test_tiff_pillow_short_last_strip(tmp_path, mode, compression):
    """Pillow's strips of 4 rows over 47: libtiff's writer takes them from
    ``strip_size``; its own uncompressed writer (one strip by default) from
    RowsPerStrip in ``tiffinfo``. The last strip holds 3 rows."""
    h, w = 47, 37
    p = tmp_path / 'x.tif'
    im = _pil_image(mode, np.random.default_rng(12), (h, w))
    if compression is None:
        im.save(p, tiffinfo={278: 4})
    else:
        im.save(p, compression=compression,
                strip_size=4 * -(-w * _MODE_BITS[mode] // 8))
    _assert_short_last_strip(p)
    _same(p)


@pytest.mark.parametrize('mode', ['L', 'RGB', 'F'])
@pytest.mark.parametrize('compression', ['packbits', 'tiff_adobe_deflate'])
def test_tiff_pillow_default_strips(tmp_path, mode, compression):
    """At 301 x 517 Pillow's 64 KiB strips hold 126, 42 or 31 rows: the
    last strip is short."""
    p = tmp_path / 'x.tif'
    _pil_image(mode, np.random.default_rng(13), (301, 517)).save(
        p, compression=compression)
    _assert_short_last_strip(p)
    _same(p)


@pytest.mark.parametrize('mode', ['L', 'I;16', 'RGB'])
@pytest.mark.parametrize('compression', ['tiff_lzw', 'tiff_adobe_deflate'])
def test_tiff_predictor_short_last_strip(tmp_path, mode, compression):
    h, w = 47, 61
    p = tmp_path / 'x.tif'
    _pil_image(mode, np.random.default_rng(14), (h, w)).save(
        p, compression=compression, tiffinfo={317: 2},
        strip_size=3 * -(-w * _MODE_BITS[mode] // 8))
    _assert_short_last_strip(p)
    _same(p)


@pytest.mark.parametrize('dtype,bits,fmt', [
    (np.uint8, 8, 1), (np.uint16, 16, 1), (np.int16, 16, 2),
    (np.float32, 32, 3)])
@pytest.mark.parametrize('strip_rows', [4, 5, 20])
@pytest.mark.parametrize('big_endian', [False, True])
def test_tiff_bytes_short_last_strip(tmp_path, dtype, bits, fmt, strip_rows,
                                     big_endian):
    rng = np.random.default_rng(bits + strip_rows)
    arr = (rng.standard_normal((21, 35)) * 1000).astype(dtype)
    p = tmp_path / 'x.tif'
    p.write_bytes(_tiff_bytes(arr, bits, fmt, None, big_endian=big_endian,
                              strip_rows=strip_rows))
    _assert_short_last_strip(p)
    np.testing.assert_array_equal(_same(p).array, arr)


def test_tiff_big_endian_signed(tmp_path):
    arr = np.random.default_rng(8).integers(-30000, 30000, (5, 7)).astype(np.int16)
    p = tmp_path / 'x.tif'
    p.write_bytes(_tiff_bytes(arr, 16, 2, None, big_endian=True))
    _same(p)


# -- corrupt, truncated and unsupported files -----------------------------------

@pytest.mark.parametrize('name,mode,cut', [
    ('x.png', 'RGB', 0.5), ('x.png', 'L', 0.95), ('x.bmp', 'RGB', 0.6),
    ('x.bmp', 'L', 0.2), ('x.tif', 'L', 0.5), ('x.tif', 'RGB', 0.1)])
def test_truncated_raise(tmp_path, name, mode, cut):
    p = tmp_path / name
    _pil_image(mode, np.random.default_rng(9), (40, 60)).save(p)
    data = p.read_bytes()
    p.write_bytes(data[:int(len(data) * cut)])
    with pytest.raises(ValueError):  # Pillow's own ValueError, or wrapped
        jax_io.read_image(str(p))
    with pytest.raises(ValueError, match='Corrupt raster image file'):
        port_io.read_image(str(p))


def test_decompression_bomb_raises(tmp_path):
    """A header that declares more pixels than Pillow's limit raises before
    anything of that size is allocated, as the reference does."""
    p = tmp_path / 'x.png'
    data = bytearray(_png_bytes(np.zeros((2, 2, 1), np.uint8), 8, 0,
                                interlace=True))
    ihdr = struct.pack('>IIBBBBB', 20000, 20000, 8, 0, 0, 0, 1)
    data[16:29] = ihdr
    data[29:33] = struct.pack('>I', zlib.crc32(b'IHDR' + ihdr))
    p.write_bytes(bytes(data))
    for io_ in (jax_io, port_io):
        with pytest.raises(ValueError, match='Corrupt raster image file'):
            io_.read_image(str(p))


def test_garbage_and_unsupported_raise(tmp_path):
    p = tmp_path / 'x.png'
    p.write_bytes(b'\0' * 16)
    with pytest.raises(ValueError, match='Corrupt raster image file'):
        port_io.read_image(str(p))
    rle = tmp_path / 'x.bmp'
    data = bytearray(_bmp_bytes(np.zeros((2, 4), np.uint8), 8, palette=bytes(1024)))
    data[30:34] = struct.pack('<I', 1)  # BI_RLE8
    rle.write_bytes(bytes(data))
    with pytest.raises(ValueError, match='RLE'):
        port_io.read_image(str(rle))
    jpeg = tmp_path / 'x.tif'
    _pil_image('L', np.random.default_rng(0)).save(jpeg, compression='jpeg')
    with pytest.raises(ValueError, match='compression 7'):
        port_io.read_image(str(jpeg))


# -- TIFF containment: every corrupt file is a ValueError ------------------------

def _sweep_bases():
    """The (13, 17) uint16 image tiled (16, 16), and as int16 in strips of
    5 rows (the last one short)."""
    img = np.random.default_rng(3).integers(0, 65536, (13, 17)).astype(np.uint16)
    return {'tiled': _tiff_bytes(img, 16, 1, (16, 16)),
            'strip': _tiff_bytes(img.astype(np.int16), 16, 2, None,
                                 strip_rows=5)}


def _edit_entry(data, tag, *, new_tag=None, typ=None, count=None, value=None):
    """A little-endian TIFF with one directory entry changed in place."""
    data = bytearray(data)
    (ifd,) = struct.unpack_from('<I', data, 4)
    (n,) = struct.unpack_from('<H', data, ifd)
    for k in range(n):
        at = ifd + 2 + 12 * k
        t, ty, c = struct.unpack_from('<HHI', data, at)
        if t == tag:
            struct.pack_into('<HHI', data, at, t if new_tag is None else new_tag,
                             ty if typ is None else typ,
                             c if count is None else count)
            if value is not None:
                struct.pack_into('<I', data, at + 8, value)
            return bytes(data)
    raise KeyError(tag)


@pytest.mark.parametrize('base,tag,edit,field', [
    ('tiled', 322, dict(new_tag=65000), 'TileWidth'),
    ('tiled', 323, dict(new_tag=65000), 'TileLength'),
    ('tiled', 325, dict(new_tag=65000), 'TileByteCounts'),
    ('tiled', 324, dict(count=1), 'TileOffsets'),
    ('tiled', 322, dict(value=0), 'TileWidth'),
    ('tiled', 256, dict(count=2), 'ImageWidth'),
    ('tiled', 256, dict(value=11), 'TileOffsets'),
    ('tiled', 257, dict(typ=5), 'ImageLength'),
    ('strip', 273, dict(new_tag=65000), 'StripOffsets'),
    ('strip', 279, dict(new_tag=65000), 'StripByteCounts'),
    ('strip', 278, dict(typ=11), 'RowsPerStrip'),
    ('strip', 278, dict(value=0), 'RowsPerStrip'),
    ('strip', 277, dict(typ=11), 'SamplesPerPixel'),
    ('strip', 277, dict(count=2), 'SamplesPerPixel'),
    ('strip', 257, dict(value=18), 'StripOffsets'),
    ('strip', 258, dict(typ=12), 'BitsPerSample'),
])
def test_tiff_bad_field_raises_naming_it(tmp_path, base, tag, edit, field):
    """A missing field, a count other than one where one value is read, a
    type other than an integer's, a zero dimension, and strips or tiles more
    or fewer than the geometry has: ``ValueError`` naming the field (once a
    KeyError, a TypeError or Python's own unpacking message)."""
    p = tmp_path / 'x.tif'
    p.write_bytes(_edit_entry(_sweep_bases()[base], tag, **edit))
    with pytest.raises(ValueError, match=f'Corrupt raster image file .*{field}'):
        port_io.read_image(str(p))


def test_tiff_extra_tiles_are_refused(tmp_path):
    """Two tiles where the geometry has one (ImageWidth 17 -> 11, a mutant of
    the sweep below): Pillow's own decoder paints the second tile again at
    the top-left corner (its planar layer wrap), libtiff drops it, the port
    refuses the file."""
    p = tmp_path / 'x.tif'
    p.write_bytes(_edit_entry(_sweep_bases()['tiled'], 256, value=11))
    img = np.random.default_rng(3).integers(0, 65536, (13, 17)).astype(np.uint16)
    pillow = jax_io.read_image(str(p)).array
    assert pillow.shape == (13, 11) and not np.array_equal(pillow, img[:, :11])
    with pytest.raises(ValueError, match='TileOffsets holds 2 values for 1'):
        port_io.read_image(str(p))


@pytest.mark.parametrize('base', ['tiled', 'strip'])
def test_tiff_mutation_sweep(tmp_path, base):
    """2,000 mutants of each base, 1-3 random bytes each (seed 11): every
    failure of the port is a ValueError, and where the reference's Pillow
    reader decodes too the arrays are equal, dtype included. Where Pillow
    leaks a foreign exception (OverflowError, TypeError), the port's
    ValueError counts as agreement."""
    data0 = _sweep_bases()[base]
    rng = np.random.default_rng(11)
    p = tmp_path / 'x.tif'
    both = 0
    for trial in range(2000):
        data = bytearray(data0)
        for _ in range(int(rng.integers(1, 4))):
            data[int(rng.integers(0, len(data)))] = int(rng.integers(0, 256))
        p.write_bytes(bytes(data))
        try:
            ours = port_io.read_image(str(p)).array
        except ValueError:
            continue
        try:
            ref = jax_io.read_image(str(p)).array
        except Exception:  # noqa: BLE001 - Pillow's refusal, or its leak
            continue
        assert ours.dtype == ref.dtype and np.array_equal(ours, ref), trial
        both += 1
    assert both >= 1000, both   # most mutants touch pixels only


def test_tiff_sample_count_is_checked_before_it_sizes_anything(tmp_path):
    """SamplesPerPixel 2**31 with one BitsPerSample value: refused before the
    value is repeated per sample (a mutant of the fuzzer's deflate strips
    once grew the process by gigabytes here)."""
    p = tmp_path / 'x.tif'
    p.write_bytes(_edit_entry(_sweep_bases()['strip'], 277, typ=4,
                             value=2 ** 31))
    with pytest.raises(ValueError, match='2147483648 samples per pixel'):
        port_io.read_image(str(p))
