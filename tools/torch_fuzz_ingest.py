"""Ingest containment fuzzer of the PyTorch port: every parser of untrusted
input in ``totalsegmentator2d_tpu_torch/io`` and the C hot loops of
``csrc/ts2dio.cc`` beneath them.

The port's counterpart of ``tools/fuzz_ingest.py``, with its contract: each
mutated or truncated file either decodes to a bounded array (at most 2^28
elements) or raises the format's documented error (``ValueError``;
``DicomError``, ``JpegError``, ``JpegLsError``, ``Jpeg2kError``, all
``ValueError`` subclasses). It never raises a foreign exception (KeyError,
TypeError, struct.error, zlib.error, ...), never hangs and never crashes
the interpreter. Its recipe too: seed 2026, 1-7 random bytes set per
mutation, then every K-th truncation of the base file.

    python tools/torch_fuzz_ingest.py [--trials N] [--truncation-step K]
        [--native on|off|both] [--targets NAME,...]

Targets: the reference's (NRRD gzip and raw, ``.nii`` and
``.nii.gz``, MetaImage compressed and raw, DICOM explicit VR, implicit VR
and RLE, PNG, a JPEG Lossless codestream), the port's own raster decoders
(BMP at 8 and 24 bits; TIFF in strips with a short last one and in tiles,
each uncompressed, LZW, Deflate and PackBits), the 8 stored DICOM fixtures
of ``tests/fixtures/dicom/`` whole, and their JPEG, JPEG-LS and JPEG 2000
codestreams fed straight to ``jpegdct``, ``jpegls`` and ``jpeg2k``. Every
base file is written here by the port's own writers (``io.write_image``,
``io.encode_png``) and by the small writers below, so the tool runs where
neither Pillow nor CharLS is installed; each base must decode to what was
written (the fixtures: to ``decoded.npz``) before its trials count.

Legs, each in a child process of the tool under 8 GiB of data (an
allocation past it is a leak): ``on`` with the native
library (it must load), ``off`` with ``TS2D_NO_NATIVE=1`` (the variable is
read once, at the library's first load), through every Python path. Where
both legs decode the same input, the arrays are equal bit for bit. Some
targets cap their decodes per leg (the Python JPEG 2000 path takes about a
second a slice); the cap cuts the mutations and widens the truncation
step. Each target prints its name, leg and seed before its trials, so a
native crash names its input (faulthandler is on); a target that runs past
10 minutes ends its leg with a traceback, and a child
that dies by a signal or overruns fails the run, never retried. Output:
one line per target and leg, ``leaked: N`` and one JSON summary line; the
exit code is 1 on any leak, crash, hang, base failure or leg mismatch.
"""

from __future__ import annotations

import argparse
import collections
import faulthandler
import hashlib
import json
import os
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from typing import Callable, List, NamedTuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SEED = 2026
#: seconds one target may take in one leg
TARGET_TIMEOUT = 600
#: GiB of data (private writable memory) a leg may hold
MAX_DATA_GIB = 8
#: the largest decoded array a trial may give (the reference's bound)
MAX_ELEMENTS = 1 << 28
FIXTURES = os.path.join(ROOT, 'tests', 'fixtures', 'dicom')
FIXTURE_CODECS = {'jpeg-baseline8': 'jpegdct', 'jpeg-extended12': 'jpegdct',
                  'jpegls-lossless': 'jpegls', 'jpegls-near': 'jpegls',
                  'j2k-53': 'jpeg2k', 'j2k-97': 'jpeg2k'}
FIXTURE_NAMES = ('rle', 'deflate', *FIXTURE_CODECS)
#: decodes per leg of the targets that cap them (mutations, and
#: truncations through a wider step); the others take every trial
CAPS = {'off': {'j2k-53.dcm': 8, 'j2k-97.dcm': 8, 'j2k-53': 16,
                'j2k-97': 16, 'jpegls-lossless.dcm': 200,
                'jpegls-near.dcm': 200, 'jpegls-lossless': 200,
                'jpegls-near': 200},
        'on': {'j2k-53.dcm': 400, 'j2k-97.dcm': 400, 'j2k-53': 400,
               'j2k-97': 400}}
TSYNTAX = {'explicit': '1.2.840.10008.1.2.1', 'implicit': '1.2.840.10008.1.2',
           'rle': '1.2.840.10008.1.2.5'}


class Target(NamedTuple):
    name: str
    decode: Callable       # bytes -> np.ndarray
    base: bytes
    error: type            # the documented error
    expect: np.ndarray     # what the base must decode to


# -- writers of the base files --------------------------------------------------

def packbits(data: bytes) -> bytes:
    """PackBits (TIFF compression 32773, and DICOM RLE's segments): runs of
    3-128 equal bytes as (257 - n, byte), the rest as literals of <= 128."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes((257 - (j - i), data[i]))
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes((j - i - 1,)) + data[i:j]
        i = j
    return bytes(out)


def lzw(data: bytes) -> bytes:
    """TIFF LZW (compression 5): MSB-first codes of 9-12 bits, clear 256 at
    the start and when the table fills, end 257, the width growing one code
    early, as libtiff writes it."""
    out, acc, nacc = bytearray(), 0, 0

    def emit(code, width):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 255)
        acc &= (1 << nacc) - 1

    def fresh():
        return {bytes((i,)): i for i in range(256)}, 258, 9

    table, nxt, width = fresh()
    emit(256, width)
    cur = b''
    for byte in data:
        ext = cur + bytes((byte,))
        if ext in table:
            cur = ext
            continue
        emit(table[cur], width)
        table[ext] = nxt
        nxt += 1
        if nxt >= 4094:
            emit(256, width)
            table, nxt, width = fresh()
        elif nxt >= (1 << width) and width < 12:
            width += 1
        cur = bytes((byte,))
    if cur:
        emit(table[cur], width)
        nxt += 1
        if nxt >= (1 << width) and width < 12:
            width += 1
    emit(257, width)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


TIFF_CODECS = {'raw': (1, lambda rows: rows.tobytes()),
               'lzw': (5, lambda rows: lzw(rows.tobytes())),
               'deflate': (8, lambda rows: zlib.compress(rows.tobytes())),
               'packbits': (32773, lambda rows: b''.join(
                   packbits(r.tobytes()) for r in rows))}


def tiff_bytes(arr: np.ndarray, codec: str, tile=None, strip_rows=None) -> bytes:
    """A little-endian gray TIFF of an unsigned integer array: tiles of
    ``tile`` = (th, tw), zero beyond the image, or strips of ``strip_rows``
    rows, the last one holding the rows that are left."""
    comp, encode = TIFF_CODECS[codec]
    h, w = arr.shape
    blocks, tags = [], {}
    if tile:
        th, tw = tile
        for y in range(0, h, th):
            for x in range(0, w, tw):
                b = np.zeros((th, tw), arr.dtype)
                part = arr[y:y + th, x:x + tw]
                b[:part.shape[0], :part.shape[1]] = part
                blocks.append(encode(b.astype('<' + arr.dtype.str[1:])
                                     .view(np.uint8)))
        tags.update({322: [tw], 323: [th]})
        off_tag, cnt_tag = 324, 325
    else:
        for y in range(0, h, strip_rows):
            blocks.append(encode(arr[y:y + strip_rows]
                                 .astype('<' + arr.dtype.str[1:])
                                 .view(np.uint8)))
        tags[278] = [strip_rows]
        off_tag, cnt_tag = 273, 279
    tags.update({256: [w], 257: [h], 258: [arr.dtype.itemsize * 8],
                 259: [comp], 262: [1], 277: [1], 339: [1],
                 off_tag: [0] * len(blocks), cnt_tag: [len(b) for b in blocks]})
    n = len(tags)
    ext_at = 8 + 2 + 12 * n + 4
    ext_size = sum(4 * len(v) for v in tags.values() if len(v) > 1)
    at = ext_at + ext_size
    for k, b in enumerate(blocks):
        tags[off_tag][k] = at
        at += len(b)
    ifd, ext = struct.pack('<H', n), b''
    for tag in sorted(tags):
        vals = tags[tag]
        if len(vals) == 1:
            ifd += struct.pack('<HHII', tag, 4, 1, vals[0])
        else:
            ifd += struct.pack('<HHII', tag, 4, len(vals), ext_at + len(ext))
            ext += struct.pack(f'<{len(vals)}I', *vals)
    return (b'II*\0' + struct.pack('<I', 8) + ifd + struct.pack('<I', 0)
            + ext + b''.join(blocks))


def bmp_bytes(pixels: np.ndarray) -> bytes:
    """A bottom-up BITMAPINFOHEADER BMP: (h, w) uint8 with the identity gray
    palette, or (h, w, 3) RGB at 24 bits."""
    h, w = pixels.shape[:2]
    bits = 8 if pixels.ndim == 2 else 24
    rows = pixels if bits == 8 else pixels[..., ::-1]   # BGR on the wire
    raw = rows.reshape(h, -1)
    stride = -(-raw.shape[1] // 4) * 4
    data = b''.join(bytes(r) + bytes(stride - len(r)) for r in raw[::-1])
    pal = bytes(np.repeat(np.arange(256), 4).astype(np.uint8)) if bits == 8 \
        else b''
    info = struct.pack('<IiiHHIIiiII', 40, w, h, 1, bits, 0, len(data), 2835,
                       2835, 256 if bits == 8 else 0, 0)
    offset = 14 + 40 + len(pal)
    return (b'BM' + struct.pack('<IHHI', offset + len(data), 0, 0, offset)
            + info + pal + data)


def dicom_bytes(arr: np.ndarray, syntax: str) -> bytes:
    """A single-frame CT slice of an int16 array, in explicit VR, implicit
    VR or RLE Lossless (each row PackBits-coded per byte plane)."""
    implicit = syntax == 'implicit'

    def el(group, elem, vr, value):
        if len(value) % 2:
            value += b'\0'
        if implicit and group != 2:
            return struct.pack('<HHI', group, elem, len(value)) + value
        head = struct.pack('<HH', group, elem) + vr
        if vr in (b'OB', b'OW', b'SQ', b'UN', b'UT'):
            return head + b'\0\0' + struct.pack('<I', len(value)) + value
        return head + struct.pack('<H', len(value)) + value

    rows, cols = arr.shape
    meta = el(2, 0x10, b'UI', TSYNTAX[syntax].encode())
    body = [el(0x20, 0x13, b'IS', b'1'), el(0x20, 0x32, b'DS', b'0\\0\\0'),
            el(0x20, 0x37, b'DS', b'1\\0\\0\\0\\1\\0'),
            el(0x28, 0x02, b'US', struct.pack('<H', 1)),
            el(0x28, 0x10, b'US', struct.pack('<H', rows)),
            el(0x28, 0x11, b'US', struct.pack('<H', cols)),
            el(0x28, 0x30, b'DS', b'0.8\\0.7'),
            el(0x28, 0x100, b'US', struct.pack('<H', 16)),
            el(0x28, 0x103, b'US', struct.pack('<H', 1))]
    if syntax == 'rle':
        big = arr.astype('>i2').view(np.uint8).reshape(rows, cols, 2)
        segs = []
        for plane in (big[..., 0], big[..., 1]):
            seg = b''.join(packbits(r.tobytes()) for r in plane)
            segs.append(seg + b'\x80' * (len(seg) % 2))
        frame = (struct.pack('<16I', 2, 64, 64 + len(segs[0]), *[0] * 13)
                 + segs[0] + segs[1])
        body.append(struct.pack('<HH', 0x7FE0, 0x10) + b'OB\0\0'
                    + struct.pack('<IHHI', 0xFFFFFFFF, 0xFFFE, 0xE000, 0)
                    + struct.pack('<HHI', 0xFFFE, 0xE000, len(frame)) + frame
                    + struct.pack('<HHI', 0xFFFE, 0xE0DD, 0))
    else:
        body.append(el(0x7FE0, 0x10, b'OW', arr.astype('<i2').tobytes()))
    return b'\0' * 128 + b'DICM' + meta + b''.join(body)


def jpegll_bytes(plane: np.ndarray) -> bytes:
    """A JPEG Lossless codestream (T.81 process 14, selection value 1) of a
    (rows, cols) uint16 plane at 16 bits, with a flat 5-bit Huffman code of
    the 17 difference categories."""
    rows, cols = plane.shape
    v = plane.astype(np.int64)
    pred = np.empty_like(v)
    pred[:, 1:] = v[:, :-1]
    pred[1:, 0] = v[:-1, 0]
    pred[0, 0] = 1 << 15
    d = (v - pred).ravel()
    d = np.where(d >= 32768, d - 65536, np.where(d < -32768, d + 65536, d))
    ssss = np.frexp(np.abs(d).astype(np.float64))[1].astype(np.int64)
    extra = np.where(ssss == 16, 0, np.where(d > 0, d, d + (1 << ssss) - 1))
    n_extra = np.where(ssss == 16, 0, ssss)
    bits = ''.join(format(int(s), '05b')
                   + (format(int(e), f'0{int(n)}b') if n else '')
                   for s, e, n in zip(ssss, extra, n_extra))
    bits += '1' * (-len(bits) % 8)
    packed = int(bits, 2).to_bytes(len(bits) // 8, 'big')
    data = packed.replace(b'\xff', b'\xff\x00')

    def seg(marker, payload):
        return bytes([0xFF, marker]) + struct.pack('>H', len(payload) + 2) \
            + payload

    counts = bytes(17 if n == 5 else 0 for n in range(1, 17))
    return (b'\xff\xd8' + seg(0xC4, b'\x00' + counts + bytes(range(17)))
            + seg(0xC3, bytes([16]) + struct.pack('>HH', rows, cols)
                  + bytes([1, 1, 0x11, 0]))
            + seg(0xDA, bytes([1, 1, 0x00, 1, 0, 0])) + data + b'\xff\xd9')


def stored_values(buf: bytes, rescaled: np.ndarray) -> np.ndarray:
    """A fixture's stored pixel values: its decoded (rescaled) array less
    the RescaleIntercept of its header (slope 1)."""
    at = buf.find(b'\x28\x00\x52\x10DS')
    if at < 0:
        return rescaled
    (n,) = struct.unpack_from('<H', buf, at + 6)
    return rescaled.astype(np.int64) - int(float(buf[at + 8:at + 8 + n].strip(b' \0')))


def fixture_codestream(buf: bytes) -> bytes:
    """The one frame of a fixture's encapsulated PixelData: its fragments
    after the Basic Offset Table item, joined."""
    at = buf.rindex(b'\xe0\x7f\x10\x00OB\0\0\xff\xff\xff\xff') + 12
    frags = []
    while True:
        group, elem, n = struct.unpack_from('<HHI', buf, at)
        at += 8
        if (group, elem) == (0xFFFE, 0xE0DD):
            return b''.join(frags[1:])
        frags.append(buf[at:at + n])
        at += n


# -- the targets ------------------------------------------------------------------

def _by_path(tmp: str, suffix: str) -> Callable:
    """read_image of the bytes written to a file with this suffix."""
    from totalsegmentator2d_tpu_torch.io import read_image
    path = os.path.join(tmp, 'trial' + suffix)

    def decode(data: bytes) -> np.ndarray:
        with open(path, 'wb') as f:
            f.write(data)
        return read_image(path).array
    return decode


def targets(tmp: str) -> List[Target]:
    from totalsegmentator2d_tpu_torch.io import (MedicalImage, encode_png,
                                                 jpeg2k, jpegdct, jpegll,
                                                 jpegls, write_image)
    from totalsegmentator2d_tpu_torch.io.dicom import DicomError
    out = []
    rng = np.random.default_rng(0)
    arr3 = rng.integers(-500, 1500, (4, 8, 9)).astype(np.int16)
    img = MedicalImage(array=arr3, spacing=(0.7, 0.8, 2.5))
    for name, compress in (('a.nrrd', True), ('b.nrrd', False),
                           ('c.nii', False), ('d.nii.gz', True),
                           ('e.mha', True), ('f.mha', False)):
        p = os.path.join(tmp, name)
        write_image(img, p, compress=compress)
        with open(p, 'rb') as f:
            base = f.read()
        out.append(Target(name, _by_path(tmp, name[1:]), base, ValueError,
                          arr3))
    arr2 = rng.integers(-500, 1500, (10, 12)).astype(np.int16)
    for syntax in ('explicit', 'implicit', 'rle'):
        out.append(Target(f'slice-{syntax}.dcm', _by_path(tmp, '.dcm'),
                          dicom_bytes(arr2, syntax), DicomError, arr2[None]))
    u16 = (arr2.astype(np.int32) + 1024).astype(np.uint16)
    out.append(Target('jll', jpegll.decode, jpegll_bytes(u16),
                      jpegll.JpegError, u16))
    u8 = rng.integers(0, 256, (11, 13)).astype(np.uint8)
    out.append(Target('x.png', _by_path(tmp, '.png'), encode_png(u8),
                      ValueError, u8))
    rgb = rng.integers(0, 256, (7, 10, 3)).astype(np.uint8)
    out.append(Target('x8.bmp', _by_path(tmp, '.bmp'), bmp_bytes(u8),
                      ValueError, u8))
    out.append(Target('x24.bmp', _by_path(tmp, '.bmp'), bmp_bytes(rgb),
                      ValueError, rgb))
    t16 = rng.integers(0, 65536, (21, 35)).astype(np.uint16)
    for codec in TIFF_CODECS:
        out.append(Target(f'strip-{codec}.tif', _by_path(tmp, '.tif'),
                          tiff_bytes(t16, codec, strip_rows=4), ValueError,
                          t16))
        out.append(Target(f'tile-{codec}.tif', _by_path(tmp, '.tif'),
                          tiff_bytes(t16, codec, tile=(16, 16)), ValueError,
                          t16))
    with np.load(os.path.join(FIXTURES, 'decoded.npz')) as z:
        stored = {n: z[n] for n in FIXTURE_NAMES}
    codecs = {'jpegdct': (jpegdct.decode, jpegll.JpegError),
              'jpegls': (jpegls.decode, jpegls.JpegLsError),
              'jpeg2k': (jpeg2k.decode, jpeg2k.Jpeg2kError)}
    for name in FIXTURE_NAMES:
        with open(os.path.join(FIXTURES, f'{name}.dcm'), 'rb') as f:
            base = f.read()
        out.append(Target(f'{name}.dcm', _by_path(tmp, '.dcm'), base,
                          DicomError, stored[name]))
        if name in FIXTURE_CODECS:
            decode, error = codecs[FIXTURE_CODECS[name]]
            out.append(Target(name, decode, fixture_codestream(base), error,
                              stored_values(base, stored[name][0])))
    return out


# -- one leg ----------------------------------------------------------------------

def _digest(arr: np.ndarray) -> str:
    h = hashlib.sha1(f'{arr.dtype.str}{arr.shape}'.encode())
    h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()[:16]


def _seed(name: str) -> list:
    return [SEED, zlib.crc32(name.encode())]


def run_leg(leg: str, trials: int, step: int, names=None) -> dict:
    """Every target's trials in this process, with the native library
    (``on``) or without it (``off``, where ``TS2D_NO_NATIVE`` is set):
    {'targets': {name: counts}, 'leaks': [...], 'bases': [...], 'digests':
    {name: {trial key: digest}}}."""
    from totalsegmentator2d_tpu_torch.io import native
    if native.native_available() != (leg == 'on'):
        raise SystemExit(f'leg {leg}: the native library is '
                         f'{"not " if leg == "on" else ""}loaded '
                         f'(TS2D_NO_NATIVE={os.environ.get("TS2D_NO_NATIVE")!r})')
    faulthandler.enable()
    report = {'targets': {}, 'leaks': [], 'bases': [], 'digests': {}}
    with tempfile.TemporaryDirectory(prefix='ts2d-fuzz-') as tmp:
        chosen = [t for t in targets(tmp) if names is None or t.name in names]
        for t in chosen:
            cap = CAPS[leg].get(t.name)
            n_mut = trials if cap is None else min(trials, cap)
            cut_step = step if cap is None else max(step,
                                                    -(-(len(t.base) - 1) // cap))
            print(f'== {t.name} leg {leg} seed {_seed(t.name)}: {n_mut} '
                  f'mutations, truncation step {cut_step}', flush=True)
            faulthandler.dump_traceback_later(TARGET_TIMEOUT, exit=True)
            t0 = time.perf_counter()
            counts = {'trials': n_mut, 'truncations': 0, 'decoded': 0,
                      'refused': 0, 'leaked': 0}
            digests = report['digests'][t.name] = {}

            def attempt(data: bytes, key: str) -> None:
                try:
                    arr = np.asarray(t.decode(data))
                    if arr.size > MAX_ELEMENTS:
                        raise MemoryError(f'unbounded allocation: {arr.shape}')
                except t.error:
                    counts['refused'] += 1
                    return
                except Exception as ex:  # noqa: BLE001 - the finding
                    counts['leaked'] += 1
                    report['leaks'].append(
                        f'{t.name} [{leg}] {key}: {type(ex).__name__}: '
                        f'{str(ex)[:120]}')
                    return
                counts['decoded'] += 1
                digests[key] = _digest(arr)

            try:
                got = np.asarray(t.decode(t.base))
            except Exception as ex:  # noqa: BLE001 - a valid file refused
                got = f'{type(ex).__name__}: {str(ex)[:160]}'
            if isinstance(got, str) or not (got.shape == t.expect.shape and
                                            np.array_equal(got, t.expect)):
                report['bases'].append(
                    f'{t.name} [{leg}]: the base file '
                    + (f'raised {got}' if isinstance(got, str) else
                       f'decoded to {got.dtype} {got.shape}, not what was '
                       f'written'))
            rng = np.random.default_rng(_seed(t.name))
            for i in range(n_mut):
                data = bytearray(t.base)
                for _ in range(int(rng.integers(1, 8))):
                    data[int(rng.integers(0, len(data)))] = \
                        int(rng.integers(0, 256))
                attempt(bytes(data), f'm{i}')
            for cut in range(1, len(t.base), cut_step):
                counts['truncations'] += 1
                attempt(t.base[:cut], f't{cut}')
            faulthandler.cancel_dump_traceback_later()
            counts['seconds'] = round(time.perf_counter() - t0, 3)
            report['targets'][t.name] = counts
    return report


def _limit_memory() -> None:
    """Caps this process's data (its private writable memory; not the
    address space, which a CUDA build reserves in bulk): an allocation past
    it raises MemoryError, which a trial reports as a leak."""
    import resource
    cap = MAX_DATA_GIB << 30
    resource.setrlimit(resource.RLIMIT_DATA, (cap, cap))


def _child_leg(leg: str, args, names) -> dict:
    """The leg in a child process of this tool (``off``: with
    ``TS2D_NO_NATIVE=1``) under the memory cap; a signal or an overrun is
    reported as such."""
    env = dict(os.environ)
    if leg == 'off':
        env['TS2D_NO_NATIVE'] = '1'
    else:
        env.pop('TS2D_NO_NATIVE', None)
    with tempfile.TemporaryDirectory(prefix='ts2d-fuzz-leg-') as tmp:
        out = os.path.join(tmp, 'leg.json')
        cmd = [sys.executable, os.path.abspath(__file__), '--leg', leg,
               '--out', out, '--trials', str(args.trials),
               '--truncation-step', str(args.truncation_step)]
        if names is not None:
            cmd += ['--targets', ','.join(sorted(names))]
        limit = TARGET_TIMEOUT * (len(names) if names else 64) + 120
        try:
            proc = subprocess.run(cmd, env=env, timeout=limit)
        except subprocess.TimeoutExpired:
            return {'failure': f'leg {leg}: the child ran past {limit:.0f} s'}
        if proc.returncode < 0:
            return {'failure': f'leg {leg}: the child died by signal '
                               f'{-proc.returncode} (the last == line above '
                               f'names its input)'}
        if proc.returncode != 0 or not os.path.exists(out):
            return {'failure': f'leg {leg}: the child exited '
                               f'{proc.returncode} (a target past '
                               f'{TARGET_TIMEOUT} s prints its traceback '
                               f'above)'}
        with open(out) as f:
            return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--trials', type=int, default=800)
    ap.add_argument('--truncation-step', type=int, default=3)
    ap.add_argument('--native', choices=('on', 'off', 'both'), default='both')
    ap.add_argument('--targets', default=None,
                    help='comma-separated target names (default: all)')
    ap.add_argument('--leg', choices=('on', 'off'), help=argparse.SUPPRESS)
    ap.add_argument('--out', help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    names = None if args.targets is None else set(args.targets.split(','))
    if args.leg:   # a child of the run below
        _limit_memory()
        report = run_leg(args.leg, args.trials, args.truncation_step, names)
        with open(args.out, 'w') as f:
            json.dump(report, f)
        return 0
    legs = ('on', 'off') if args.native == 'both' else (args.native,)
    reports = {}
    for leg in legs:
        reports[leg] = _child_leg(leg, args, names)
    failures = [r['failure'] for r in reports.values() if 'failure' in r]
    ran = {leg: r for leg, r in reports.items() if 'failure' not in r}
    leaks = [x for r in ran.values() for x in r['leaks']]
    bases = [x for r in ran.values() for x in r['bases']]
    mismatches, compared = [], 0
    if len(ran) == 2:   # the inputs both legs decoded: bit for bit equal
        on, off = ran['on']['digests'], ran['off']['digests']
        for name in sorted(set(on) & set(off)):
            for key in sorted(set(on[name]) & set(off[name])):
                compared += 1
                if on[name][key] != off[name][key]:
                    mismatches.append(f'{name} {key}: native and Python '
                                      f'decodes differ')
    for leg, r in ran.items():
        for name, c in r['targets'].items():
            print(f'{name} [{leg}]: {c["trials"]} mutations + '
                  f'{c["truncations"]} truncations: {c["decoded"]} decoded, '
                  f'{c["refused"]} refused, {c["leaked"]} leaked '
                  f'({c["seconds"]:.1f} s)')
    for kind, lines in (('FAIL', failures), ('BASE', bases),
                        ('LEAK', leaks[:50]), ('MISMATCH', mismatches[:50])):
        for line in lines:
            print(kind, line)
    print('leaked:', len(leaks))
    ok = not (failures or bases or leaks or mismatches)
    print(json.dumps({
        'ok': ok, 'legs': list(legs), 'targets': len(next(iter(
            ran.values()))['targets']) if ran else 0,
        'trials': sum(c['trials'] + c['truncations'] for r in ran.values()
                      for c in r['targets'].values()),
        'decoded': sum(c['decoded'] for r in ran.values()
                       for c in r['targets'].values()),
        'leaked': len(leaks), 'leaked_by_class': dict(sorted(
            collections.Counter(x.split(': ')[1] for x in leaks).items())),
        'base_failures': len(bases),
        'mismatches': len(mismatches), 'compared_across_legs': compared,
        'failures': failures}))
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
