"""Minimal DICOM CT-series reader (pure Python, no pydicom).

Neither the reference tool nor nnU-Net reads DICOM directly — users convert
series to NRRD/NIfTI first. CT data, however, arrives from scanners as
DICOM, so this package reads the common cases natively: uncompressed
little-endian transfer syntaxes (implicit 1.2.840.10008.1.2, explicit
1.2.840.10008.1.2.1, deflated 1.2.840.10008.1.2.1.99), RLE Lossless
(1.2.840.10008.1.2.5, the PackBits scheme — decoded in
_rle_decode_frame), JPEG Lossless (1.2.840.10008.1.2.4.57/.70, T.81
process 14 — the dominant compressed CT archive syntax, decoded in
io/jpegll.py with a native C hot loop), sequential lossy JPEG
(1.2.840.10008.1.2.4.50/.51, baseline 8-bit and extended 12-bit — what
CR/DX X-ray archives emit, decoded in io/jpegdct.py), JPEG-LS
(1.2.840.10008.1.2.4.80/.81, LOCO-I lossless and near-lossless, decoded
in io/jpegls.py), and JPEG 2000 (1.2.840.10008.1.2.4.90/.91, the PACS
archive syntax — reversible 5/3 and irreversible 9/7, decoded in
io/jpeg2k.py). Single-sample (grayscale) slices are assembled into one
(Z, Y, X) volume with full LPS geometry (DICOM's patient coordinate
system IS LPS, the framework's world frame — no conversion needed).

Multi-frame files are supported in both flavors: Enhanced CT (per-frame
plane positions in the Per-Frame Functional Groups Sequence (5200,9230),
shared orientation/spacing/rescale in the Shared Functional Groups
Sequence (5200,9229)) and legacy multi-frame (a single top-level
ImagePositionPatient advanced along the slice normal by
SpacingBetweenSlices (0018,0088), falling back to SliceThickness).

The module is the package's own copy of the reference package's reader:
the same arrays, geometry, error classes and messages.

Deliberately conservative: progressive-JPEG streams, color images, and
non-uniform slice stacks raise informative errors rather than guessing.

Geometry notes:
 - ImageOrientationPatient (0020,0037) gives the column-axis (x) and
   row-axis (y) direction cosines; the z column of the direction matrix
   comes from the actual slice-position delta (not the cross product), so
   flipped/descending stacks keep their true orientation.
 - PixelSpacing (0028,0030) is (row, col) = (y, x); ITK-order spacing is
   (x, y, z) with z from successive ImagePositionPatient distances.
 - Rescale slope/intercept (0028,1052/1053) are applied; integral results
   that fit int16 stay int16 (CT Hounsfield units), else float32.
 - Signed data narrower than its container sign-extends from BitsStored;
   MONOCHROME1 (lowest-value-is-white DX/CR) complements to MONOCHROME2
   polarity when the rescale is identity; PALETTE COLOR and Modality LUT
   sequences raise rather than passing wrong intensities through.
"""

from __future__ import annotations

import os
import struct
import threading as _threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import native
from .image import MedicalImage

_IMPLICIT_LE = '1.2.840.10008.1.2'
_EXPLICIT_LE = '1.2.840.10008.1.2.1'
_DEFLATED_LE = '1.2.840.10008.1.2.1.99'  # deflate-compressed explicit LE
_RLE_LOSSLESS = '1.2.840.10008.1.2.5'
_JPEG_LL = '1.2.840.10008.1.2.4.57'      # process 14, any predictor
_JPEG_LL_SV1 = '1.2.840.10008.1.2.4.70'  # process 14 selection value 1
_JPEG_BASE = '1.2.840.10008.1.2.4.50'    # baseline (process 1, 8-bit, lossy)
_JPEG_EXT = '1.2.840.10008.1.2.4.51'     # extended (process 2/4, 12-bit)
_JLS_LL = '1.2.840.10008.1.2.4.80'       # JPEG-LS, lossless only
_JLS_NEAR = '1.2.840.10008.1.2.4.81'     # JPEG-LS, near-lossless allowed
_J2K_LL = '1.2.840.10008.1.2.4.90'       # JPEG 2000, lossless only (5/3)
_J2K = '1.2.840.10008.1.2.4.91'          # JPEG 2000 (usually lossy 9/7)

# VRs whose explicit encoding uses a 2-byte reserved field + 4-byte length
_LONG_VRS = {b'OB', b'OW', b'OF', b'OD', b'OL', b'SQ', b'UC', b'UR',
             b'UT', b'UN'}

_ITEM = (0xFFFE, 0xE000)
_ITEM_DELIM = (0xFFFE, 0xE00D)
_SEQ_DELIM = (0xFFFE, 0xE0DD)

DICOM_EXTENSIONS = ('.dcm', '.dicom', '.ima')

# tags we collect (group, element) — at the top level and inside
# functional-group items (tag namespaces don't collide across levels)
_TAGS = {
    (0x0018, 0x0050): 'SliceThickness',
    (0x0018, 0x0088): 'SpacingBetweenSlices',
    (0x0020, 0x000E): 'SeriesInstanceUID',
    (0x0020, 0x0013): 'InstanceNumber',
    (0x0020, 0x0032): 'ImagePositionPatient',
    (0x0020, 0x0037): 'ImageOrientationPatient',
    (0x0028, 0x0002): 'SamplesPerPixel',
    (0x0028, 0x0004): 'PhotometricInterpretation',
    (0x0028, 0x0008): 'NumberOfFrames',
    (0x0028, 0x0010): 'Rows',
    (0x0028, 0x0011): 'Columns',
    (0x0028, 0x0030): 'PixelSpacing',
    (0x0028, 0x0100): 'BitsAllocated',
    (0x0028, 0x0101): 'BitsStored',
    (0x0028, 0x0103): 'PixelRepresentation',
    (0x0028, 0x1052): 'RescaleIntercept',
    (0x0028, 0x1053): 'RescaleSlope',
    (0x7FE0, 0x0010): 'PixelData',
}

# sequences parsed into lists of item dicts (everything else is skipped);
# the Enhanced-CT functional groups and the per-concept sequences inside
# their items (PS3.3 C.7.6.16)
_SEQ_TAGS = {
    (0x0020, 0x9113): 'PlanePositionSequence',
    (0x0020, 0x9116): 'PlaneOrientationSequence',
    (0x0028, 0x9110): 'PixelMeasuresSequence',
    (0x0028, 0x3000): 'ModalityLUTSequence',
    (0x0028, 0x9145): 'PixelValueTransformationSequence',
    (0x5200, 0x9229): 'SharedFunctionalGroups',
    (0x5200, 0x9230): 'PerFrameFunctionalGroups',
}


#: ceiling for a deflated dataset's decompressed size (PS3.5 A.5 files)
_DEFLATE_CAP = 1 << 30


class DicomError(ValueError):
    pass


def _read_file_meta(buf: bytes) -> Tuple[int, str]:
    """Return (offset of the first dataset element, transfer syntax UID).
    The file meta group (0002,xxxx) is always explicit VR little endian."""
    if len(buf) > 132 and buf[128:132] == b'DICM':
        pos = 132
    elif buf[:4] == b'DICM':  # preamble-less writers exist
        pos = 4
    else:
        # no file meta at all: raw implicit-LE dataset (legacy exports)
        return 0, _IMPLICIT_LE
    ts = _IMPLICIT_LE
    while pos + 8 <= len(buf):
        group, elem = struct.unpack_from('<HH', buf, pos)
        if group != 0x0002:
            break
        vr = buf[pos + 4:pos + 6]
        if vr in _LONG_VRS:
            (length,) = struct.unpack_from('<I', buf, pos + 8)
            value_at = pos + 12
        else:
            (length,) = struct.unpack_from('<H', buf, pos + 6)
            value_at = pos + 8
        if elem == 0x0010:
            ts = buf[value_at:value_at + length].decode(
                'ascii', 'replace').rstrip('\x00 ').strip()
        pos = value_at + length
    return pos, ts


def _element_header(buf: bytes, pos: int,
                    implicit: bool) -> Tuple[Tuple[int, int], int, int]:
    """Parse one data-element header at ``pos``; returns (tag, length,
    value offset). Delimiter pseudo-elements (group FFFE) always use the
    implicit 4-byte-length form, even in explicit files."""
    if pos + 8 > len(buf):
        raise DicomError('Truncated data element')
    group, elem = struct.unpack_from('<HH', buf, pos)
    tag = (group, elem)
    if implicit or group == 0xFFFE:
        (length,) = struct.unpack_from('<I', buf, pos + 4)
        return tag, length, pos + 8
    vr = buf[pos + 4:pos + 6]
    if vr in _LONG_VRS:
        (length,) = struct.unpack_from('<I', buf, pos + 8)
        return tag, length, pos + 12
    (length,) = struct.unpack_from('<H', buf, pos + 6)
    return tag, length, pos + 8


def _undef_content_implicit(buf: bytes, pos: int, implicit: bool) -> bool:
    """VR mode for an undefined-length element's CONTENT at header
    ``pos``: PS3.5 6.2.2 mandates implicit VR inside undefined-length UN
    elements even in explicit files (typical anonymizer output)."""
    return implicit or buf[pos + 4:pos + 6] == b'UN'


def _skip_sequence(buf: bytes, pos: int, implicit: bool) -> int:
    """Skip an undefined-length SQ value starting at ``pos``; returns the
    offset past the sequence delimiter. Items may themselves be
    undefined-length (terminated by an item delimiter, PS3.5 §7.5 — the
    standard layout scanners actually write) and may nest further
    sequences."""
    while True:
        tag, length, value_at = _element_header(buf, pos, implicit)
        if tag == _SEQ_DELIM:
            return value_at + length
        if tag != _ITEM:
            raise DicomError('Malformed sequence (expected an item)')
        if length == 0xFFFFFFFF:
            pos = _skip_item(buf, value_at, implicit)
        else:
            pos = value_at + length


def _skip_item(buf: bytes, pos: int, implicit: bool) -> int:
    """Skip an undefined-length item body (a stream of data elements up to
    the item delimiter)."""
    while True:
        tag, length, value_at = _element_header(buf, pos, implicit)
        if tag == _ITEM_DELIM:
            return value_at + length
        if length == 0xFFFFFFFF:  # nested undefined-length sequence/UN
            pos = _skip_sequence(
                buf, value_at, _undef_content_implicit(buf, pos, implicit))
        else:
            pos = value_at + length


def _parse_fragments(buf: bytes, pos: int) -> Tuple[bytes, List[bytes], int]:
    """Parse an encapsulated PixelData value (PS3.5 A.4): a Basic Offset
    Table item followed by the frame fragment items, closed by a sequence
    delimiter. Returns (Basic Offset Table bytes, fragments, offset past
    the delimiter)."""
    frags: List[bytes] = []
    bot = b''
    first = True
    while True:
        tag, length, value_at = _element_header(buf, pos, implicit=True)
        if tag == _SEQ_DELIM:
            return bot, frags, value_at + length
        if tag != _ITEM or length == 0xFFFFFFFF:
            raise DicomError('Malformed encapsulated PixelData')
        if first:  # the first item is the (possibly empty) BOT
            bot = buf[value_at:value_at + length]
        else:
            frags.append(buf[value_at:value_at + length])
        first = False
        pos = value_at + length


def _collect_one(out: dict, buf: bytes, tag, length: int, value_at: int,
                 implicit: bool, elem_pos: int) -> int:
    """Collect one non-PixelData element into ``out``; returns the offset
    past its value. Sequences in _SEQ_TAGS recurse into item dicts; other
    sequences are skipped."""
    seq_name = _SEQ_TAGS.get(tag)
    if seq_name is not None:
        out[seq_name], pos = _parse_seq_items(buf, value_at, length, implicit)
        return pos
    if length == 0xFFFFFFFF:
        return _skip_sequence(
            buf, value_at, _undef_content_implicit(buf, elem_pos, implicit))
    name = _TAGS.get(tag)
    if name:
        out[name] = buf[value_at:value_at + length]
    return value_at + length


def _parse_seq_items(buf: bytes, pos: int, length: int,
                     implicit: bool) -> Tuple[List[dict], int]:
    """Parse an SQ value into a list of item dicts (recursively collecting
    _TAGS/_SEQ_TAGS); handles defined- and undefined-length sequences and
    items. Returns (items, offset past the sequence)."""
    items: List[dict] = []
    end = None if length == 0xFFFFFFFF else pos + length
    while end is None or pos + 8 <= end:
        tag, ilen, value_at = _element_header(buf, pos, implicit)
        if tag == _SEQ_DELIM:
            return items, value_at + ilen
        if tag != _ITEM:
            raise DicomError('Malformed sequence (expected an item)')
        if ilen == 0xFFFFFFFF:
            item, pos = _parse_item_undef(buf, value_at, implicit)
        else:
            item = _parse_ds_span(buf, value_at, value_at + ilen, implicit)
            pos = value_at + ilen
        items.append(item)
    return items, end


def _parse_item_undef(buf: bytes, pos: int,
                      implicit: bool) -> Tuple[dict, int]:
    """Parse an undefined-length item body up to its item delimiter."""
    out: dict = {}
    while True:
        tag, length, value_at = _element_header(buf, pos, implicit)
        if tag == _ITEM_DELIM:
            return out, value_at + length
        pos = _collect_one(out, buf, tag, length, value_at, implicit, pos)


def _parse_ds_span(buf: bytes, pos: int, end: int, implicit: bool) -> dict:
    """Parse the data elements of a defined-length item value."""
    out: dict = {}
    while pos + 8 <= end:
        tag, length, value_at = _element_header(buf, pos, implicit)
        pos = _collect_one(out, buf, tag, length, value_at, implicit, pos)
    return out


def _parse_dataset(buf: bytes, pos: int, implicit: bool) -> Dict[str, object]:
    """Collect the raw value bytes of the tags in _TAGS (recursing into the
    functional-group sequences of _SEQ_TAGS); stop after PixelData."""
    out: Dict[str, object] = {}
    n = len(buf)
    while pos + 8 <= n:
        tag, length, value_at = _element_header(buf, pos, implicit)
        if length == 0xFFFFFFFF and _TAGS.get(tag) == 'PixelData':
            # encapsulated (compressed) PixelData: collect the raw
            # fragments; whether the compression is decodable is the
            # caller's decision based on the transfer syntax
            out['PixelDataBOT'], out['PixelDataFragments'], pos = \
                _parse_fragments(buf, value_at)
            return out
        pos = _collect_one(out, buf, tag, length, value_at, implicit, pos)
        if 'PixelData' in out:
            return out
    return out


def _ds(raw: Optional[bytes]) -> List[float]:
    if raw is None:
        return []
    text = raw.decode('ascii', 'replace').strip('\x00 ')
    return [float(v) for v in text.split('\\') if v.strip()]


def _us(raw: Optional[bytes], default: Optional[int] = None) -> Optional[int]:
    if raw is None or len(raw) < 2:
        return default
    return struct.unpack_from('<H', raw, 0)[0]


def _int(raw: Optional[bytes], default: int = 0) -> int:
    if raw is None:
        return default
    try:
        return int(raw.decode('ascii', 'replace').strip('\x00 ') or default)
    except ValueError:
        return default


def _rle_decode_segment(data: bytes, expected: int) -> bytes:
    """PackBits decode (PS3.5 G.3.1): control byte n in [0,127] copies the
    next n+1 literal bytes, n in [129,255] repeats the next byte 257-n
    times, n=128 is a no-op. Stops once ``expected`` bytes are produced
    (encoders may pad the segment to even length)."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < expected:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:
            if i >= n:
                break
            out += data[i:i + 1] * (257 - h)
            i += 1
    if len(out) < expected:
        raise DicomError(f'Short RLE segment: {len(out)} of {expected} bytes')
    return bytes(out[:expected])


def _rle_decode_frame(frame: bytes, rows: int, cols: int,
                      bytes_per_sample: int) -> np.ndarray:
    """Decode one RLE frame (PS3.5 Annex G) into a (rows, cols) uint8 or
    uint16 array. The 64-byte header holds the segment count + 15 segment
    offsets; multi-byte samples split into one PackBits segment per byte
    plane, most significant first."""
    if len(frame) < 64:
        raise DicomError('RLE frame shorter than its 64-byte header')
    nseg = struct.unpack_from('<I', frame, 0)[0]
    offsets = struct.unpack_from('<15I', frame, 4)
    if nseg != bytes_per_sample:
        raise DicomError(
            f'RLE frame has {nseg} segments; expected {bytes_per_sample} '
            f'(grayscale, {bytes_per_sample * 8}-bit)')
    npix = rows * cols
    planes = []
    for s in range(nseg):
        start = offsets[s]
        end = offsets[s + 1] if s + 1 < nseg else len(frame)
        if not (64 <= start <= end <= len(frame)):
            raise DicomError('RLE segment offsets out of bounds')
        planes.append(np.frombuffer(
            _rle_decode_segment(frame[start:end], npix), np.uint8))
    if nseg == 1:
        return planes[0].reshape(rows, cols)
    # composite pixel code, most significant byte plane first
    val = (planes[0].astype(np.uint16) << 8) | planes[1]
    return val.reshape(rows, cols)


def _frame_codestreams(frags: List[bytes], bot: bytes, nframes: int,
                       name: str) -> List[bytes]:
    """Split the encapsulated fragment list into one JPEG codestream per
    frame: one fragment per frame when the counts match, else via the
    Basic Offset Table (each BOT entry is the byte offset of a frame's
    first fragment item header within the fragment stream, PS3.5 A.4)."""
    if nframes == 1:
        return [b''.join(frags)]
    if len(frags) == nframes:
        return list(frags)
    if len(bot) == 4 * nframes:
        offsets = struct.unpack(f'<{nframes}I', bot)
        starts, p = {}, 0
        for i, f in enumerate(frags):
            starts[p] = i
            p += 8 + len(f)
        try:
            idx = [starts[o] for o in offsets]
        except KeyError:
            raise DicomError(f'{name}: Basic Offset Table entries do not '
                             f'land on fragment boundaries')
        if idx != sorted(idx) or idx[0] != 0:
            raise DicomError(f'{name}: malformed Basic Offset Table')
        bounds = idx + [len(frags)]
        return [b''.join(frags[bounds[k]:bounds[k + 1]])
                for k in range(nframes)]
    raise DicomError(
        f'{name}: cannot split {len(frags)} fragments into {nframes} '
        f'frames (no usable Basic Offset Table)')


def _first_item(container: dict, seq: str) -> dict:
    items = container.get(seq)
    return items[0] if items else {}


def read_dicom_file(path: str) -> dict:
    """Parse one DICOM file into {frames: [{array (Y, X), position}, ...],
    orientation, pixel_spacing, instance, series_uid} (plus array/position
    aliases of frame 0). Multi-frame files yield one entry per frame:
    Enhanced-CT per-frame plane positions, or legacy top-level position +
    SpacingBetweenSlices. Raises DicomError on unsupported encodings AND
    on malformed files (corrupt numeric strings, truncated headers —
    parser internals must not leak as foreign exception types)."""
    from .image import PARSER_ERRORS
    try:
        return _read_dicom_file(path)
    except DicomError:
        raise
    except (ValueError, *PARSER_ERRORS) as ex:
        raise DicomError(
            f'{os.path.basename(path)}: corrupt DICOM file '
            f'({type(ex).__name__}: {ex})') from ex


def _read_dicom_file(path: str) -> dict:
    name = os.path.basename(path)
    with open(path, 'rb') as f:
        buf = f.read()
    pos, ts = _read_file_meta(buf)
    rle = False
    jpeg_decode = None  # codestream -> (rows, cols) array, for jpeg syntaxes
    if ts == _IMPLICIT_LE:
        implicit = True
    elif ts == _EXPLICIT_LE:
        implicit = False
    elif ts == _DEFLATED_LE:
        # PS3.5 A.5: everything after the file meta group is one raw
        # deflate stream (no zlib header) of an explicit-VR-LE dataset
        import zlib
        cap = _DEFLATE_CAP  # deflate reaches ~1030:1 — bombs must fail fast
        try:
            d = zlib.decompressobj(-15)
            chunks = []
            total = 0
            data = buf[pos:]
            while True:
                chunk = d.decompress(data, 1 << 24)
                data = b''
                if not chunk and not d.unconsumed_tail:
                    break
                chunks.append(chunk)
                total += len(chunk)
                if total > cap:
                    raise DicomError(
                        f'{name}: deflated dataset exceeds {cap} bytes')
                data = d.unconsumed_tail
            # raw deflate carries no checksum; an unterminated stream is
            # the only sign of truncation/corruption
            if not d.eof:
                raise DicomError(f'{name}: corrupt deflated dataset '
                                 f'(stream ends mid-block)')
            buf = b''.join(chunks)
        except zlib.error as ex:
            raise DicomError(
                f'{name}: corrupt deflated dataset ({ex})') from ex
        pos = 0
        implicit = False
    elif ts == _RLE_LOSSLESS:
        implicit, rle = False, True
    elif ts in (_JPEG_LL, _JPEG_LL_SV1):
        from .jpegll import decode as jpeg_decode
        implicit = False
    elif ts in (_JPEG_BASE, _JPEG_EXT):
        from .jpegdct import decode as jpeg_decode
        implicit = False
    elif ts in (_JLS_LL, _JLS_NEAR):
        from .jpegls import decode as jpeg_decode
        implicit = False
    elif ts in (_J2K_LL, _J2K):
        from .jpeg2k import decode as jpeg_decode
        implicit = False
    else:
        raise DicomError(
            f'Unsupported transfer syntax {ts} in {name} '
            f'(little endian incl. deflated, RLE lossless, JPEG lossless, '
            f'sequential lossy JPEG, JPEG-LS, and JPEG 2000 are read '
            f'natively; convert other series to NRRD/NIfTI)')
    el = _parse_dataset(buf, pos, implicit)
    rows, cols = _us(el.get('Rows')), _us(el.get('Columns'))
    if not rows or not cols:
        raise DicomError(f'{name}: missing Rows/Columns')
    if _us(el.get('SamplesPerPixel'), 1) != 1:
        raise DicomError('Only single-sample (grayscale) images are supported')
    nframes = _int(el.get('NumberOfFrames'), 1)
    if nframes < 1:
        raise DicomError(f'{name}: NumberOfFrames={nframes}')
    bits = _us(el.get('BitsAllocated'), 16)
    signed = _us(el.get('PixelRepresentation'), 0) == 1
    dtype = {(8, False): np.uint8, (8, True): np.int8,
             (16, False): np.uint16, (16, True): np.int16}.get((bits, signed))
    if dtype is None:
        raise DicomError(f'Unsupported BitsAllocated={bits}')

    shared = _first_item(el, 'SharedFunctionalGroups')
    perframe = el.get('PerFrameFunctionalGroups') or []
    if perframe and len(perframe) != nframes:
        raise DicomError(
            f'{name}: {len(perframe)} per-frame functional groups for '
            f'{nframes} frames')

    if rle or jpeg_decode is not None:
        frags = el.get('PixelDataFragments')
        if not frags:
            raise DicomError(
                f'{name}: compressed file without encapsulated PixelData '
                f'fragments')
        if rle:
            # PS3.5 G.2: an RLE frame occupies exactly one fragment
            if len(frags) != nframes:
                raise DicomError(
                    f'{name}: {len(frags)} RLE fragments for {nframes} '
                    f'frames (PS3.5 G.2 requires one per frame)')
            frames = [_rle_decode_frame(f, rows, cols, bits // 8)
                      for f in frags]
        else:
            # a JPEG frame may be SPLIT across fragments (PS3.5 A.4)
            from .jpegll import JpegError
            from .jpeg2k import Jpeg2kError
            from .jpegls import JpegLsError
            streams = _frame_codestreams(frags, el.get('PixelDataBOT', b''),
                                         nframes, name)
            frames = []
            for cs in streams:
                try:
                    arr = jpeg_decode(cs)
                except (JpegError, Jpeg2kError, JpegLsError) as ex:
                    raise DicomError(f'{name}: {ex}') from ex
                if arr.shape != (rows, cols):
                    raise DicomError(
                        f'{name}: JPEG frame is {arr.shape[0]}x'
                        f'{arr.shape[1]}, dataset says {rows}x{cols}')
                frames.append(arr)
        frames = [a.view(dtype) if a.itemsize == np.dtype(dtype).itemsize
                  else a.astype(dtype) for a in frames]
        vol = np.stack(frames)
    else:
        pix = el.get('PixelData')
        if pix is None:
            if el.get('PixelDataFragments') is not None:
                raise DicomError(
                    f'{name}: encapsulated PixelData in an uncompressed '
                    f'transfer syntax is not supported')
            raise DicomError(f'{name}: no PixelData')
        need = rows * cols * (bits // 8) * nframes
        if len(pix) < need:
            raise DicomError(f'{name}: truncated PixelData')
        vol = np.frombuffer(pix[:need], dtype=dtype).reshape(
            nframes, rows, cols)

    # signed data narrower than its container is two's complement of
    # BitsStored bits (PS3.5 §8.1.1): sign-extend, e.g. 12-bit -1 stored
    # as 0x0FFF. Identity for values already within the BitsStored range,
    # so decoders that emit proper signed values (JPEG 2000) are safe.
    bits_stored = _us(el.get('BitsStored'), bits)
    if signed and 0 < bits_stored < bits:
        shift = np.int8(bits - bits_stored)
        vol = np.left_shift(vol, shift) >> shift

    # PhotometricInterpretation (PS3.3 C.7.6.3.1.2): MONOCHROME1 means
    # the LOWEST stored value displays white (common in DX/CR X-rays) —
    # normalize to MONOCHROME2 polarity by complementing within the
    # stored range, or the models see inverted anatomy. PALETTE COLOR
    # would silently decode palette indices as intensities: reject.
    photo = bytes(el.get('PhotometricInterpretation') or b'').decode(
        'ascii', 'replace').strip('\x00 ').upper()
    if photo.startswith('PALETTE'):
        raise DicomError(f'{name}: PALETTE COLOR images are not supported')
    mono1 = photo == 'MONOCHROME1'

    # a Modality LUT (the table-based alternative to rescale
    # slope/intercept, PS3.3 C.11.1) would silently leave raw stored
    # values posing as output units if ignored
    if el.get('ModalityLUTSequence'):
        raise DicomError(
            f'{name}: Modality LUT sequences are not supported '
            f'(only linear RescaleSlope/Intercept transforms)')

    # rescale: top level, else the Pixel Value Transformation functional
    # group (shared, or per-frame when identical across frames)
    sl_raw, in_raw = el.get('RescaleSlope'), el.get('RescaleIntercept')
    if sl_raw is None and in_raw is None:
        pvt = _first_item(shared, 'PixelValueTransformationSequence')
        if not pvt and perframe:
            pvts = [_first_item(fg, 'PixelValueTransformationSequence')
                    for fg in perframe]
            vals = {(bytes(p.get('RescaleSlope') or b''),
                     bytes(p.get('RescaleIntercept') or b''))
                    for p in pvts}
            if len(vals) > 1:
                raise DicomError(f'{name}: per-frame rescale transforms '
                                 f'differ between frames')
            pvt = pvts[0]
        sl_raw, in_raw = pvt.get('RescaleSlope'), pvt.get('RescaleIntercept')
    slope = (_ds(sl_raw) or [1.0])[0]
    inter = (_ds(in_raw) or [0.0])[0]
    if mono1:
        if slope == 1.0 and inter == 0.0:
            # display-referenced data (DX/CR/MG): complement within the
            # stored range so models always see MONOCHROME2 polarity
            bs = bits_stored if 0 < bits_stored <= bits else bits
            if signed:
                vol = (-1 - vol.astype(np.int32)).astype(vol.dtype)
            else:
                vol = (((1 << bs) - 1)
                       - vol.astype(np.int64)).astype(vol.dtype)
        else:
            # MONOCHROME1 with a calibrated rescale is contradictory —
            # inverting physical units would corrupt them; keep values
            from ..utils.logging import warn
            warn(f'{name}: MONOCHROME1 with a non-identity rescale; '
                 f'keeping calibrated values un-inverted', once=True)
    if slope != 1.0 or inter != 0.0:
        scaled = vol.astype(np.float64) * slope + inter
        if float(slope).is_integer() and float(inter).is_integer() \
                and scaled.min() >= -32768 and scaled.max() <= 32767:
            vol = scaled.astype(np.int16)  # CT Hounsfield units
        else:
            vol = scaled.astype(np.float32)

    # orientation: top level, else the Plane Orientation functional group
    # (shared, or per-frame when identical across frames)
    iop_raw = el.get('ImageOrientationPatient')
    orientation = _ds(iop_raw)
    if not orientation:
        po = _first_item(shared, 'PlaneOrientationSequence')
        orientation = _ds(po.get('ImageOrientationPatient'))
    if perframe:
        pf_iops = [_ds(_first_item(fg, 'PlaneOrientationSequence')
                       .get('ImageOrientationPatient')) for fg in perframe]
        pf_iops = [o for o in pf_iops if o]
        if pf_iops:
            if not orientation:
                orientation = pf_iops[0]
            for o in pf_iops:
                if not np.allclose(o, orientation, atol=1e-4):
                    raise DicomError(
                        f'{name}: frames disagree on ImageOrientationPatient '
                        f'(tilted-gantry multi-frame is not supported)')

    # pixel spacing: top level, else the Pixel Measures functional group
    # (shared, or per-frame when identical across frames — differing
    # per-frame spacings would silently build wrong physical geometry, so
    # they raise like the orientation/rescale disagreements above)
    pixel_spacing = _ds(el.get('PixelSpacing'))
    pm = _first_item(shared, 'PixelMeasuresSequence') or \
        (_first_item(perframe[0], 'PixelMeasuresSequence') if perframe
         else {})
    if not pixel_spacing:
        pixel_spacing = _ds(pm.get('PixelSpacing'))
    if perframe:
        pf_ps = [_ds(_first_item(fg, 'PixelMeasuresSequence')
                     .get('PixelSpacing')) for fg in perframe]
        pf_ps = [p for p in pf_ps if p]
        if pf_ps:
            if not pixel_spacing:
                pixel_spacing = pf_ps[0]
            for p in pf_ps:
                if not np.allclose(p, pixel_spacing, atol=1e-6):
                    raise DicomError(
                        f'{name}: frames disagree on PixelSpacing '
                        f'(mixed-resolution multi-frame is not supported)')

    # per-frame positions: Enhanced-CT plane positions, else legacy
    # top-level position advanced along the slice normal
    positions: List[List[float]] = []
    if perframe:
        positions = [_ds(_first_item(fg, 'PlanePositionSequence')
                         .get('ImagePositionPatient')) for fg in perframe]
        if not all(len(p) == 3 for p in positions):
            positions = []
    if not positions:
        ipp = _ds(el.get('ImagePositionPatient'))
        if nframes == 1:
            positions = [ipp]
        else:
            dz_raw = el.get('SpacingBetweenSlices') or pm.get(
                'SpacingBetweenSlices') or el.get('SliceThickness') or \
                pm.get('SliceThickness')
            dz = (_ds(dz_raw) or [0.0])[0]
            if not ipp or dz <= 0:
                raise DicomError(
                    f'{name}: multi-frame file without per-frame plane '
                    f'positions needs ImagePositionPatient and '
                    f'SpacingBetweenSlices/SliceThickness to derive the '
                    f'frame geometry')
            o = orientation or [1, 0, 0, 0, 1, 0]
            normal = np.cross(np.asarray(o[0:3], float),
                              np.asarray(o[3:6], float))
            positions = [list(np.asarray(ipp, float) + i * dz * normal)
                         for i in range(nframes)]

    uid = el.get('SeriesInstanceUID')
    frames_out = [{'array': vol[i], 'position': positions[i]}
                  for i in range(nframes)]
    return {
        'frames': frames_out,
        'array': frames_out[0]['array'],
        'position': frames_out[0]['position'],
        'orientation': orientation,
        'pixel_spacing': pixel_spacing,
        'instance': _int(el.get('InstanceNumber')),
        'series_uid': (uid.decode('ascii', 'replace').rstrip('\x00 ').strip()
                       if uid else ''),
        'path': path,
    }


def _series_files(path: str) -> List[str]:
    files = sorted(
        os.path.join(path, f) for f in os.listdir(path)
        if f.lower().endswith(DICOM_EXTENSIONS) and not f.startswith('.'))
    if not files:
        raise DicomError(f'No DICOM files (*.dcm) found in {path}')
    return files


_decode_pool = None
_decode_pool_lock = _threading.Lock()


def _series_decode_pool():
    """One shared, lazily created pool for series decoding: per-call
    pools would multiply under concurrent serve requests (one HTTP thread
    each), oversubscribing the cores the batching work keeps busy."""
    global _decode_pool
    with _decode_pool_lock:
        if _decode_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            _decode_pool = ThreadPoolExecutor(
                min(8, os.cpu_count() or 1),
                thread_name_prefix='ts2d-dicom')
        return _decode_pool


def _pooled_read(path: str):
    """read_dicom_file inside a series-pool worker: mark the thread so
    nested per-stage pools (io/jpeg2k.py's code-block fan-out) stay
    serial — file-level threading already saturates the cores."""
    native.decode_worker_local.in_file_worker = True
    try:
        return read_dicom_file(path)
    finally:
        native.decode_worker_local.in_file_worker = False


def resolve_series_root(root: str) -> str:
    """Find the DICOM series directory inside ``root``: archives commonly
    wrap the series in a directory chain (and Finder zips add __MACOSX/
    and ._* AppleDouble entries beside it) — descend through real
    subdirectories while no DICOM files are present, ignoring the junk.
    Raises DicomError when no series is found."""
    def entries(d):
        return [f for f in os.listdir(d)
                if not f.startswith('.') and f != '__MACOSX']

    def has_dicom(d):
        return any(f.lower().endswith(DICOM_EXTENSIONS) for f in entries(d))

    seen = set()
    while not has_dicom(root):
        real = os.path.realpath(root)
        if real in seen:  # a directory-symlink cycle would loop forever
            raise DicomError('No DICOM series found in the archive')
        seen.add(real)
        subs = [os.path.join(root, f) for f in entries(root)]
        if len(subs) != 1 or not os.path.isdir(subs[0]):
            raise DicomError('No DICOM series found in the archive')
        root = subs[0]
    return root


def read_dicom_series(path: str) -> MedicalImage:
    """Read a directory of DICOM slice files (or one file, possibly
    multi-frame) into a 3D MedicalImage with LPS geometry."""
    files = _series_files(path) if os.path.isdir(path) else [path]
    # Slice files decode independently, and the codec hot loops (zlib,
    # jpegll/jpegdct/jpegls/jpeg2k in csrc) run outside the GIL through
    # ctypes — a shared thread pool scales compressed-series ingest with
    # cores. Codec decode is compute-bound per thread, as the host
    # projection is, which threads over z slabs for the same reason
    # (io/native.project_max_mean). Serial below 4 files or on single-core
    # hosts.
    if (os.cpu_count() or 1) > 1 and len(files) >= 4:
        parsed = list(_series_decode_pool().map(_pooled_read, files))
    else:
        parsed = [read_dicom_file(f) for f in files]

    uids = {p['series_uid'] for p in parsed if p['series_uid']}
    if len(uids) > 1:
        raise DicomError(
            f'{len(uids)} different series in one directory (mixed '
            f'SeriesInstanceUIDs); separate the series first')

    # flatten multi-frame files into one slice list (geometry tags are
    # per FILE; every frame of a file inherits them)
    slices = [{'array': fr['array'], 'position': fr['position'],
               'orientation': p['orientation'],
               'pixel_spacing': p['pixel_spacing']}
              for p in parsed for fr in p['frames']]

    first = slices[0]
    # reference tags come from the first slice that HAS them — a missing
    # tag on slice 1 must not silence the consistency checks (or default
    # the orientation to identity when the rest of the stack is tilted)
    ref_iop = next((s['orientation'] for s in slices if s['orientation']),
                   None)
    ref_ps = next((s['pixel_spacing'] for s in slices if s['pixel_spacing']),
                  None)
    for s in slices:
        if s['array'].shape != first['array'].shape:
            raise DicomError('Slices disagree on Rows/Columns')
        if ref_iop and s['orientation'] and not np.allclose(
                s['orientation'], ref_iop, atol=1e-4):
            raise DicomError('Slices disagree on ImageOrientationPatient '
                             '(mixed series?)')
        if ref_ps and s['pixel_spacing'] and not np.allclose(
                s['pixel_spacing'], ref_ps, rtol=1e-4):
            raise DicomError('Slices disagree on PixelSpacing')

    iop = ref_iop or [1, 0, 0, 0, 1, 0]
    if len(iop) != 6:
        # a corrupt ImageOrientationPatient with the wrong multiplicity
        # would otherwise surface as numpy shape errors downstream
        raise DicomError(
            f'ImageOrientationPatient has {len(iop)} values (expected 6)')
    x_dir = np.asarray(iop[0:3], float)
    y_dir = np.asarray(iop[3:6], float)
    normal = np.cross(x_dir, y_dir)

    for s in slices:
        if s['position'] and len(s['position']) != 3:
            raise DicomError(
                f'ImagePositionPatient has {len(s["position"])} values '
                f'(expected 3)')
    n_pos = sum(len(s['position']) == 3 for s in slices)
    if len(slices) > 1 and n_pos < len(slices):
        # guessing dz (and slice order) would silently produce wrong
        # physical geometry — refuse ("conservative, raise rather than
        # guess"); single slices fall through with dz=1
        raise DicomError(
            f'ImagePositionPatient present on {n_pos}/{len(slices)} slices; '
            f'cannot derive slice order/spacing — fix or convert the series')
    if len(slices) > 1:
        slices.sort(key=lambda s: float(np.dot(s['position'], normal)))
        locs = np.asarray([np.dot(s['position'], normal) for s in slices])
        deltas = np.diff(locs)
        if np.any(deltas <= 0):
            raise DicomError('Duplicate slice positions in the series')
        dz = float(np.median(deltas))
        if np.any(np.abs(deltas - dz) > max(1e-3, 0.01 * dz)):
            raise DicomError(
                f'Non-uniform slice spacing (deltas {deltas.min():.4f}..'
                f'{deltas.max():.4f} mm); resample the series first')
        z_dir = (np.asarray(slices[-1]['position'], float)
                 - np.asarray(slices[0]['position'], float))
        z_dir = z_dir / np.linalg.norm(z_dir)
    else:  # single slice: unit z spacing, normal from the orientation
        dz = 1.0
        z_dir = normal

    ps = ref_ps or [1.0, 1.0]
    spacing = (float(ps[1]), float(ps[0]), dz)  # (x, y, z): PixelSpacing is (row, col)
    origin = tuple(slices[0]['position']) if slices[0]['position'] \
        else (0.0, 0.0, 0.0)
    direction = np.stack([x_dir, y_dir, z_dir], axis=1)

    shapes = {s['array'].shape for s in slices}
    if len(shapes) > 1:
        # np.stack's bare ValueError would leak past the DicomError
        # contract (and its message names numpy, not the file problem)
        raise DicomError(
            f'Inconsistent slice shapes in series: {sorted(shapes)}')
    vol = np.stack([s['array'] for s in slices])  # (Z, Y, X)
    return MedicalImage(array=vol, spacing=spacing, origin=origin,
                        direction=direction)


def is_dicom_dir(path: str) -> bool:
    """A directory containing DICOM slice files and NO other supported
    image files — treated as ONE case (the series) by the CLI. A mixed
    directory (scans dir with a stray .dcm) is NOT a series: the CLI must
    enumerate its NRRD/NIfTI files normally rather than silently swallow
    them into a bogus one-slice volume."""
    if not os.path.isdir(path):
        return False
    from . import SUPPORTED_EXTENSIONS
    has_dicom = False
    for f in os.listdir(path):
        low = f.lower()
        if f.startswith('.'):
            continue
        if low.endswith(DICOM_EXTENSIONS):
            has_dicom = True
        elif low.endswith(tuple('.' + e for e in SUPPORTED_EXTENSIONS)):
            return False
    return has_dicom
