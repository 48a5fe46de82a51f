"""JPEG Lossless (ITU-T T.81 process 14) decoder for DICOM CT series.

DICOM's most common compressed CT transfer syntaxes are JPEG Lossless:
``1.2.840.10008.1.2.4.70`` (process 14, selection value 1 — the mandated
default) and ``1.2.840.10008.1.2.4.57`` (process 14, any predictor). The
reference tool never reads DICOM at all (users convert series first);
this package reads series natively (io/dicom.py), so the dominant
compressed syntax must decode too. The module is the package's own copy
of the reference package's decoder, bit for bit the same output.

Scope (deliberately matching what CT scanners emit):
 - single-component (grayscale) scans, 2-16 bit precision,
 - all seven predictors (selection values 1-7) + point transform,
 - restart intervals (DRI/RSTn) with predictor reset,
 - byte-stuffed entropy data (FF00), trailing EOI.
Color/multi-component lossless scans raise JpegError.

Decode pipeline: the serial part — Huffman-decoding the per-sample
difference stream — runs in the native C decoder (csrc/ts2dio.cc,
``ts2dio_jpegll_decode_diffs``, io/native.py) when built, else in a table-driven pure-Python
loop. Reconstruction from differences is numpy-vectorized where the
predictor allows it (selection value 1, the ``.70`` case, is a row-wise
cumsum; selection value 2 a column-wise cumsum); the 2D-recursive
predictors (3-7) fall back to a per-row loop with vectorized row math.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np


class JpegError(ValueError):
    pass


# markers
_SOI = 0xD8
_EOI = 0xD9
_SOF3 = 0xC3
_DHT = 0xC4
_SOS = 0xDA
_DRI = 0xDD
_SOF_OTHER = {0xC0, 0xC1, 0xC2, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
              0xCD, 0xCE, 0xCF}


class _Frame:
    __slots__ = ('precision', 'rows', 'cols', 'n_components')


def _build_peek_lut(counts, symbols, check_symbol) -> np.ndarray:
    """Build the canonical-Huffman 16-bit peek LUT shared by the lossless
    and sequential-DCT decoders: lut[next16] = (symbol << 5) | code_length.
    ``check_symbol(sym)`` raises JpegError on symbols the caller's table
    class forbids."""
    lut = np.zeros(1 << 16, np.uint32)
    code = 0
    k = 0
    for ln in range(1, 17):
        for _ in range(counts[ln - 1]):
            sym = symbols[k]
            k += 1
            check_symbol(sym)
            if code >= (1 << ln):
                raise JpegError('Over-subscribed DHT code counts')
            base = code << (16 - ln)
            span = 1 << (16 - ln)
            lut[base:base + span] = (sym << 5) | ln
            code += 1
        code <<= 1
    return lut


def _check_ssss(sym: int) -> None:
    if sym > 16:
        raise JpegError(f'Invalid lossless SSSS symbol {sym}')


def _parse_dht(seg: bytes, tables: Dict[int, 'tuple']):
    """Parse one DHT segment (may hold several tables). Builds, per table
    id, a 16-bit peek LUT: lut[next16] = (symbol << 5) | code_length."""
    pos = 0
    while pos < len(seg):
        tc_th = seg[pos]
        tc, th = tc_th >> 4, tc_th & 0x0F
        counts = seg[pos + 1:pos + 17]
        if len(counts) < 16:
            raise JpegError('Truncated DHT segment')
        nsym = sum(counts)
        symbols = seg[pos + 17:pos + 17 + nsym]
        if len(symbols) < nsym:
            raise JpegError('Truncated DHT symbol list')
        pos += 17 + nsym
        if tc != 0:
            continue  # AC tables are illegal in lossless; ignore
        tables[th] = _build_peek_lut(counts, symbols, _check_ssss)


def _find_frame(buf: bytes):
    """Scan the JPEG stream: returns (frame, dc_tables, scan) where scan =
    (predictor, point_transform, table_id, dri, entropy_offset)."""
    if len(buf) < 4 or buf[0] != 0xFF or buf[1] != _SOI:
        raise JpegError('Not a JPEG stream (missing SOI)')
    pos = 2
    frame: Optional[_Frame] = None
    tables: Dict[int, np.ndarray] = {}
    dri = 0
    while pos + 4 <= len(buf):
        if buf[pos] != 0xFF:
            raise JpegError(f'Marker expected at offset {pos}')
        marker = buf[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        (length,) = struct.unpack_from('>H', buf, pos + 2)
        seg = buf[pos + 4:pos + 2 + length]
        if marker == _SOF3:
            frame = _Frame()
            frame.precision = seg[0]
            frame.rows, frame.cols = struct.unpack_from('>HH', seg, 1)
            frame.n_components = seg[5]
        elif marker in _SOF_OTHER:
            raise JpegError(
                f'JPEG SOF{marker - 0xC0} is not lossless process 14 '
                f'(only SOF3 streams are supported)')
        elif marker == _DHT:
            _parse_dht(seg, tables)
        elif marker == _DRI:
            (dri,) = struct.unpack_from('>H', seg, 0)
        elif marker == _SOS:
            if frame is None:
                raise JpegError('SOS before SOF3')
            ns = seg[0]
            if ns != 1 or frame.n_components != 1:
                raise JpegError(
                    f'{max(ns, frame.n_components)}-component lossless scan '
                    f'(only grayscale is supported)')
            table_id = seg[2] >> 4
            predictor = seg[1 + 2 * ns]      # Ss
            pt = seg[3 + 2 * ns] & 0x0F      # Al
            if not (1 <= predictor <= 7):
                raise JpegError(f'Invalid predictor (Ss={predictor})')
            if table_id not in tables:
                raise JpegError(f'SOS references missing DC table {table_id}')
            return frame, tables[table_id], (predictor, pt, dri,
                                             pos + 2 + length)
        pos += 2 + length
    raise JpegError('No SOS marker found')


def _entropy_segments(buf: bytes, start: int) -> List[bytes]:
    """Split the entropy-coded data into restart intervals: unstuff FF00,
    cut at RSTn markers, stop at EOI (or any other marker).

    0xFF bytes are sparse in entropy data (~1/256 of bytes), so the scan
    walks only the numpy-located 0xFF positions and unstuffs whole slices
    with bytes.replace — a per-byte Python loop here cost more than the
    Huffman decode itself (30.7 vs 3.8 ms on a 512² CT slice)."""
    segs: List[bytes] = []
    n = len(buf)
    ffs = np.flatnonzero(np.frombuffer(buf, np.uint8)[start:] == 0xFF)
    seg_start = start
    end = n
    for off in ffs.tolist():
        p = start + off
        if p < seg_start:  # the 00 of a stuffed FF00 already consumed
            continue
        nxt = buf[p + 1] if p + 1 < n else _EOI
        if nxt == 0x00 or nxt == 0xFF:
            continue  # stuffed byte / fill byte: stays in the segment
        if 0xD0 <= nxt <= 0xD7:  # RSTn
            segs.append(buf[seg_start:p].replace(b'\xff\x00', b'\xff'))
            seg_start = p + 2
        else:  # EOI or any terminating marker
            end = p
            break
    segs.append(buf[seg_start:end].replace(b'\xff\x00', b'\xff'))
    return segs


def _decode_diffs_py(seg: bytes, lut: np.ndarray, count: int) -> np.ndarray:
    """Huffman-decode ``count`` differences from one entropy segment
    (pure-Python fallback; the native decoder covers the hot path)."""
    out = np.empty(count, np.int32)
    acc = 0
    nbits = 0
    pos = 0
    n = len(seg)
    pad_bits = 0
    lut_l = lut  # local
    for i in range(count):
        while nbits < 32:
            if pos < n:
                acc = (acc << 8) | seg[pos]
                pos += 1
                nbits += 8
            else:
                acc <<= 8  # pad with zero bits; consuming any is an error
                pad_bits += 8
                nbits += 8
        entry = int(lut_l[(acc >> (nbits - 16)) & 0xFFFF])
        ln = entry & 0x1F
        if ln == 0:
            raise JpegError('Invalid Huffman code in entropy data')
        s = entry >> 5
        nbits -= ln
        if s == 0:
            out[i] = 0
        elif s == 16:
            out[i] = 32768
        else:
            extra = (acc >> (nbits - s)) & ((1 << s) - 1)
            nbits -= s
            # T.81 "extend": low half of the category codes negatives
            out[i] = extra - ((1 << s) - 1) if extra < (1 << (s - 1)) else extra
        acc &= (1 << nbits) - 1
    # zero-pad bytes are pushed only after the segment's real bytes ran
    # out, so they are the LAST nbits of the stream; any of them consumed
    # means the entropy data ended before ``count`` samples were coded
    if pad_bits > nbits:
        raise JpegError('Truncated entropy segment (stream ended '
                        'mid-sample)')
    return out


def _decode_diffs(seg: bytes, lut: np.ndarray, count: int) -> np.ndarray:
    from . import native
    got = native.jpegll_decode_diffs(seg, lut, count)
    if got is not None:
        return got
    return _decode_diffs_py(seg, lut, count)


def _reconstruct(diffs: np.ndarray, rows: int, cols: int, precision: int,
                 pt: int, predictor: int) -> np.ndarray:
    """Apply the predictor over the difference grid. ``diffs`` is (rows,
    cols) int32; returns uint16. Arithmetic is mod 2^16 (T.81 annex H:
    prediction and reconstruction use 16-bit modulo arithmetic)."""
    default = np.int32(1 << (precision - pt - 1))
    out = np.empty((rows, cols), np.uint16)

    if predictor == 1:
        # value[y,x] = value[y,x-1] + d (x>0); value[y,0] = value[y-1,0] + d
        # -> first column is a cumsum down, each row a cumsum across.
        # uint16 cumsum gives exactly the mod-2^16 arithmetic T.81 requires.
        d = diffs.astype(np.uint16)
        d[0, 0] = (int(d[0, 0]) + int(default)) & 0xFFFF  # wraps by design
        first_col = np.cumsum(d[:, 0], dtype=np.uint16)
        d[:, 0] = first_col
        np.cumsum(d, axis=1, dtype=np.uint16, out=out)
        return out

    if predictor == 2:
        # value[y,x] = value[y-1,x] + d; first row: value[0,x]=value[0,x-1]+d
        d = diffs.astype(np.uint16)
        d[0, 0] = (int(d[0, 0]) + int(default)) & 0xFFFF  # wraps by design
        d[0, :] = np.cumsum(d[0, :], dtype=np.uint16)
        np.cumsum(d, axis=0, dtype=np.uint16, out=out)
        return out

    # general path (predictors 3-7): per-row loop; rows whose predictor has
    # no intra-row recursion (3: Rc = above-left) stay vectorized, the
    # Ra-dependent predictors (4-7) run a serial inner loop (the native
    # decoder covers these in C; this path is the correctness fallback)
    prev: Optional[np.ndarray] = None
    for y in range(rows):
        d = diffs[y].astype(np.int64)
        if prev is None:
            # first line (of the scan / of a restart interval): Ra chain
            # seeded with the default prediction (T.81 H.2.2)
            row = np.cumsum(d, dtype=np.int64) + int(default)
            row &= 0xFFFF
        elif predictor == 2:
            row = (prev.astype(np.int64) + d) & 0xFFFF
        elif predictor == 3:
            rb = prev.astype(np.int64)
            rc = np.empty_like(rb)
            rc[0] = rb[0]  # first sample predicts from Rb
            rc[1:] = rb[:-1]
            row = np.empty(cols, np.int64)
            row[0] = (rb[0] + d[0]) & 0xFFFF
            row[1:] = (rc[1:] + d[1:]) & 0xFFFF
        else:
            # predictors with Ra dependence: serial within the row
            rb = prev.astype(np.int64)
            row = np.empty(cols, np.int64)
            ra = (rb[0] + d[0]) & 0xFFFF  # first sample of a line uses Rb
            row[0] = ra
            for x in range(1, cols):
                b = int(rb[x])
                c = int(rb[x - 1])
                if predictor == 4:
                    pred = ra + b - c
                elif predictor == 5:
                    pred = ra + ((b - c) >> 1)
                elif predictor == 6:
                    pred = b + ((ra - c) >> 1)
                else:  # 7
                    pred = (ra + b) >> 1
                ra = (pred + int(d[x])) & 0xFFFF
                row[x] = ra
        out[y] = row.astype(np.uint16)
        prev = out[y]
    return out


def decode(buf: bytes) -> np.ndarray:
    """Decode one JPEG Lossless (SOF3) stream into a (rows, cols) uint16
    array (point transform re-applied, i.e. values are shifted back to
    their stated precision)."""
    from .image import PARSER_ERRORS
    try:
        return _decode(buf)
    except JpegError:
        raise
    except (ValueError, *PARSER_ERRORS) as ex:
        # malformed marker bodies must surface as the codec error type so
        # io/dicom.py's error wrapping keeps its DicomError contract
        raise JpegError(f'Corrupt JPEG stream ({ex})') from ex


def _decode(buf: bytes) -> np.ndarray:
    frame, lut, (predictor, pt, dri, entropy_at) = _find_frame(buf)
    rows, cols = frame.rows, frame.cols
    if rows <= 0 or cols <= 0:
        raise JpegError('Empty JPEG frame')
    total = rows * cols
    segs = _entropy_segments(buf, entropy_at)
    if len(segs) > 1 and dri <= 0:
        raise JpegError('RSTn markers in entropy data but no restart '
                        'interval defined (missing/zero DRI)')

    if dri <= 0 or len(segs) == 1:
        diffs = _decode_diffs(segs[0], lut, total).reshape(rows, cols)
        arr = _reconstruct(diffs, rows, cols, frame.precision, pt,
                           predictor)
    else:
        # restart intervals: DRI counts MCUs = samples (1 component). Each
        # interval re-seeds prediction as at scan start (T.81 H.2.2 note);
        # samples keep flowing in raster order.
        if dri % cols != 0:
            raise JpegError(
                f'Restart interval {dri} does not align to the {cols}-sample '
                f'row (unsupported mid-row restart)')
        arr = np.empty((rows, cols), np.uint16)
        done = 0
        for seg in segs:
            if done >= total:
                break
            take = min(dri, total - done)
            diffs = _decode_diffs(seg, lut, take).reshape(-1, cols)
            r0 = done // cols
            sub = _reconstruct(diffs, diffs.shape[0], cols, frame.precision,
                               pt, predictor)
            arr[r0:r0 + diffs.shape[0]] = sub
            done += take
        if done < total:
            raise JpegError(f'Entropy data ends early: {done}/{total} samples')
    if pt:
        arr = (arr.astype(np.uint32) << pt).astype(np.uint16)
    return arr
