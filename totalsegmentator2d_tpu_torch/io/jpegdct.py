"""Baseline / extended sequential JPEG decoder (ITU-T T.81 processes 1-2)
for DICOM X-ray and secondary-capture series.

DICOM's lossy JPEG transfer syntaxes — ``1.2.840.10008.1.2.4.50`` (baseline,
8-bit, SOF0) and ``1.2.840.10008.1.2.4.51`` (extended sequential, 12-bit,
SOF1) — are what CR/DX X-ray archives and many secondary captures emit. The
reference tool never reads DICOM at all (users convert series first);
this package reads series natively (io/dicom.py), and the
X-ray workload class (tsxr models) makes the lossy-JPEG X-ray syntax worth
decoding too.

Scope (matching what grayscale medical exports contain):
 - single-component (grayscale) sequential DCT scans, 8- or 12-bit,
 - Huffman entropy coding (DC + AC tables), restart intervals,
 - byte-stuffed entropy data (FF00), trailing EOI.
Progressive (SOF2), arithmetic-coded, hierarchical, and multi-component
(color) streams raise JpegError with the reason.

Decode pipeline: the serial part — Huffman-decoding the per-block
coefficient stream — runs in the native C decoder (csrc/ts2dio.cc,
``ts2dio_jpegdct_decode_blocks`` and ``ts2dio_jpegdct_reconstruct``,
io/native.py) when built, else in a table-driven pure-Python
loop. Everything after entropy decoding is numpy-vectorized over all
blocks at once: dequantize, de-zigzag, 8x8 IDCT as two small matmuls
(einsum), level shift + clip, block reassembly.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from .jpegll import JpegError, _build_peek_lut, _entropy_segments

# markers (the ones jpegll.py does not already name)
_SOI = 0xD8
_EOI = 0xD9
_SOF0 = 0xC0   # baseline sequential DCT
_SOF1 = 0xC1   # extended sequential DCT, Huffman
_DHT = 0xC4
_DQT = 0xDB
_SOS = 0xDA
_DRI = 0xDD
_SOF_UNSUPPORTED = {
    0xC2: 'progressive DCT (SOF2)',
    0xC3: 'lossless (SOF3 — handled by io/jpegll.py)',
    0xC5: 'differential sequential DCT (SOF5)',
    0xC6: 'differential progressive DCT (SOF6)',
    0xC7: 'differential lossless (SOF7)',
    0xC9: 'arithmetic-coded sequential DCT (SOF9)',
    0xCA: 'arithmetic-coded progressive DCT (SOF10)',
    0xCB: 'arithmetic-coded lossless (SOF11)',
    0xCD: 'differential arithmetic sequential (SOF13)',
    0xCE: 'differential arithmetic progressive (SOF14)',
    0xCF: 'differential arithmetic lossless (SOF15)',
}

# zigzag scan: _ZIGZAG[i] = raster index of the i-th zigzag coefficient
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)


def _idct_basis() -> np.ndarray:
    """M[x, u] = c(u)/2 * cos((2x+1) u pi / 16): idct2(X) = M @ X @ M.T."""
    x = np.arange(8)[:, None]
    u = np.arange(8)[None, :]
    m = 0.5 * np.cos((2 * x + 1) * u * np.pi / 16)
    m[:, 0] *= 1 / np.sqrt(2)
    return m


_IDCT_M = _idct_basis()


class _Frame:
    __slots__ = ('precision', 'rows', 'cols')


def _parse_dht(seg: bytes, dc: Dict[int, np.ndarray],
               ac: Dict[int, np.ndarray]) -> None:
    """Parse one DHT segment (may hold several tables) into 16-bit peek
    LUTs: lut[next16] = (symbol << 5) | code_length."""
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
        if tc > 1:
            raise JpegError(f'Invalid DHT class {tc}')

        def _check_dc(sym: int) -> None:
            if sym > 15:
                raise JpegError(f'Invalid DC category symbol {sym}')

        lut = _build_peek_lut(counts, symbols,
                              _check_dc if tc == 0 else lambda sym: None)
        (dc if tc == 0 else ac)[th] = lut


def _parse_dqt(seg: bytes, tables: Dict[int, np.ndarray]) -> None:
    pos = 0
    while pos < len(seg):
        pq_tq = seg[pos]
        pq, tq = pq_tq >> 4, pq_tq & 0x0F
        pos += 1
        if pq == 0:
            if len(seg) - pos < 64:
                raise JpegError('Truncated DQT segment')
            vals = np.frombuffer(seg, np.uint8, 64, pos).astype(np.int32)
            pos += 64
        elif pq == 1:
            if len(seg) - pos < 128:
                raise JpegError('Truncated DQT segment')
            vals = np.frombuffer(seg, '>u2', 64, pos).astype(np.int32)
            pos += 128
        else:
            raise JpegError(f'Invalid DQT precision {pq}')
        tables[tq] = vals  # zigzag order


def _find_frame(buf: bytes):
    """Scan the stream up to SOS. Returns (frame, qtable, dc_lut, ac_lut,
    dri, entropy_offset)."""
    if len(buf) < 4 or buf[0] != 0xFF or buf[1] != _SOI:
        raise JpegError('Not a JPEG stream (missing SOI)')
    pos = 2
    frame: Optional[_Frame] = None
    comp_tq = 0
    dc_tables: Dict[int, np.ndarray] = {}
    ac_tables: Dict[int, np.ndarray] = {}
    qtables: Dict[int, np.ndarray] = {}
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
        if marker in (_SOF0, _SOF1):
            frame = _Frame()
            frame.precision = seg[0]
            frame.rows, frame.cols = struct.unpack_from('>HH', seg, 1)
            n_components = seg[5]
            if n_components != 1:
                raise JpegError(
                    f'{n_components}-component DCT scan (only grayscale '
                    f'is supported)')
            if marker == _SOF0 and frame.precision != 8:
                raise JpegError(
                    f'Baseline JPEG requires 8-bit precision, '
                    f'got {frame.precision}')
            if frame.precision not in (8, 12):
                raise JpegError(
                    f'Unsupported sample precision {frame.precision}')
            comp_tq = seg[8]  # (C, HV, Tq) per component
        elif marker in _SOF_UNSUPPORTED:
            raise JpegError(
                f'Unsupported JPEG coding process: '
                f'{_SOF_UNSUPPORTED[marker]}')
        elif marker == _DHT:
            _parse_dht(seg, dc_tables, ac_tables)
        elif marker == _DQT:
            _parse_dqt(seg, qtables)
        elif marker == _DRI:
            (dri,) = struct.unpack_from('>H', seg, 0)
        elif marker == _SOS:
            if frame is None:
                raise JpegError('SOS before SOF')
            ns = seg[0]
            if ns != 1:
                raise JpegError(
                    f'{ns}-component DCT scan (only grayscale is supported)')
            td, ta = seg[2] >> 4, seg[2] & 0x0F
            ss, se = seg[3], seg[4]
            ah_al = seg[5]
            if ss != 0 or se != 63 or ah_al != 0:
                raise JpegError(
                    f'Non-sequential spectral selection '
                    f'(Ss={ss}, Se={se}, AhAl={ah_al:#x})')
            if td not in dc_tables:
                raise JpegError(f'SOS references missing DC table {td}')
            if ta not in ac_tables:
                raise JpegError(f'SOS references missing AC table {ta}')
            if comp_tq not in qtables:
                raise JpegError(
                    f'Frame references missing quantization table {comp_tq}')
            return (frame, qtables[comp_tq], dc_tables[td], ac_tables[ta],
                    dri, pos + 2 + length)
        pos += 2 + length
    raise JpegError('No SOS marker found')


def _decode_blocks_py(seg: bytes, dc_lut: np.ndarray, ac_lut: np.ndarray,
                      nblocks: int) -> np.ndarray:
    """Huffman-decode ``nblocks`` 8x8 blocks of quantized coefficients
    (zigzag order, DC prediction applied) from one entropy segment
    (pure-Python fallback; the native decoder covers the hot path)."""
    out = np.zeros((nblocks, 64), np.int32)
    acc = 0
    nbits = 0
    pos = 0
    n = len(seg)
    pad_bits = 0
    pred = 0
    for b in range(nblocks):
        row = out[b]
        # DC coefficient: category + extend
        while nbits < 32:
            if pos < n:
                acc = (acc << 8) | seg[pos]
                pos += 1
            else:
                acc <<= 8  # pad: consuming any of these bits is an error
                pad_bits += 8
            nbits += 8
        entry = int(dc_lut[(acc >> (nbits - 16)) & 0xFFFF])
        ln = entry & 0x1F
        if ln == 0:
            raise JpegError('Invalid Huffman code in entropy data')
        s = entry >> 5
        nbits -= ln
        if s:
            extra = (acc >> (nbits - s)) & ((1 << s) - 1)
            nbits -= s
            pred += (extra - ((1 << s) - 1)
                     if extra < (1 << (s - 1)) else extra)
        row[0] = pred
        # AC coefficients: (run, size) pairs until EOB or k=63
        k = 1
        while k < 64:
            while nbits < 32:
                if pos < n:
                    acc = (acc << 8) | seg[pos]
                    pos += 1
                else:
                    acc <<= 8
                    pad_bits += 8
                nbits += 8
            entry = int(ac_lut[(acc >> (nbits - 16)) & 0xFFFF])
            ln = entry & 0x1F
            if ln == 0:
                raise JpegError('Invalid Huffman code in entropy data')
            sym = entry >> 5
            nbits -= ln
            r, s = sym >> 4, sym & 0x0F
            if s == 0:
                if r == 15:  # ZRL: sixteen zeros
                    k += 16
                    continue
                break  # EOB
            k += r
            if k > 63:
                raise JpegError('AC run past end of block')
            extra = (acc >> (nbits - s)) & ((1 << s) - 1)
            nbits -= s
            row[k] = (extra - ((1 << s) - 1)
                      if extra < (1 << (s - 1)) else extra)
            k += 1
        acc &= (1 << nbits) - 1
    # zero-pad bytes are pushed only after the segment's real bytes ran
    # out, so they are the LAST nbits of the stream; any of them consumed
    # means the entropy data ended before ``nblocks`` blocks were coded
    if pad_bits > nbits:
        raise JpegError('Truncated entropy segment (stream ended '
                        'mid-block)')
    return out


def _decode_blocks(seg: bytes, dc_lut: np.ndarray, ac_lut: np.ndarray,
                   nblocks: int) -> np.ndarray:
    from . import native
    got = native.jpegdct_decode_blocks(seg, dc_lut, ac_lut, nblocks)
    if got is not None:
        return got
    return _decode_blocks_py(seg, dc_lut, ac_lut, nblocks)


def _blocks_to_image(coefs: np.ndarray, q: np.ndarray, rows: int, cols: int,
                     precision: int) -> np.ndarray:
    """Dequantize, de-zigzag, IDCT, level-shift and reassemble all blocks
    at once. ``coefs`` is (nblocks, 64) int32 in zigzag order."""
    bw = (cols + 7) // 8
    bh = (rows + 7) // 8
    from . import native
    nat = native.jpegdct_reconstruct(coefs, q, _ZIGZAG, _IDCT_M,
                                     bw, bh, rows, cols, precision)
    if nat is not None:
        return nat
    deq = (coefs * q[None, :]).astype(np.float64)
    nat = np.zeros_like(deq)
    nat[:, _ZIGZAG] = deq  # zigzag -> raster
    blocks = nat.reshape(-1, 8, 8)
    # idct2 per block: M @ X @ M.T, batched as two einsum matmuls
    pix = np.einsum('xu,nuv,yv->nxy', _IDCT_M, blocks, _IDCT_M,
                    optimize=True)
    shift = 1 << (precision - 1)
    maxval = (1 << precision) - 1
    pix = np.clip(np.rint(pix + shift), 0, maxval)
    img = pix.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(
        bh * 8, bw * 8)
    out = img[:rows, :cols]
    return out.astype(np.uint8 if precision == 8 else np.uint16)


def decode(buf: bytes) -> np.ndarray:
    """Decode one sequential-DCT JPEG stream (SOF0/SOF1, grayscale) into a
    (rows, cols) uint8 (8-bit) or uint16 (12-bit) array."""
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
    frame, q, dc_lut, ac_lut, dri, entropy_at = _find_frame(buf)
    rows, cols = frame.rows, frame.cols
    if rows <= 0 or cols <= 0:
        raise JpegError('Empty JPEG frame')
    bw = (cols + 7) // 8
    bh = (rows + 7) // 8
    total = bw * bh
    segs = _entropy_segments(buf, entropy_at)
    if len(segs) > 1 and dri <= 0:
        raise JpegError('RSTn markers in entropy data but no restart '
                        'interval defined (missing/zero DRI)')

    if dri <= 0 or len(segs) == 1:
        coefs = _decode_blocks(segs[0], dc_lut, ac_lut, total)
    else:
        # restart intervals: DRI counts MCUs = blocks (single component);
        # each interval resets the DC prediction (T.81 E.2.4)
        parts = []
        done = 0
        for seg in segs:
            if done >= total:
                break
            take = min(dri, total - done)
            parts.append(_decode_blocks(seg, dc_lut, ac_lut, take))
            done += take
        if done < total:
            raise JpegError(
                f'Entropy data ends early: {done}/{total} blocks')
        coefs = np.concatenate(parts, axis=0)
    return _blocks_to_image(coefs, q, rows, cols, frame.precision)
