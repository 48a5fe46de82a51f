"""JPEG-LS (ISO/IEC 14495-1 / ITU-T T.87, LOCO-I) decoder for DICOM CT
and X-ray series.

DICOM's JPEG-LS transfer syntaxes — ``1.2.840.10008.1.2.4.80`` (lossless)
and ``1.2.840.10008.1.2.4.81`` (near-lossless) — complete the compressed
families this package reads natively (io/jpegll.py, io/jpegdct.py,
io/jpeg2k.py). The reference tool never reads DICOM at all (users convert
series first). The module is the package's own copy of the reference
package's decoder.

Scope: single-component (grayscale) scans, 2–16 bit, lossless and
near-lossless (any NEAR), default and LSE-preset coding parameters
(MAXVAL/T1/T2/T3/RESET). Mapping tables (LSE ID 2/3), multi-component
scans, and restart markers raise JpegLsError with the reason.

Implemented from the T.87 algorithm: gradient quantization and context
modeling (A.3), the MED predictor with adaptive bias correction
(A.4–A.6), the limited-length Golomb coder (A.5.3), and run mode with
run-interruption coding (A.7). The serial per-sample loop follows the
same split as the other codecs here: a native C decoder in
csrc/ts2dio.cc when built, with this file's pure-Python loop as the
correctness fallback. Validated sample-exact against the system CharLS
codec (tests/test_torch_dicom.py, tests/charls_oracle.py).
"""

from __future__ import annotations

import struct

import numpy as np

from . import native


class JpegLsError(ValueError):
    pass


_SOI = 0xFFD8
_SOF55 = 0xFFF7
_LSE = 0xFFF8
_SOS = 0xFFDA
_DRI = 0xFFDD

# A.2.1 run-length code order table
_J = (0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
      4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15)


class _Params:
    """Coding parameters resolved per C.2.4.1 (defaults) or LSE presets."""

    def __init__(self, maxval: int, near: int, t1: int = 0, t2: int = 0,
                 t3: int = 0, reset: int = 0):
        self.maxval = maxval
        self.near = near
        # default thresholds (C.2.4.1.1.1)
        if maxval >= 128:
            factor = (min(maxval, 4095) + 128) // 256
            dt1 = factor * (3 - 2) + 2 + 3 * near
            dt2 = factor * (7 - 3) + 3 + 5 * near
            dt3 = factor * (21 - 4) + 4 + 7 * near
        else:
            factor = 256 // (maxval + 1)
            dt1 = max(2, 3 // factor + 3 * near)
            dt2 = max(3, 7 // factor + 5 * near)
            dt3 = max(4, 21 // factor + 7 * near)
        self.t1 = t1 or self._clamp(dt1, near + 1)
        self.t2 = t2 or self._clamp(dt2, self.t1)
        self.t3 = t3 or self._clamp(dt3, self.t2)
        self.reset = reset or 64
        self.range = (maxval + 2 * near) // (2 * near + 1) + 1
        self.qbpp = max(1, (self.range - 1).bit_length())
        bpp = max(2, maxval.bit_length())
        self.limit = 2 * (bpp + max(8, bpp))

    def _clamp(self, v: int, lo: int) -> int:
        return lo if (v > self.maxval or v < lo) else v


class _BitReader:
    """MSB-first reader with T.87 marker-avoidance stuffing: after a 0xFF
    byte only seven bits of the next byte carry data (its MSB is a
    stuffed 0). Requesting bits past the end of the scan data (a 0xFF
    followed by a MSB-1 marker byte, or the buffer end) raises — a
    complete stream never reads past its own padding bits."""

    __slots__ = ('data', 'pos', 'buf', 'nbits', 'last_ff')

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.buf = 0
        self.nbits = 0
        self.last_ff = False

    def _fill(self):
        if self.pos >= len(self.data):
            raise JpegLsError('Truncated entropy segment')
        b = self.data[self.pos]
        if self.last_ff:
            if b & 0x80:  # a marker: scan data is over
                raise JpegLsError('Truncated entropy segment '
                                  '(ran into a marker)')
            self.buf = b
            self.nbits = 7
        else:
            self.buf = b
            self.nbits = 8
        self.pos += 1
        self.last_ff = b == 0xFF

    def bit(self) -> int:
        if self.nbits == 0:
            self._fill()
        self.nbits -= 1
        return (self.buf >> self.nbits) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v


def _golomb(rd: _BitReader, k: int, limit: int, qbpp: int) -> int:
    """Limited-length Golomb decode (A.5.3): unary zeros terminated by a
    1 (the 1 is consumed in the escape case too), then k remainder bits;
    the escape of limit-qbpp-1 zeros is followed by qbpp bits of
    (value - 1). A unary run past the limit cannot occur in a valid
    stream — raising keeps the pure-Python loop's corrupt-stream
    behavior identical to the native decoder's."""
    q = 0
    while rd.bit() == 0:
        q += 1
        if q > limit:
            raise JpegLsError('Corrupt entropy data (runaway Golomb code)')
    if q < limit - qbpp - 1:
        return (q << k) | rd.bits(k)
    return rd.bits(qbpp) + 1


def _decode_scan_py(data: bytes, w: int, h: int, p: _Params) -> np.ndarray:
    """Pure-Python scan decode (T.87 A.2–A.8), one component, ILV 0.

    Line buffers are padded by one sample on each side (the CharLS
    layout): index i+1 holds sample i; the left pad gives the previous
    line's start-of-line Ra (= Rc for the first sample), the right pad
    repeats the last sample (= Rd at the right edge)."""
    rd = _BitReader(data)
    maxval, near, reset = p.maxval, p.near, p.reset
    rge = p.range * (2 * near + 1)
    limit, qbpp = p.limit, p.qbpp
    a_init = max(2, (p.range + 32) // 64)
    A = [a_init] * 367
    B = [0] * 365
    C = [0] * 365
    N = [1] * 367
    Nn = [0, 0]  # negative-error counts for the interruption contexts
    run_index = 0
    t1, t2, t3 = p.t1, p.t2, p.t3

    def quantize(d):
        if d <= -t3:
            return -4
        if d <= -t2:
            return -3
        if d <= -t1:
            return -2
        if d < -near:
            return -1
        if d <= near:
            return 0
        if d < t1:
            return 1
        if d < t2:
            return 2
        if d < t3:
            return 3
        return 4

    def fix(rx):
        if rx < -near:
            rx += rge
        elif rx > maxval + near:
            rx -= rge
        return 0 if rx < 0 else (maxval if rx > maxval else rx)

    def decode_ri(ra, rb):
        """Run-interruption sample (A.7.2)."""
        ritype = 1 if abs(ra - rb) <= near else 0
        ctx = 365 + ritype
        temp = A[ctx] + ((N[ctx] >> 1) if ritype else 0)
        k = 0
        while (N[ctx] << k) < temp:
            k += 1
        emerr = _golomb(rd, k, limit - _J[run_index] - 1, qbpp)
        tval = emerr + ritype
        mapv = tval & 1
        errabs = (tval + mapv) // 2
        if (k != 0 or 2 * Nn[ritype] >= N[ctx]) == bool(mapv):
            errval = -errabs
        else:
            errval = errabs
        if errval < 0:
            Nn[ritype] += 1
        A[ctx] += (emerr + 1 - ritype) >> 1
        if N[ctx] == reset:
            A[ctx] >>= 1
            N[ctx] >>= 1
            Nn[ritype] >>= 1
        N[ctx] += 1
        if ritype:
            px, sign = ra, 1
        else:
            px, sign = rb, (-1 if rb < ra else 1)
        return fix(px + sign * errval * (2 * near + 1))

    out = np.zeros((h, w), np.int32)
    prev = [0] * (w + 2)
    cur = [0] * (w + 2)
    for y in range(h):
        prev[w + 1] = prev[w]   # right pad: Rd at the right edge
        cur[0] = prev[1]        # Ra for the first sample = Rb
        x = 0
        while x < w:
            ra = cur[x]
            rc = prev[x]
            rb = prev[x + 1]
            rdd = prev[x + 2]
            q1 = quantize(rdd - rb)
            q2 = quantize(rb - rc)
            q3 = quantize(rc - ra)
            if q1 == 0 and q2 == 0 and q3 == 0:
                # ---- run mode (A.7.1) ----
                remaining = w - x
                filled = 0
                broken = True
                while rd.bit():
                    seg = 1 << _J[run_index]
                    n = min(seg, remaining - filled)
                    filled += n
                    if n == seg and run_index < 31:
                        run_index += 1
                    if filled == remaining:
                        broken = False
                        break
                if broken:
                    if _J[run_index]:
                        filled += rd.bits(_J[run_index])
                    # the mandatory interruption sample must still fit
                    # inside the line
                    if filled >= remaining:
                        raise JpegLsError('Run length exceeds the line')
                for i in range(filled):
                    cur[x + 1 + i] = ra
                x += filled
                if broken:
                    # interruption sample at x; Rb is above it
                    cur[x + 1] = decode_ri(ra, prev[x + 1])
                    if run_index > 0:
                        run_index -= 1
                    x += 1
                continue
            # ---- regular mode (A.4–A.6) ----
            if q1 < 0 or (q1 == 0 and (q2 < 0 or (q2 == 0 and q3 < 0))):
                sign = -1
                q = -(q1 * 81 + q2 * 9 + q3)
            else:
                sign = 1
                q = q1 * 81 + q2 * 9 + q3
            # MED predictor with bias correction
            mn, mx = (ra, rb) if ra <= rb else (rb, ra)
            if rc >= mx:
                px = mn
            elif rc <= mn:
                px = mx
            else:
                px = ra + rb - rc
            px += C[q] if sign > 0 else -C[q]
            px = 0 if px < 0 else (maxval if px > maxval else px)
            k = 0
            while (N[q] << k) < A[q]:
                k += 1
            merr = _golomb(rd, k, limit, qbpp)
            if merr & 1:
                errval = -(merr + 1) // 2
            else:
                errval = merr // 2
            if k == 0 and near == 0 and 2 * B[q] <= -N[q]:
                errval = -errval - 1  # inverse of the A.5.2 special map
            B[q] += errval * (2 * near + 1)
            A[q] += errval if errval >= 0 else -errval
            if N[q] == reset:
                A[q] >>= 1
                B[q] >>= 1
                N[q] >>= 1
            N[q] += 1
            if B[q] <= -N[q]:
                B[q] += N[q]
                if C[q] > -128:
                    C[q] -= 1
                if B[q] <= -N[q]:
                    B[q] = -N[q] + 1
            elif B[q] > 0:
                B[q] -= N[q]
                if C[q] < 127:
                    C[q] += 1
                if B[q] > 0:
                    B[q] = 0
            if sign < 0:
                errval = -errval
            cur[x + 1] = fix(px + errval * (2 * near + 1))
            x += 1
        out[y] = cur[1:w + 1]
        prev, cur = cur, prev
    return out


def decode(buf: bytes) -> np.ndarray:
    """Decode one JPEG-LS stream into a (rows, cols) uint8/uint16 array."""
    from .image import PARSER_ERRORS
    try:
        return _decode(buf)
    except JpegLsError:
        raise
    except (ValueError, *PARSER_ERRORS) as ex:
        # malformed marker bodies must surface as the codec error type so
        # io/dicom.py's error wrapping keeps its DicomError contract
        raise JpegLsError(f'Corrupt JPEG-LS stream ({ex})') from ex


def _decode(buf: bytes) -> np.ndarray:
    if buf[:2] != b'\xff\xd8':
        raise JpegLsError('Not a JPEG-LS stream (missing SOI)')
    pos = 2
    n = len(buf)
    w = h = prec = 0
    maxval = t1 = t2 = t3 = reset = 0
    while pos + 4 <= n:
        (marker, length) = struct.unpack_from('>HH', buf, pos)
        if marker == _SOI or (marker >> 8) != 0xFF:
            raise JpegLsError('Corrupt marker structure')
        body = buf[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker == _SOF55:
            prec, h, w, nc = struct.unpack_from('>BHHB', body, 0)
            if nc != 1:
                raise JpegLsError(
                    f'{nc}-component JPEG-LS scan '
                    f'(only grayscale is supported)')
            if not (2 <= prec <= 16):
                raise JpegLsError(f'{prec}-bit samples (2..16 supported)')
            if w == 0 or h == 0:
                raise JpegLsError('Zero image dimensions (DNL-deferred '
                                  'height is not supported)')
            if h * w > 1 << 28:
                raise JpegLsError(
                    f'Implausible image dimensions {h}x{w} in SOF55')
        elif marker == _LSE:
            lse_id = body[0]
            if lse_id == 1:
                maxval, t1, t2, t3, reset = struct.unpack_from(
                    '>HHHHH', body, 1)
            else:
                raise JpegLsError(
                    f'LSE ID {lse_id} (mapping tables / extended '
                    f'parameters) is not supported')
        elif marker == _DRI:
            (ri,) = struct.unpack_from('>H', body, 0)
            if ri:
                raise JpegLsError('Restart intervals are not supported')
        elif marker == _SOS:
            ns = body[0]
            if ns != 1:
                raise JpegLsError(f'{ns}-component scan (only grayscale '
                                  f'is supported)')
            near = body[1 + 2 * ns]
            ilv = body[2 + 2 * ns]
            if ilv != 0:
                raise JpegLsError(f'Interleave mode {ilv} with one '
                                  f'component is invalid')
            if not w:
                raise JpegLsError('SOS before SOF55')
            mv = maxval or (1 << prec) - 1
            if mv >= (1 << prec):
                raise JpegLsError(
                    f'LSE MAXVAL={mv} exceeds the {prec}-bit sample range')
            if near > min(255, mv // 2):
                raise JpegLsError(f'NEAR={near} out of range')
            p = _Params(mv, near, t1, t2, t3, reset)
            # preset sanity (T.87 C.2.4.1.1): thresholds ordered inside
            # the sample range, RESET >= 3 — hostile values would corrupt
            # the adaptive state instead of failing loudly
            if not (near + 1 <= p.t1 <= p.t2 <= p.t3 <= mv):
                raise JpegLsError(
                    f'Invalid LSE thresholds T1={p.t1} T2={p.t2} T3={p.t3} '
                    f'(need NEAR+1 <= T1 <= T2 <= T3 <= MAXVAL)')
            if p.reset < 3:
                raise JpegLsError(f'Invalid LSE RESET={p.reset} (minimum 3)')
            data = buf[pos:]
            nat = native.jpegls_decode(data, w, h, p.maxval, p.near,
                                       p.t1, p.t2, p.t3, p.reset)
            out = nat if nat is not None else _decode_scan_py(data, w, h, p)
            dtype = np.uint8 if prec <= 8 else np.uint16
            return out.astype(dtype)
    raise JpegLsError('No SOS in JPEG-LS stream')
