"""JPEG 2000 Part-1 (ISO/IEC 15444-1 / ITU-T T.800) decoder for DICOM
CT and X-ray series.

DICOM's JPEG 2000 transfer syntaxes — ``1.2.840.10008.1.2.4.90`` (lossless
only, reversible 5/3 wavelet) and ``1.2.840.10008.1.2.4.91`` (lossy
allowed, usually the irreversible 9/7 wavelet) — are what PACS archives
and modern scanner exports most commonly emit alongside JPEG Lossless.
The reference tool never reads DICOM at all (users convert series first);
this package reads series natively (io/dicom.py), so the remaining major
compressed family must decode too. The module is the package's own copy
of the reference package's decoder.

Scope (matching what grayscale medical exports contain):
 - single-component (grayscale) codestreams, signed or unsigned, up to
   16-bit,
 - reversible 5/3 and irreversible 9/7 wavelets, any decomposition depth,
 - multiple tiles, tile-parts, quality layers, precincts, SOP/EPH,
 - LRCP / RLCP / RPCL progression orders,
 - code-block styles: context reset, vertically causal contexts,
   predictable termination, termination on each pass, segmentation
   symbols.
Color images, the selective-arithmetic-bypass style, PPM/PPT packed
headers, POC progression changes, and ROI shifts (RGN) raise Jpeg2kError
with the reason. Raw codestreams and JP2-container files both decode
(DICOM requires the former; some archives embed the latter).

Everything below is implemented from the T.800 text: the MQ arithmetic
decoder (Annex C), tag trees and packet headers (Annex B), the EBCOT
Tier-1 coefficient decoder (Annex D), dequantization (Annex E) and the
inverse DWT (Annex F). Tier-1 — the serial hot loop — follows the same
split as the other codecs in this package (io/jpegll.py, io/jpegdct.py):
a native C decoder in csrc/ts2dio.cc when built, with this file's
pure-Python loop as the correctness fallback.
"""

from __future__ import annotations

import struct
import threading as _threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import native


class Jpeg2kError(ValueError):
    pass


# ---------------------------------------------------------------------------
# markers (T.800 Annex A)

_SOC = 0xFF4F
_SIZ = 0xFF51
_COD = 0xFF52
_COC = 0xFF53
_TLM = 0xFF55
_PLM = 0xFF57
_PLT = 0xFF58
_QCD = 0xFF5C
_QCC = 0xFF5D
_RGN = 0xFF5E
_POC = 0xFF5F
_PPM = 0xFF60
_PPT = 0xFF61
_CRG = 0xFF63
_COM = 0xFF64
_SOT = 0xFF90
_SOP = 0xFF91
_EPH = 0xFF92
_SOD = 0xFF93
_EOC = 0xFFD9


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# MQ arithmetic decoder (T.800 Annex C). The 47-state table rows are
# (Qe, NMPS, NLPS, SWITCH).

_MQ = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0),
)

# Tier-1 context indices (19 contexts per code block):
#   0-8   significance propagation/cleanup (0 = all-neighbors-zero)
#   9-13  sign
#   14-16 magnitude refinement
#   17    run-length
#   18    uniform
_CTX_RL = 17
_CTX_UNI = 18
_N_CTX = 19


class _MQDecoder:
    """T.800 Annex C software-conventions decoder over one codeword
    segment. Context state is shared across segments of one code block
    (list of [state_index, mps] pairs)."""

    __slots__ = ('data', 'bp', 'c', 'a', 'ct', 'ctx')

    def __init__(self, data: bytes, ctx: List[List[int]]):
        self.data = data
        self.ctx = ctx
        self.bp = 0
        b0 = data[0] if data else 0xFF
        self.c = b0 << 16
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def _bytein(self):
        data, bp = self.data, self.bp
        b = data[bp] if bp < len(data) else 0xFF
        if b == 0xFF:
            b1 = data[bp + 1] if bp + 1 < len(data) else 0xFF
            if b1 > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp = bp + 1
                self.c += b1 << 9
                self.ct = 7
        else:
            self.bp = bp + 1
            b1 = data[bp + 1] if bp + 1 < len(data) else 0xFF
            self.c += b1 << 8
            self.ct = 8

    def decode(self, cx: int) -> int:
        st = self.ctx[cx]
        qe, nmps, nlps, switch = _MQ[st[0]]
        self.a -= qe
        if ((self.c >> 16) & 0xFFFF) < qe:
            # LPS exchange path
            if self.a < qe:
                d = st[1]
                st[0] = nmps
            else:
                d = 1 - st[1]
                if switch:
                    st[1] ^= 1
                st[0] = nlps
            self.a = qe
            # renormalize
            while True:
                if self.ct == 0:
                    self._bytein()
                self.a <<= 1
                self.c = (self.c << 1) & 0xFFFFFFFF
                self.ct -= 1
                if self.a & 0x8000:
                    break
            return d
        self.c -= qe << 16
        if self.a & 0x8000:
            return st[1]
        # MPS exchange path
        if self.a < qe:
            d = 1 - st[1]
            if switch:
                st[1] ^= 1
            st[0] = nlps
        else:
            d = st[1]
            st[0] = nmps
        while True:
            if self.ct == 0:
                self._bytein()
            self.a <<= 1
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a & 0x8000:
                break
        return d


def _fresh_contexts() -> List[List[int]]:
    """Initial Tier-1 context states (T.800 D.2): UNI starts at state 46,
    run-length at 3, the all-zero significance context at 4, rest at 0."""
    ctx = [[0, 0] for _ in range(_N_CTX)]
    ctx[_CTX_UNI][0] = 46
    ctx[_CTX_RL][0] = 3
    ctx[0][0] = 4
    return ctx


# ---------------------------------------------------------------------------
# packet-header bit reader (T.800 B.10.1): MSB-first with bit stuffing —
# after a 0xFF byte only seven bits of the following byte are used.

class _HeaderBits:
    __slots__ = ('data', 'pos', 'buf', 'nbits', 'last_ff')

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.buf = 0
        self.nbits = 0
        self.last_ff = False

    def bit(self) -> int:
        if self.nbits == 0:
            if self.pos >= len(self.data):
                raise Jpeg2kError('Truncated packet header')
            b = self.data[self.pos]
            self.pos += 1
            if self.last_ff:
                if b & 0x80:
                    raise Jpeg2kError('Invalid bit-stuffing in packet header')
                self.buf = b
                self.nbits = 7
            else:
                self.buf = b
                self.nbits = 8
            self.last_ff = b == 0xFF
        self.nbits -= 1
        return (self.buf >> self.nbits) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self) -> int:
        """Flush to the next byte boundary (end of packet header); a
        stuffed 0 bit after a trailing 0xFF is consumed. Returns the byte
        position where packet body data begins."""
        self.nbits = 0
        if self.last_ff:
            if self.pos < len(self.data):
                if self.data[self.pos] & 0x80:
                    raise Jpeg2kError('Invalid bit-stuffing at header end')
                self.pos += 1
        self.last_ff = False
        return self.pos


class _TagTree:
    """T.800 B.10.2 tag tree over a w x h leaf grid."""

    def __init__(self, w: int, h: int):
        self.dims: List[Tuple[int, int]] = []
        while True:
            self.dims.append((w, h))
            if w == 1 and h == 1:
                break
            w = _ceil_div(w, 2)
            h = _ceil_div(h, 2)
        # per level: value lower bound and known flag
        self.low = [np.zeros((h_, w_), np.int32) for w_, h_ in self.dims]
        self.known = [np.zeros((h_, w_), bool) for w_, h_ in self.dims]

    def decode(self, rd: _HeaderBits, i: int, j: int, threshold: int) -> bool:
        """Refine towards leaf (i=row, j=col); True iff value < threshold
        (at which point the leaf value is exact in self.low[0][i, j])."""
        lvl = len(self.dims) - 1
        lo = 0
        while True:
            ii, jj = i >> lvl, j >> lvl
            low = self.low[lvl]
            known = self.known[lvl]
            if low[ii, jj] < lo:
                low[ii, jj] = lo
            while not known[ii, jj] and low[ii, jj] < threshold:
                if rd.bit():
                    known[ii, jj] = True
                else:
                    low[ii, jj] += 1
            if not known[ii, jj]:
                return False  # value >= threshold
            lo = low[ii, jj]
            if lvl == 0:
                return lo < threshold
            lvl -= 1


# ---------------------------------------------------------------------------
# Tier-1 EBCOT block decoder (T.800 Annex D), pure Python. The context
# tables below are exactly D.1 (significance), D.2 (sign) and D.3
# (magnitude refinement).

def _sig_ctx_tables():
    """Significance-coding contexts, T.800 Table D.1: ctx =
    table[orient][h*25 + v*5 + d] with h, v the significant
    horizontal/vertical neighbor counts (0..2) and d the diagonal count
    (0..4). Row 0 serves LL and LH; HL (row 1) swaps the roles of h and
    v; HH (row 2) is keyed on (d, h+v)."""
    out = np.zeros((3, 75), np.uint8)
    hh_ctx = {  # (min(d, 2), min(h+v, 2)) -> context
        (0, 0): 0, (0, 1): 1, (0, 2): 2,
        (1, 0): 3, (1, 1): 4, (1, 2): 5,
        (2, 0): 6, (2, 1): 7, (2, 2): 7,
    }
    for h in range(3):
        for v in range(3):
            for d in range(5):
                i = h * 25 + v * 5 + d
                # LL/LH column group of Table D.1
                if h == 2:
                    c = 8
                elif h == 1:
                    c = 7 if v >= 1 else (6 if d >= 1 else 5)
                else:
                    c = 4 if v == 2 else (3 if v == 1 else
                                          (2 if d >= 2 else d))
                out[0, i] = c
                # HL: h and v swapped
                if v == 2:
                    c = 8
                elif v == 1:
                    c = 7 if h >= 1 else (6 if d >= 1 else 5)
                else:
                    c = 4 if h == 2 else (3 if h == 1 else
                                          (2 if d >= 2 else d))
                out[1, i] = c
                # HH: diagonal-first
                out[2, i] = 8 if d >= 3 else hh_ctx[(d, min(h + v, 2))]
    return out


_SIG_CTX = _sig_ctx_tables()

# sign decoding (T.800 Table D.2): index by (h_contrib+1)*3 + (v_contrib+1)
# where contrib in {-1, 0, +1}; value = (context, xor_bit)
_SIGN_LUT = np.zeros((9, 2), np.uint8)
for _h in (-1, 0, 1):
    for _v in (-1, 0, 1):
        if _h == 1:
            _c, _x = (13, 0) if _v == 1 else ((12, 0) if _v == 0 else (11, 0))
        elif _h == 0:
            _c, _x = (10, 0) if _v == 1 else ((9, 0) if _v == 0 else (10, 1))
        else:
            _c, _x = (11, 1) if _v == 1 else ((12, 1) if _v == 0 else (13, 1))
        _SIGN_LUT[(_h + 1) * 3 + (_v + 1)] = (_c, _x)
del _h, _v, _c, _x


def _merge_segments(segments: List[Tuple[bytes, int]],
                    style: int) -> List[Tuple[bytes, int]]:
    """Without per-pass termination the contributions from successive
    packets (quality layers) are fragments of ONE codeword segment: the
    MQ decoder must run across their concatenation, not restart per
    packet (T.800 B.10.7.1)."""
    if style & 0x04:  # termination on each pass: segments stay separate
        return list(segments)
    return [(b''.join(d for d, _ in segments),
             sum(n for _, n in segments))]


class _BlockDecoder:
    """Decodes one code block's coefficients from its codeword segments.

    State persists across packets/layers: contexts, significance, and the
    running magnitude planes."""

    def __init__(self, w: int, h: int, orient: int, style: int):
        self.w = w
        self.h = h
        self.orient = self.table_orient(orient)
        self.style = style
        self.ctx = _fresh_contexts()
        self.sig = np.zeros((h + 2, w + 2), bool)     # padded borders
        self.signs = np.zeros((h + 2, w + 2), bool)   # True = negative
        self.refined = np.zeros((h, w), bool)
        self.visited = np.zeros((h, w), bool)
        self.mag = np.zeros((h, w), np.int32)
        # bit plane at which each coefficient was last coded: openjpeg's
        # midpoint-reconstruction convention adds half of 2^lastp to every
        # significant magnitude (truncated away again for reversible full
        # decodes, where lastp = 0).
        self.lastp = np.zeros((h, w), np.int32)
        self.passes_done = 0
        self.plane: Optional[int] = None  # current bit plane

    @staticmethod
    def table_orient(orient: int) -> int:
        """Subband code (0=LL, 1=HL, 2=LH, 3=HH) -> significance-context
        table row: LL/LH=0, HL=1, HH=2 (T.800 D.1 groups LL with LH)."""
        return 2 if orient == 3 else (1 if orient == 1 else 0)

    # -- neighborhood helpers (operate on the padded arrays) ---------------

    def _sig_ctx(self, y: int, x: int) -> int:
        s = self.sig
        yy, xx = y + 1, x + 1
        causal = self.style & 0x08
        below = 0 if (causal and (y & 3) == 3) else 1
        h = int(s[yy, xx - 1]) + int(s[yy, xx + 1])
        v = int(s[yy - 1, xx]) + (int(s[yy + 1, xx]) if below else 0)
        d = (int(s[yy - 1, xx - 1]) + int(s[yy - 1, xx + 1])
             + ((int(s[yy + 1, xx - 1]) + int(s[yy + 1, xx + 1]))
                if below else 0))
        return int(_SIG_CTX[self.orient, h * 25 + v * 5 + d])

    def _decode_sign(self, mq: _MQDecoder, y: int, x: int) -> bool:
        s, n = self.sig, self.signs
        yy, xx = y + 1, x + 1
        causal = self.style & 0x08
        below = 0 if (causal and (y & 3) == 3) else 1

        def contrib(sy, sx, use=1):
            if not use or not s[sy, sx]:
                return 0
            return -1 if n[sy, sx] else 1

        h = contrib(yy, xx - 1) + contrib(yy, xx + 1)
        v = contrib(yy - 1, xx) + contrib(yy + 1, xx, below)
        h = max(-1, min(1, h))
        v = max(-1, min(1, v))
        cx, xor = _SIGN_LUT[(h + 1) * 3 + (v + 1)]
        return bool(mq.decode(int(cx)) ^ int(xor))

    # -- coding passes ------------------------------------------------------

    def _pass_sig(self, mq: _MQDecoder, p: int):
        w, h = self.w, self.h
        sig, mag, vis = self.sig, self.mag, self.visited
        bit = 1 << p
        for y0 in range(0, h, 4):
            for x in range(w):
                for y in range(y0, min(y0 + 4, h)):
                    if sig[y + 1, x + 1]:
                        continue
                    cx = self._sig_ctx(y, x)
                    if cx == 0:
                        continue  # no significant neighbor: cleanup's job
                    vis[y, x] = True
                    if mq.decode(cx):
                        sig[y + 1, x + 1] = True
                        mag[y, x] |= bit
                        self.lastp[y, x] = p
                        self.signs[y + 1, x + 1] = self._decode_sign(mq, y, x)

    def _pass_ref(self, mq: _MQDecoder, p: int):
        w, h = self.w, self.h
        sig, mag, vis, ref = self.sig, self.mag, self.visited, self.refined
        s = sig
        bit = 1 << p
        for y0 in range(0, h, 4):
            for x in range(w):
                for y in range(y0, min(y0 + 4, h)):
                    if not sig[y + 1, x + 1] or vis[y, x]:
                        continue
                    if ref[y, x]:
                        cx = 16
                    else:
                        yy, xx = y + 1, x + 1
                        causal = self.style & 0x08
                        below = 0 if (causal and (y & 3) == 3) else 1
                        any_n = (s[yy, xx - 1] or s[yy, xx + 1]
                                 or s[yy - 1, xx] or s[yy - 1, xx - 1]
                                 or s[yy - 1, xx + 1]
                                 or (below and (s[yy + 1, xx]
                                                or s[yy + 1, xx - 1]
                                                or s[yy + 1, xx + 1])))
                        cx = 15 if any_n else 14
                        ref[y, x] = True
                    self.lastp[y, x] = p
                    if mq.decode(cx):
                        mag[y, x] |= bit

    def _pass_cleanup(self, mq: _MQDecoder, p: int):
        w, h = self.w, self.h
        sig, mag, vis = self.sig, self.mag, self.visited
        bit = 1 << p
        causal = self.style & 0x08
        for y0 in range(0, h, 4):
            for x in range(w):
                y = y0
                stripe = min(4, h - y0)
                # run-length mode: full stripe of 4, all insignificant,
                # no significant neighbors anywhere in the column
                if stripe == 4:
                    rl = True
                    for yy in range(y0, y0 + 4):
                        if (vis[yy, x] or sig[yy + 1, x + 1]
                                or self._sig_ctx(yy, x) != 0):
                            rl = False
                            break
                    if rl:
                        if not mq.decode(_CTX_RL):
                            for yy in range(y0, y0 + 4):
                                vis[yy, x] = False
                            continue
                        r = (mq.decode(_CTX_UNI) << 1) | mq.decode(_CTX_UNI)
                        y = y0 + r
                        sig[y + 1, x + 1] = True
                        mag[y, x] |= bit
                        self.lastp[y, x] = p
                        self.signs[y + 1, x + 1] = \
                            self._decode_sign(mq, y, x)
                        y += 1
                for yy in range(y, y0 + stripe):
                    if vis[yy, x] or sig[yy + 1, x + 1]:
                        vis[yy, x] = False
                        continue
                    cx = self._sig_ctx(yy, x)
                    if mq.decode(cx):
                        sig[yy + 1, x + 1] = True
                        mag[yy, x] |= bit
                        self.lastp[yy, x] = p
                        self.signs[yy + 1, x + 1] = \
                            self._decode_sign(mq, yy, x)
        vis[:] = False
        if self.style & 0x20:  # segmentation symbols: 1010 in UNI context
            sym = 0
            for _ in range(4):
                sym = (sym << 1) | mq.decode(_CTX_UNI)
            if sym != 0x0A:
                raise Jpeg2kError(
                    'Segmentation symbol mismatch (corrupt entropy data)')

    def run(self, segments: List[Tuple[bytes, int]], start_plane: int):
        """Run ``n`` further coding passes (summed over ``segments`` of
        (data, passes), already merged by _merge_segments) starting from
        the block's current state. ``start_plane`` is Mb-1-ZBP for the
        first call. The caller rejects the bypass style before this."""
        if self.plane is None:
            self.plane = start_plane
        term_each = bool(self.style & 0x04)
        reset = bool(self.style & 0x02)
        # Which pass in the 3-pass cycle comes next? passes_done counts
        # from the very first (cleanup) pass of the top plane.
        mq: Optional[_MQDecoder] = None
        seg_i = 0
        seg_passes_left = 0
        for _ in range(sum(np for _, np in segments)):
            if seg_passes_left == 0:
                data, seg_passes_left = segments[seg_i]
                seg_i += 1
                if reset and mq is not None:
                    self.ctx = _fresh_contexts()
                mq = _MQDecoder(data, self.ctx)
            elif term_each:
                raise AssertionError('termination bookkeeping out of sync')
            if self.plane < 0:
                raise Jpeg2kError('More coding passes than bit planes')
            k = self.passes_done
            if k == 0:
                self._pass_cleanup(mq, self.plane)
                self.plane -= 1
            else:
                which = (k - 1) % 3
                if which == 0:
                    self._pass_sig(mq, self.plane)
                elif which == 1:
                    self._pass_ref(mq, self.plane)
                else:
                    self._pass_cleanup(mq, self.plane)
                    self.plane -= 1
            self.passes_done += 1
            seg_passes_left -= 1
            if reset and seg_passes_left:
                # RESET restarts contexts each pass even within a segment
                self.ctx = _fresh_contexts()
                for i in range(_N_CTX):
                    mq.ctx[i] = self.ctx[i]

    def values(self, reversible: bool) -> np.ndarray:
        """Signed coefficients with openjpeg's midpoint reconstruction:
        each significant magnitude gets +0.5*2^lastp, where lastp is the
        bit plane the coefficient was last coded at. Reversible output is
        integer (the half truncates to zero at lastp=0, keeping lossless
        decodes exact); irreversible output is float, keeping the half
        even on full decodes — matching openjpeg's t1 output that the
        Pillow oracle checks against."""
        mag = self.mag.astype(np.int64)
        sig = mag > 0
        if reversible:
            mag = mag + np.where(sig, (1 << self.lastp.astype(np.int64)) >> 1,
                                 0)
            return np.where(self.signs[1:-1, 1:-1], -mag, mag)
        vals = mag.astype(np.float64) + np.where(
            sig, 0.5 * np.exp2(self.lastp.astype(np.float64)), 0.0)
        return np.where(self.signs[1:-1, 1:-1], -vals, vals)


# ---------------------------------------------------------------------------
# codestream structures

class _CodingStyle:
    __slots__ = ('prog', 'layers', 'mct', 'levels', 'xcb', 'ycb',
                 'cbstyle', 'transform', 'precincts', 'sop', 'eph')


class _Quant:
    __slots__ = ('style', 'guard', 'values')


class _Size:
    __slots__ = ('x', 'y', 'x0', 'y0', 'tx', 'ty', 'tx0', 'ty0',
                 'depth', 'signed')


def _parse_siz(body: bytes) -> _Size:
    (rsiz, x, y, x0, y0, tx, ty, tx0, ty0, ncomp) = struct.unpack_from(
        '>HIIIIIIIIH', body, 0)
    if ncomp != 1:
        raise Jpeg2kError(
            f'{ncomp}-component JPEG 2000 codestream '
            f'(only grayscale is supported)')
    ssiz, xr, yr = body[36], body[37], body[38]
    if xr != 1 or yr != 1:
        raise Jpeg2kError(f'Subsampled component (XRsiz={xr}, YRsiz={yr})')
    s = _Size()
    s.x, s.y, s.x0, s.y0 = x, y, x0, y0
    s.tx, s.ty, s.tx0, s.ty0 = tx, ty, tx0, ty0
    s.depth = (ssiz & 0x7F) + 1
    s.signed = bool(ssiz >> 7)
    if s.depth > 16:
        raise Jpeg2kError(f'{s.depth}-bit samples (max 16 supported)')
    if tx == 0 or ty == 0 or x <= x0 or y <= y0:
        raise Jpeg2kError('Empty or invalid image/tile grid in SIZ')
    if tx0 > x0 or ty0 > y0 or x0 - tx0 >= tx or y0 - ty0 >= ty:
        # T.800 B.3: the first tile must contain the image origin —
        # otherwise the tile loop would silently produce an all-zero image
        raise Jpeg2kError('Tile origin outside the legal range in SIZ')
    # plausibility caps on the image EXTENTS (offset reference grids
    # are legal, T.800 B.3): corrupt 32-bit dims would otherwise demand
    # hundreds of GiB (or billions of tile iterations) before any
    # entropy data is even touched
    if (x - x0 > 1 << 20 or y - y0 > 1 << 20
            or (x - x0) * (y - y0) > 1 << 28):
        raise Jpeg2kError(
            f'Implausible image dimensions {x - x0}x{y - y0} in SIZ')
    return s


def _parse_cod(body: bytes) -> _CodingStyle:
    c = _CodingStyle()
    scod = body[0]
    c.sop = bool(scod & 0x02)
    c.eph = bool(scod & 0x04)
    c.prog = body[1]
    (c.layers,) = struct.unpack_from('>H', body, 2)
    c.mct = body[4]
    c.levels = body[5]
    c.xcb = (body[6] & 0x0F) + 2
    c.ycb = (body[7] & 0x0F) + 2
    if c.xcb + c.ycb > 12:
        raise Jpeg2kError('Code-block size exceeds 4096 samples')
    if c.levels > 32:
        raise Jpeg2kError(f'{c.levels} decomposition levels (max 32)')
    c.cbstyle = body[8]
    c.transform = body[9]
    if scod & 0x01:
        prec = body[10:10 + c.levels + 1]
        if len(prec) < c.levels + 1:
            raise Jpeg2kError('Truncated precinct sizes in COD')
        c.precincts = [(p & 0x0F, p >> 4) for p in prec]
    else:
        c.precincts = [(15, 15)] * (c.levels + 1)
    if c.prog > 2:
        names = {3: 'PCRL', 4: 'CPRL'}
        raise Jpeg2kError(
            f'Progression order {names.get(c.prog, c.prog)} is not '
            f'supported (LRCP/RLCP/RPCL are)')
    if c.layers < 1:
        raise Jpeg2kError('Zero quality layers')
    return c


def _parse_qcd(body: bytes, levels: int) -> _Quant:
    q = _Quant()
    sq = body[0]
    q.style = sq & 0x1F
    q.guard = sq >> 5
    n_bands = 3 * levels + 1
    vals: List[Tuple[int, int]] = []  # (exponent, mantissa)
    if q.style == 0:      # no quantization: 8-bit exponents
        for b in body[1:]:
            vals.append((b >> 3, 0))
    elif q.style == 1:    # scalar derived: single 16-bit value
        (v,) = struct.unpack_from('>H', body, 1)
        vals.append((v >> 11, v & 0x7FF))
    elif q.style == 2:    # scalar expounded: 16-bit per band
        for off in range(1, len(body) - 1, 2):
            (v,) = struct.unpack_from('>H', body, off)
            vals.append((v >> 11, v & 0x7FF))
    else:
        raise Jpeg2kError(f'Invalid quantization style {q.style}')
    if q.style != 1 and len(vals) < n_bands:
        raise Jpeg2kError('Truncated QCD segment')
    q.values = vals
    return q


class _Band:
    __slots__ = ('orient', 'x0', 'y0', 'x1', 'y1', 'blocks', 'eps',
                 'mantissa', 'gain')


class _CodeBlock:
    __slots__ = ('x0', 'y0', 'x1', 'y1', 'included', 'lblock', 'zbp',
                 'segments')

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.included = False
        self.lblock = 3
        self.zbp = 0
        self.segments: List[Tuple[bytes, int]] = []


class _Resolution:
    __slots__ = ('r', 'x0', 'y0', 'x1', 'y1', 'bands', 'ppx', 'ppy',
                 'npx', 'npy', 'xcb', 'ycb', 'incl_trees', 'zbp_trees')


def _band_rect(tcx0, tcy0, tcx1, tcy1, nb, xob, yob):
    """T.800 eq. B-15: subband coordinates for decomposition count nb and
    band offsets (xob, yob)."""
    d = 1 << nb
    h = (1 << (nb - 1)) if nb else 0
    return (_ceil_div(tcx0 - h * xob, d), _ceil_div(tcy0 - h * yob, d),
            _ceil_div(tcx1 - h * xob, d), _ceil_div(tcy1 - h * yob, d))


def _build_resolutions(tcx0, tcy0, tcx1, tcy1, cod: _CodingStyle,
                       quant: _Quant) -> List[_Resolution]:
    levels = cod.levels
    out = []
    for r in range(levels + 1):
        res = _Resolution()
        res.r = r
        d = 1 << (levels - r)
        res.x0, res.y0 = _ceil_div(tcx0, d), _ceil_div(tcy0, d)
        res.x1, res.y1 = _ceil_div(tcx1, d), _ceil_div(tcy1, d)
        ppx, ppy = cod.precincts[r]
        if r > 0 and (ppx == 0 or ppy == 0):
            raise Jpeg2kError(
                'Precinct exponent 0 is only legal at resolution 0 '
                '(T.800 Table A.21)')
        res.ppx, res.ppy = ppx, ppy
        if res.x1 > res.x0:
            res.npx = _ceil_div(res.x1, 1 << ppx) - (res.x0 >> ppx)
        else:
            res.npx = 0
        if res.y1 > res.y0:
            res.npy = _ceil_div(res.y1, 1 << ppy) - (res.y0 >> ppy)
        else:
            res.npy = 0
        # subbands
        bands = []
        if r == 0:
            orients = [(0, 0, 0, levels)]
        else:
            nb = levels - r + 1
            orients = [(1, 1, 0, nb), (2, 0, 1, nb), (3, 1, 1, nb)]
        for bi, (orient, xob, yob, nb) in enumerate(orients):
            band = _Band()
            band.orient = orient
            band.x0, band.y0, band.x1, band.y1 = _band_rect(
                tcx0, tcy0, tcx1, tcy1, nb, xob, yob)
            band.gain = (0, 1, 1, 2)[orient]
            # quantization exponent/mantissa for this band
            band_index = 0 if r == 0 else 3 * (r - 1) + bi + 1
            if quant.style == 1:
                # scalar derived (E-5): eps_b = eps_0 - NL + nb
                e0, m0 = quant.values[0]
                band.eps = e0 - levels + nb
                band.mantissa = m0
            else:
                e, m = quant.values[band_index]
                band.eps = e
                band.mantissa = m
            bands.append(band)
        res.bands = bands
        out.append(res)
    # code blocks per band, partitioned on the precinct-constrained grid
    # (code-block spans never cross precinct boundaries: B.7)
    for res in out:
        r = res.r
        res.xcb = xcb = min(cod.xcb, res.ppx if r == 0 else res.ppx - 1)
        res.ycb = ycb = min(cod.ycb, res.ppy if r == 0 else res.ppy - 1)
        for band in res.bands:
            blocks: Dict[Tuple[int, int, int, int], _CodeBlock] = {}
            band.blocks = blocks
            if band.x1 <= band.x0 or band.y1 <= band.y0:
                continue
            for by in range(band.y0 >> ycb, _ceil_div(band.y1, 1 << ycb)):
                for bx in range(band.x0 >> xcb,
                                _ceil_div(band.x1, 1 << xcb)):
                    x0 = max(band.x0, bx << xcb)
                    y0 = max(band.y0, by << ycb)
                    x1 = min(band.x1, (bx + 1) << xcb)
                    y1 = min(band.y1, (by + 1) << ycb)
                    blocks[(bx, by, 0, 0)] = _CodeBlock(x0, y0, x1, y1)
        # per-precinct tag trees, built lazily at first packet
        res.incl_trees = {}
        res.zbp_trees = {}
    return out


def _precinct_blocks(res: _Resolution, band: _Band, p: int):
    """Code blocks of ``band`` inside precinct index ``p`` (raster order
    over the resolution's precinct grid), plus the precinct's block-grid
    origin and dimensions for tag-tree indexing."""
    if res.npx == 0 or res.npy == 0:
        return [], 0, 0, (0, 0)
    pi, pj = p % res.npx, p // res.npx
    r = res.r
    # precinct rect on the resolution grid
    px0 = ((res.x0 >> res.ppx) + pi) << res.ppx
    py0 = ((res.y0 >> res.ppy) + pj) << res.ppy
    px1 = px0 + (1 << res.ppx)
    py1 = py0 + (1 << res.ppy)
    # map to band coords: for r>0 halve (bands live on the half grid)
    if r > 0:
        # precinct boundaries are powers of two (>= 2 for r > 0), so the
        # halving onto the band grid is exact
        bx0, by0, bx1, by1 = px0 >> 1, py0 >> 1, px1 >> 1, py1 >> 1
    else:
        bx0, by0, bx1, by1 = px0, py0, px1, py1
    xcb, ycb = res.xcb, res.ycb
    gx0 = max(band.x0, bx0) >> xcb
    gy0 = max(band.y0, by0) >> ycb
    gx1 = _ceil_div(min(band.x1, bx1), 1 << xcb)
    gy1 = _ceil_div(min(band.y1, by1), 1 << ycb)
    if gx1 <= gx0 or gy1 <= gy0:
        return [], 0, 0, (gx0, gy0)
    blocks = []
    for by in range(gy0, gy1):
        for bx in range(gx0, gx1):
            cb = band.blocks.get((bx, by, 0, 0))
            if cb is not None:
                blocks.append(((bx - gx0, by - gy0), cb))
    return blocks, gx1 - gx0, gy1 - gy0, (gx0, gy0)


def _n_passes(rd: _HeaderBits) -> int:
    """T.800 Table B.4: number of new coding passes."""
    if not rd.bit():
        return 1
    if not rd.bit():
        return 2
    v = rd.bits(2)
    if v < 3:
        return 3 + v
    v = rd.bits(5)
    if v < 31:
        return 6 + v
    return 37 + rd.bits(7)


def _decode_packet(rd: _HeaderBits, res: _Resolution, layer: int,
                   precinct: int, cbstyle: int, sop: bool, eph: bool,
                   data: bytes):
    """Decode one packet header at ``rd`` and attach body segments to the
    contributing code blocks. Returns the stream position after the
    packet body."""
    if sop:
        # optional SOP marker segment (6 bytes) before the packet
        if data[rd.pos:rd.pos + 2] == b'\xff\x91':
            rd.pos += 6
    contributions = []
    if not rd.bit():  # empty packet
        body_at = rd.align()
        if eph:
            if data[body_at:body_at + 2] != b'\xff\x92':
                raise Jpeg2kError('Missing EPH marker')
            body_at += 2
        return body_at
    for band in res.bands:
        if band.x1 <= band.x0 or band.y1 <= band.y0:
            continue
        blocks, gw, gh, _ = _precinct_blocks(res, band, precinct)
        if not blocks:
            continue
        key = (id(band), precinct)
        if key not in res.incl_trees:
            res.incl_trees[key] = _TagTree(gw, gh)
            res.zbp_trees[key] = _TagTree(gw, gh)
        incl_tree = res.incl_trees[key]
        zbp_tree = res.zbp_trees[key]
        for (gx, gy), cb in blocks:
            if not cb.included:
                included = incl_tree.decode(rd, gy, gx, layer + 1)
            else:
                included = bool(rd.bit())
            if not included:
                continue
            first = not cb.included
            if first:
                cb.included = True
                t = 1
                while not zbp_tree.decode(rd, gy, gx, t):
                    t += 1
                cb.zbp = t - 1
            npasses = _n_passes(rd)
            # length signalling
            while rd.bit():
                cb.lblock += 1
            term_each = bool(cbstyle & 0x04)
            segs = []
            if term_each:
                for _ in range(npasses):
                    ln = rd.bits(cb.lblock)
                    segs.append((ln, 1))
            else:
                ln = rd.bits(cb.lblock + int(npasses).bit_length() - 1)
                segs.append((ln, npasses))
            contributions.append((cb, segs))
    body_at = rd.align()
    if eph:
        if data[body_at:body_at + 2] != b'\xff\x92':
            raise Jpeg2kError('Missing EPH marker')
        body_at += 2
    pos = body_at
    for cb, segs in contributions:
        for ln, np_ in segs:
            if pos + ln > len(data):
                raise Jpeg2kError('Truncated packet body')
            cb.segments.append((data[pos:pos + ln], np_))
            pos += ln
    return pos


# ---------------------------------------------------------------------------
# inverse DWT (T.800 Annex F)

def _sym_index(i: np.ndarray, i0: int, i1: int) -> np.ndarray:
    """Whole-sample symmetric extension of index range [i0, i1)."""
    n = i1 - i0
    if n == 1:
        return np.full_like(i, i0)
    period = 2 * (n - 1)
    j = np.mod(i - i0, period)
    j = np.where(j >= n, period - j, j)
    return j + i0


def _idwt_1d_53(y: np.ndarray, i0: int, i1: int, axis: int) -> np.ndarray:
    """Inverse reversible 5/3 along ``axis``; ``y`` holds the interleaved
    signal for global indices [i0, i1) (even = low, odd = high)."""
    n = i1 - i0
    y = np.moveaxis(y, axis, 0)
    if n == 1:
        out = y.copy()
        if i0 & 1:
            out //= 2
        return np.moveaxis(out, 0, axis)
    out = y.astype(np.int64).copy()
    ev = np.arange(i0 + (i0 & 1), i1, 2)          # global even positions
    od = np.arange(i0 + 1 - (i0 & 1), i1, 2)      # global odd positions
    lm = _sym_index(ev - 1, i0, i1) - i0
    rp = _sym_index(ev + 1, i0, i1) - i0
    out[ev - i0] = y[ev - i0] - ((y[lm] + y[rp] + 2) >> 2)
    lm = _sym_index(od - 1, i0, i1) - i0
    rp = _sym_index(od + 1, i0, i1) - i0
    out[od - i0] = y[od - i0] + ((out[lm] + out[rp]) >> 1)
    return np.moveaxis(out, 0, axis)


_A97 = -1.586134342059924
_B97 = -0.052980118572961
_G97 = 0.882911075530934
_D97 = 0.443506852043971
_K97 = 1.230174104914001


def _idwt_1d_97(y: np.ndarray, i0: int, i1: int, axis: int) -> np.ndarray:
    n = i1 - i0
    y = np.moveaxis(y, axis, 0).astype(np.float64)
    if n == 1:
        return np.moveaxis(y, 0, axis)
    out = y.copy()
    ev = np.arange(i0 + (i0 & 1), i1, 2)
    od = np.arange(i0 + 1 - (i0 & 1), i1, 2)
    out[ev - i0] *= _K97
    out[od - i0] /= _K97

    def lift(idx, coef, src):
        lm = _sym_index(idx - 1, i0, i1) - i0
        rp = _sym_index(idx + 1, i0, i1) - i0
        out[idx - i0] -= coef * (src[lm] + src[rp])

    lift(ev, _D97, out)
    lift(od, _G97, out)
    lift(ev, _B97, out)
    lift(od, _A97, out)
    return np.moveaxis(out, 0, axis)


def _idwt_level(ll: np.ndarray, hl: np.ndarray, lh: np.ndarray,
                hh: np.ndarray, x0: int, y0: int, x1: int, y1: int,
                reversible: bool) -> np.ndarray:
    """One 2D synthesis level: combine the four subbands of the region
    [x0,x1) x [y0,y1) (resolution-grid coordinates)."""
    h, w = y1 - y0, x1 - x0
    if h > 0 and w > 0:
        nat = native.j2k_idwt_level(ll, hl, lh, hh, x0, y0, x1, y1,
                                    reversible)
        if nat is not None:
            return nat
    dtype = np.int64 if reversible else np.float64
    a = np.zeros((h, w), dtype)
    # interleave: even rows/cols = L, odd = H (global parity)
    ys = slice((0 - (y0 & 1)) % 2, h, 2)   # rows with even global index
    yo = slice((1 - (y0 & 1)) % 2, h, 2)
    xs = slice((0 - (x0 & 1)) % 2, w, 2)
    xo = slice((1 - (x0 & 1)) % 2, w, 2)
    a[ys, xs] = ll
    a[ys, xo] = hl
    a[yo, xs] = lh
    a[yo, xo] = hh
    f = _idwt_1d_53 if reversible else _idwt_1d_97
    a = f(a, x0, x1, 1)
    a = f(a, y0, y1, 0)
    return a


# ---------------------------------------------------------------------------
# tile decoding

def _iter_packets(cod: _CodingStyle, resolutions: List[_Resolution]):
    """Yield (layer, resolution, precinct) in progression order."""
    if cod.prog == 0:    # LRCP
        for layer in range(cod.layers):
            for res in resolutions:
                for p in range(res.npx * res.npy):
                    yield layer, res, p
    elif cod.prog == 1:  # RLCP
        for res in resolutions:
            for layer in range(cod.layers):
                for p in range(res.npx * res.npy):
                    yield layer, res, p
    else:                # RPCL
        for res in resolutions:
            for p in range(res.npx * res.npy):
                for layer in range(cod.layers):
                    yield layer, res, p


_block_pool = None
_block_pool_lock = _threading.Lock()


def _t1_pool():
    """One shared, lazily created pool for Tier-1 code-block decoding:
    per-call pools would multiply under concurrent serve requests."""
    global _block_pool
    with _block_pool_lock:
        if _block_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            import os
            _block_pool = ThreadPoolExecutor(
                min(8, os.cpu_count() or 1), thread_name_prefix='ts2d-j2k')
        return _block_pool


def _thread_blocks(n_tasks: int) -> bool:
    """Thread Tier-1 across a slice's code blocks? Only worthwhile when
    the native decoder runs (the C loop releases the GIL through ctypes;
    the pure-Python loop would serialize on it), on a multi-core host,
    with enough blocks to amortize dispatch — and NOT when this decode
    already runs inside a file-level decode pool (io/dicom.py threads
    across slice files; those workers saturate the cores, and nesting
    pools would just oversubscribe). File-pool workers are marked via
    native.decode_worker_local, not thread-name sniffing."""
    import os
    if n_tasks < 4 or (os.cpu_count() or 1) <= 1:
        return False
    if not native.native_available():
        return False
    return not getattr(native.decode_worker_local, 'in_file_worker', False)


def _decode_tile(data: bytes, tcx0, tcy0, tcx1, tcy1, cod: _CodingStyle,
                 quant: _Quant, depth: int) -> np.ndarray:
    resolutions = _build_resolutions(tcx0, tcy0, tcx1, tcy1, cod, quant)
    pos = 0
    for layer, res, p in _iter_packets(cod, resolutions):
        if pos >= len(data):
            break  # truncated stream: decode what arrived
        rd = _HeaderBits(data, pos)
        pos = _decode_packet(rd, res, layer, p, cod.cbstyle,
                             cod.sop, cod.eph, data)
    reversible = cod.transform == 1
    if cod.cbstyle & 0x01:
        raise Jpeg2kError('Selective arithmetic bypass (code-block style '
                          'bit 0) is not supported')

    # Tier-1 over every included code block. Blocks are independent MQ
    # streams writing disjoint band regions, so they decode in parallel
    # (each native call runs outside the GIL); bands assemble after.
    band_coeffs: Dict[int, List[np.ndarray]] = {}
    tasks = []
    for res in resolutions:
        arrays = []
        for band in res.bands:
            bw = band.x1 - band.x0
            bh = band.y1 - band.y0
            coeffs = np.zeros((max(bh, 0), max(bw, 0)),
                              np.int64 if reversible else np.float64)
            mb = quant.guard + band.eps - 1
            if mb > 31:
                # magnitudes would overflow the int32 Tier-1 state (both
                # here and in the native decoder); no real encoder
                # exceeds 31 bit planes
                raise Jpeg2kError(
                    f'{mb} magnitude bit planes (max 31 supported)')
            for cb in band.blocks.values():
                if cb.segments:
                    tasks.append((coeffs, band, cb, mb))
            arrays.append(coeffs)
        band_coeffs[res.r] = arrays

    def decode_block(task):
        coeffs, band, cb, mb = task
        cw, ch = cb.x1 - cb.x0, cb.y1 - cb.y0
        segs = _merge_segments(cb.segments, cod.cbstyle)
        start_plane = mb - 1 - cb.zbp
        if reversible:
            delta = 1.0
        else:
            # dequantize (E-3): delta = 2^(Rb - eps) (1+mu/2^11)
            rb = depth + band.gain
            delta = (2.0 ** (rb - band.eps)
                     * (1.0 + band.mantissa / 2048.0))
        dst = coeffs[cb.y0 - band.y0:cb.y1 - band.y0,
                     cb.x0 - band.x0:cb.x1 - band.x0]
        orient = _BlockDecoder.table_orient(band.orient)
        # fused native path: Tier-1 + reconstruction straight into the
        # band region; falls back to the two-call / pure-Python chain
        if native.j2k_t1_block(segs, cw, ch, cod.cbstyle, start_plane,
                               _SIG_CTX[orient], _SIGN_LUT, reversible,
                               delta, dst):
            return
        dec = _BlockDecoder(cw, ch, band.orient, cod.cbstyle)
        nat = native.j2k_t1_decode(
            segs, cw, ch, cod.cbstyle, start_plane,
            _SIG_CTX[dec.orient], _SIGN_LUT)
        if nat is not None:
            dec.mag, dec.lastp, nsigns = nat
            dec.signs[1:-1, 1:-1] = nsigns.astype(bool)
        else:
            dec.run(segs, start_plane)
        vals = dec.values(reversible)
        if not reversible:
            vals = vals.astype(np.float64) * delta
        dst[...] = vals

    if _thread_blocks(len(tasks)):
        # list() re-raises the first worker exception here
        list(_t1_pool().map(decode_block, tasks))
    else:
        for task in tasks:
            decode_block(task)

    ll: Optional[np.ndarray] = None
    for res in resolutions:
        arrays = band_coeffs[res.r]
        if res.r == 0:
            ll = arrays[0]
        else:
            ll = _idwt_level(ll, arrays[0], arrays[1], arrays[2],
                             res.x0, res.y0, res.x1, res.y1, reversible)
    return ll


# ---------------------------------------------------------------------------
# top level

def _strip_jp2(buf: bytes) -> bytes:
    """Accept either a raw codestream or a JP2 container (extract the
    contiguous-codestream box)."""
    if buf[:4] == b'\xff\x4f\xff\x51':
        return buf
    if buf[4:8] == b'jP  ':
        pos = 0
        while pos + 8 <= len(buf):
            (ln,) = struct.unpack_from('>I', buf, pos)
            typ = buf[pos + 4:pos + 8]
            if typ == b'jp2c':
                if ln == 0:
                    return buf[pos + 8:]
                if ln == 1:
                    (xl,) = struct.unpack_from('>Q', buf, pos + 8)
                    return buf[pos + 16:pos + xl]
                return buf[pos + 8:pos + ln]
            if ln == 1:  # XLBox: 64-bit length follows the type
                (xl,) = struct.unpack_from('>Q', buf, pos + 8)
                if xl < 16:  # must cover its own 16-byte header
                    raise Jpeg2kError('Corrupt JP2 box (XLBox length < 16)')
                pos += xl
            elif ln == 0:  # box extends to end of file
                pos = len(buf)
            elif ln < 8:
                raise Jpeg2kError('Corrupt JP2 box (length < 8)')
            else:
                pos += ln
        raise Jpeg2kError('JP2 container without a codestream box')
    raise Jpeg2kError('Not a JPEG 2000 codestream (missing SOC/SIZ)')


def decode(buf: bytes) -> np.ndarray:
    """Decode one JPEG 2000 codestream (raw or in a JP2 container) into a
    (rows, cols) int32 array (signed components) or uint8/uint16."""
    from .image import PARSER_ERRORS
    try:
        return _decode(buf)
    except Jpeg2kError:
        raise
    except (ValueError, *PARSER_ERRORS) as ex:
        # malformed marker bodies must surface as the codec error type so
        # io/dicom.py's error wrapping keeps its DicomError contract
        raise Jpeg2kError(f'Corrupt JPEG 2000 codestream ({ex})') from ex


def _decode(buf: bytes) -> np.ndarray:
    buf = _strip_jp2(buf)
    pos = 2  # past SOC
    siz: Optional[_Size] = None
    cod: Optional[_CodingStyle] = None
    quant: Optional[_Quant] = None
    tiles: Dict[int, bytearray] = {}
    tile_cod: Dict[int, _CodingStyle] = {}   # first-tile-part COD overrides
    tile_quant: Dict[int, _Quant] = {}       # first-tile-part QCD overrides
    n = len(buf)
    while pos + 4 <= n:
        (marker,) = struct.unpack_from('>H', buf, pos)
        if marker == _EOC:
            break
        if marker == _SOT:
            (lsot, isot, psot, tpsot, tnsot) = struct.unpack_from(
                '>HHIBB', buf, pos + 2)
            tp_start = pos
            if psot == 0:
                psot = n - pos  # last tile-part extends to EOC
            # scan tile-part header up to SOD
            hp = pos + 2 + lsot
            while hp + 4 <= n:
                (m2,) = struct.unpack_from('>H', buf, hp)
                if m2 == _SOD:
                    hp += 2
                    break
                if m2 in (_COD, _COC, _QCD, _QCC, _RGN, _POC, _PPT):
                    if m2 == _PPT:
                        raise Jpeg2kError(
                            'Packed packet headers (PPT) are not supported')
                    if m2 == _POC:
                        raise Jpeg2kError(
                            'Progression order changes (POC) are not '
                            'supported')
                    if m2 == _RGN:
                        raise Jpeg2kError('ROI shifts (RGN) are not '
                                          'supported')
                    if m2 in (_COC, _QCC):
                        raise Jpeg2kError(
                            'Per-component coding/quantization overrides '
                            '(COC/QCC) are not supported')
                    if tpsot == 0:
                        body = buf[hp + 4:hp + 2
                                   + struct.unpack_from('>H', buf, hp + 2)[0]]
                        if m2 == _COD:
                            tile_cod[isot] = _parse_cod(body)
                        else:
                            base = tile_cod.get(isot, cod)
                            tile_quant[isot] = _parse_qcd(
                                body, base.levels if base else 0)
                (l2,) = struct.unpack_from('>H', buf, hp + 2)
                hp += 2 + l2
            else:
                raise Jpeg2kError('Tile-part without SOD')
            end = tp_start + psot
            if end > n:
                end = n  # tolerate a truncated final tile-part
            tiles.setdefault(isot, bytearray()).extend(buf[hp:end])
            pos = end
            continue
        (length,) = struct.unpack_from('>H', buf, pos + 2)
        body = buf[pos + 4:pos + 2 + length]
        if marker == _SIZ:
            siz = _parse_siz(body)
        elif marker == _COD:
            cod = _parse_cod(body)
        elif marker == _QCD:
            quant = _parse_qcd(body, cod.levels if cod else 0)
        elif marker in (_COC, _QCC):
            raise Jpeg2kError('Per-component coding/quantization overrides '
                              '(COC/QCC) are not supported')
        elif marker == _PPM:
            raise Jpeg2kError('Packed packet headers (PPM) are not '
                              'supported')
        elif marker == _POC:
            raise Jpeg2kError('Progression order changes (POC) are not '
                              'supported')
        elif marker == _RGN:
            raise Jpeg2kError('ROI shifts (RGN) are not supported')
        pos += 2 + length
    if siz is None or cod is None or quant is None:
        raise Jpeg2kError('Missing SIZ/COD/QCD in main header')
    if quant.style != 1 and len(quant.values) < 3 * cod.levels + 1:
        raise Jpeg2kError('Truncated QCD segment')

    # image grid
    w = siz.x - siz.x0
    h = siz.y - siz.y0
    ntx = _ceil_div(siz.x - siz.tx0, siz.tx)
    nty = _ceil_div(siz.y - siz.ty0, siz.ty)
    if ntx * nty > 1 << 20:
        raise Jpeg2kError(f'Implausible tile grid {ntx}x{nty}')
    if siz.signed:
        img = np.zeros((h, w), np.int32)
    else:
        img = np.zeros((h, w), np.uint16 if siz.depth > 8 else np.uint8)
    shift = 0 if siz.signed else 1 << (siz.depth - 1)
    lo = -(1 << (siz.depth - 1)) if siz.signed else 0
    hi = (1 << (siz.depth - 1)) - 1 if siz.signed else (1 << siz.depth) - 1
    for t in range(ntx * nty):
        ti, tj = t % ntx, t // ntx
        tx0 = max(siz.tx0 + ti * siz.tx, siz.x0)
        ty0 = max(siz.ty0 + tj * siz.ty, siz.y0)
        tx1 = min(siz.tx0 + (ti + 1) * siz.tx, siz.x)
        ty1 = min(siz.ty0 + (tj + 1) * siz.ty, siz.y)
        if tx1 <= tx0 or ty1 <= ty0:
            continue
        data = bytes(tiles.get(t, b''))
        tcod = tile_cod.get(t, cod)
        tquant = tile_quant.get(t, quant)
        if tquant.style != 1 and len(tquant.values) < 3 * tcod.levels + 1:
            raise Jpeg2kError('Truncated tile QCD segment')
        vals = _decode_tile(data, tx0, ty0, tx1, ty1, tcod, tquant,
                            siz.depth)
        if tcod.transform == 0:
            vals = np.rint(vals)
        vals = np.clip(vals + shift, lo if siz.signed else 0, hi)
        img[ty0 - siz.y0:ty1 - siz.y0, tx0 - siz.x0:tx1 - siz.x0] = \
            vals.astype(img.dtype)
    return img
