"""The quantized-shape bucket program (``EnsembleEngine(pad_quantum=N)``).

One program per shape bucket (each axis rounded up to a multiple of N)
serves every cropped scan size inside it, so heterogeneous traffic builds a
bounded set of programs, and scans of different sizes share one
micro-batch. A scan arrives placed flush at the bucket's origin with a
valid-extent mask; its true (h, w) is data, and reproduces the exact
program's geometry:

- nnU-Net's even-spread tile origins (``compute_steps_1d``), up to the
  bucket's static tile count, the rest at validity 0;
- the symmetric pad placement (before = total // 2);
- per-scan resample matrices with the mirror-tap B-spline rows of
  ``ops/resample.axis_weights``, applied to coefficients prefiltered over
  a mirror-extended canvas (the IIR boundary init then differs from the
  exact program's by |pole|^gap, pole ~ -0.268).

The reference package derives this geometry on its device in float32
(``ensemble_engine.py:739-820`` there); that float32 arithmetic is why its
bucket program differs from its exact program on borderline pixels, and
the port reproduces it in float32 numpy with the same operation order:
``ceil`` of a float32 quotient, round-half-to-even of ``actual * k``,
``floor`` of ``(r + 0.5) * (h / rs) - 0.5``. It runs on the host, from the
mask the host holds before the upload: reading (h, w) back from the card
would wait for the card's queue. The matrices are built row by row, one
tap offset after another, in the reference's order, so the masks repeat
bit for bit from run to run.

The whole program takes one-pass InstanceNorm statistics, as the
reference's does: it is already non-bitwise against the exact program.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.unet import stats_override
from ..ops.gaussian import gaussian_map
from ..ops.normalize import normalize_channels
from ..ops.resample import apply_separable, bspline_prefilter
from ..utils.device import exact_numerics
from .program import _mirror_combos, _wire_restore, compute_new_shape, upload
from .tiling import accumulate_tiles

F32 = np.float32


def _mirror_i(idx, n: int):
    """scipy 'mirror' reflection of integer indices into [0, n) (numpy, or
    a torch tensor)."""
    if n == 1:
        return idx * 0
    p = 2 * n - 2
    mod = (torch.remainder(idx, p) if isinstance(idx, torch.Tensor)
           else np.mod(idx, p))
    return (n - 1) - abs(mod - (n - 1))


def _b3(t: np.ndarray) -> np.ndarray:
    """The cubic B-spline kernel in float32, in the reference's operation
    order (``at ** 3`` is ``at * at * at`` there too)."""
    at = np.abs(t)
    two = F32(2.0) - at
    return np.where(
        at < F32(1.0), F32(2.0 / 3.0) - at * at + F32(0.5) * (at * at * at),
        np.where(at < F32(2.0), two * two * two / F32(6.0), F32(0.0))
    ).astype(F32)


def _down_matrix(n_canvas: int, n_rs_canvas: int, h: int, rs: int,
                 pb: int) -> np.ndarray:
    """(n_rs_canvas, n_canvas) order-3 matrix for one axis: row o holds
    axis_weights' mirror-tap B-spline row ('edge' coordinates) for the
    scan's resampled row o - pb, zero outside [pb, pb + rs)."""
    o = np.arange(n_rs_canvas)
    r = o - pb
    rowv = ((r >= 0) & (r < rs)).astype(F32)
    hf = F32(h)
    c = (r.astype(F32) + F32(0.5)) * (hf / F32(rs)) - F32(0.5)
    c = np.clip(c, F32(0.0), hf - F32(1.0))
    base = np.floor(c).astype(np.int64)
    M = np.zeros((n_rs_canvas, n_canvas), F32)
    for off in range(-1, 3):
        idx = _mirror_i(base + off, h)
        M[o, idx] += _b3(c - (base + off).astype(F32)) * rowv
    return M


def _up_matrix(n_canvas: int, n_rs_canvas: int, h: int, rs: int,
               pb: int) -> np.ndarray:
    """(n_canvas, n_rs_canvas) order-1 matrix: row r samples the scan's
    resampled rows (offset pb) at axis_weights' linear taps with unclipped
    coordinates (its 'zero' rows), zero for r >= h."""
    r = np.arange(n_canvas)
    rowv = (r < h).astype(F32)
    c = (r.astype(F32) + F32(0.5)) * (F32(rs) / F32(h)) - F32(0.5)
    base = np.floor(c).astype(np.int64)
    frac = c - base.astype(F32)
    M = np.zeros((n_canvas, n_rs_canvas), F32)
    for off, w in ((0, F32(1.0) - frac), (1, frac)):
        M[r, pb + _mirror_i(base + off, rs)] += w * rowv
    return M


def _steps(size: int, n_static: int, p: int, t: float):
    """compute_steps_1d in float32: even-spread tile origins padded to
    n_static, with their validity."""
    num = 1 if size == p else int(np.ceil(F32(size - p) / F32(t))) + 1
    actual = F32(size - p) / F32(max(num - 1, 1))
    k = np.arange(n_static)
    pos = np.rint(actual * k.astype(F32)).astype(np.int64)
    valid = k < num
    return np.where(valid, pos, 0), valid


def scan_extent(mask: np.ndarray) -> Tuple[int, int]:
    """A flush-placed scan's true (h, w) from its valid-extent mask, as the
    reference reads it: the bucket's extent less the trailing empty rows
    (columns)."""
    H, W = mask.shape
    return (H - int(np.argmax(mask.any(axis=1)[::-1])),
            W - int(np.argmax(mask.any(axis=0)[::-1])))


class BucketProgram:
    """The bucket program of one bucket, input spacing and wire: solo
    (``batch=None``: takes a flush-placed (H, W, C) payload and its
    (H, W) mask) or batched over ``batch`` scans of any extents in the
    bucket. Calling it uploads the host arrays through pinned memory and
    returns the device result without waiting for the card."""

    def __init__(self, engine, bucket: Tuple[int, int],
                 in_spacing: Sequence[float], wire=None,
                 batch: Optional[int] = None):
        spec = engine.spec
        self.engine = engine
        self.pre = dataclasses.replace(
            spec.preprocess,
            use_mask_for_norm=(True,) * len(spec.preprocess.use_mask_for_norm))
        self.patch = tuple(int(p) for p in self.pre.patch_size)
        self.bucket = (int(bucket[0]), int(bucket[1]))
        self.wire = wire
        self.batch = batch
        self.ratios = tuple(float(o) / float(s)
                            for o, s in zip(in_spacing, self.pre.spacing))
        self.resamp = tuple(abs(r - 1.0) > 1e-9 for r in self.ratios)
        # the static canvas in resampled space: the largest any scan of the
        # bucket can need (compute_new_shape is monotone in the shape)
        self.rs_canvas = tuple(
            max(compute_new_shape((n,), (o,), (s,))[0] if rz else n, p)
            for n, o, s, p, rz in zip(self.bucket, in_spacing,
                                      self.pre.spacing, self.patch,
                                      self.resamp))
        self.mirrors = _mirror_combos(spec.allowed_mirroring_axes
                                      if engine.use_mirroring else ())
        self.gauss = torch.tensor(gaussian_map(self.patch),
                                  device=engine.device)
        self.target = tuple(p * engine.tile_step_size for p in self.patch)
        # the static per-axis tile counts (monotone in the canvas)
        self.NT = tuple(int(np.ceil((c - p) / t)) + 1 if c > p else 1
                        for c, p, t in zip(self.rs_canvas, self.patch,
                                           self.target))

    @property
    def meta(self) -> dict:
        return {'rs_canvas': self.rs_canvas,
                'n_tiles_max': self.NT[0] * self.NT[1],
                'n_mirror': len(self.mirrors), 'needs_mask': True}

    def geometry(self, mask: np.ndarray) -> dict:
        """Everything a scan's true extent decides, on the host."""
        hw = scan_extent(mask)
        rs = tuple(int(np.rint(F32(hw[k]) * F32(self.ratios[k])))
                   if self.resamp[k] else hw[k] for k in range(2))
        ph = tuple(max(rs[k], self.patch[k]) for k in range(2))
        pb = tuple((ph[k] - rs[k]) // 2 for k in range(2))
        NT = self.NT
        pos_y, val_y = _steps(ph[0], NT[0], self.patch[0], self.target[0])
        pos_x, val_x = _steps(ph[1], NT[1], self.patch[1], self.target[1])
        tiles = np.stack([np.repeat(pos_y, NT[1]), np.tile(pos_x, NT[0])], -1)
        valid = np.repeat(val_y, NT[1]) & np.tile(val_x, NT[0])
        down = [_down_matrix(self.bucket[k], self.rs_canvas[k], hw[k], rs[k],
                             pb[k]) if self.resamp[k] else None
                for k in range(2)]
        up = [_up_matrix(self.bucket[k], self.rs_canvas[k], hw[k], rs[k],
                         pb[k]) if self.resamp[k] else None for k in range(2)]
        return {'hw': hw, 'pb': pb, 'tiles': tiles[valid], 'down': down,
                'up': up}

    def __call__(self, payload, nz_mask: np.ndarray):
        masks = np.asarray(nz_mask)
        solo = self.batch is None
        geos = [self.geometry(m) for m in (masks[None] if solo else masks)]
        dev = self.engine.device
        valid = None
        if not solo:
            # every scan's valid tiles, padded to the batch's largest count
            # with tiles of validity 0 at the origin
            T = max(len(g['tiles']) for g in geos)
            tiles = np.zeros((len(geos), T, 2), np.int64)
            valid = np.zeros((len(geos), T), F32)
            for i, g in enumerate(geos):
                tiles[i, :len(g['tiles'])] = g['tiles']
                valid[i, :len(g['tiles'])] = 1.0
        with torch.inference_mode(), exact_numerics(), stats_override('1pass'):
            mats = [{k: [upload(m, dev) for m in g[k]] for k in ('down', 'up')}
                    for g in geos]
            out = self._device(upload(payload, dev), upload(nz_mask, dev),
                               geos, mats,
                               geos[0]['tiles'] if solo else tiles,
                               upload(valid, dev))
            return self.engine._pack(out)

    def _device(self, x, nz_mask, geos, mats, tiles, valid):
        eng, dev = self.engine, self.engine.device
        H, W = self.bucket
        solo = self.batch is None
        resampled = [k for k in range(2) if self.resamp[k]]
        x = _wire_restore(x, self.wire)
        works = []
        for i, geo in enumerate(geos):
            work = normalize_channels(x if solo else x[i], self.pre,
                                      nz_mask if solo else nz_mask[i])
            # the exact program pads zeros after normalization: zero what
            # lies outside the scan's rect (in-rect pixels outside the
            # mask keep their value, as there)
            h, w = geo['hw']
            work[h:] = 0.0
            work[:, w:] = 0.0
            # mirror-extend the scan over the canvas on the resampled axes:
            # the prefilter's boundary init then sees the scan's own mirror
            if self.resamp[0]:
                work = work[_mirror_i(torch.arange(H, device=dev), h)]
            if self.resamp[1]:
                work = work[:, _mirror_i(torch.arange(W, device=dev), w)]
            works.append(work)
        work = works[0] if solo else torch.stack(works)
        if resampled:
            work = bspline_prefilter(work, [k + (0 if solo else 1)
                                            for k in resampled])
        canvases = []
        for i, geo in enumerate(geos):
            wk = work if solo else work[i]
            wk = apply_separable(wk, mats[i]['down'], axes=(0, 1))
            # grow the axes that are not resampled to the static tile canvas
            # (a bucket below the patch still tiles over >= patch), then
            # place the scan as the symmetric pad does
            grow = [self.rs_canvas[k] - wk.shape[k] for k in range(2)]
            wk = F.pad(wk.movedim(-1, 0), (0, grow[1], 0, grow[0]))
            for k in range(2):
                if not self.resamp[k] and geo['pb'][k]:
                    wk = torch.roll(wk, geo['pb'][k], dims=k + 1)
            canvases.append(wk)
        work = canvases[0] if solo else torch.stack(canvases)

        lead = () if solo else (len(geos),)
        acc = torch.zeros(eng.acc_prefix[:-1] + lead + eng.acc_prefix[-1:]
                          + self.rs_canvas, device=dev)
        wacc = torch.zeros(lead + (1,) + self.rs_canvas, device=dev)
        accumulate_tiles(work, tiles, eng._net, acc, wacc, patch=self.patch,
                         mirrors=self.mirrors, gauss=self.gauss,
                         chunk_cap=eng.forward_batch_cap, valid=valid)
        logits = acc / torch.clamp(wacc, min=1e-8)
        outs = []
        for i, geo in enumerate(geos):
            lg = logits if solo else logits[:, i]
            lg = apply_separable(lg, mats[i]['up'], axes=(-2, -1))
            for k in range(2):
                if not self.resamp[k] and geo['pb'][k]:
                    lg = torch.roll(lg, -geo['pb'][k], dims=k - 2)
            outs.append(lg[..., :H, :W])  # drop the tile canvas' growth
        return eng._decide(outs[0] if solo else torch.stack(outs, dim=1))
