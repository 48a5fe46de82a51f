"""The scan programs both engines run, and their shared host API.

    wire restore -> normalize -> B-spline prefilter + matmul down-resample
    to plan spacing -> symmetric pad -> tile x TTA batched U-Net forwards
    (the engine's models, fold mean) -> Gaussian overlap-add -> weight
    normalization -> un-pad -> order-1 up-resample -> the engine's decision

Everything outside the U-Net is fp32, and the program runs under
:func:`~..utils.device.exact_numerics` (no TF32 for the resample matmuls,
as the reference's ``Precision.HIGHEST``; fixed cuDNN algorithms), and
under ``torch.inference_mode`` in whatever thread calls it. With
``compute_dtype=torch.bfloat16`` only the U-Net forwards run bf16 (the
reference's "fast" precision).

A program takes host arrays: the input (or its int16 wire payload, see
wire.wire_detect) and the normalization mask. It uploads them
through pinned memory without blocking and returns the device result
without waiting for it, so the host can prepare the next scan while the
card runs this one. The batched program (``batch=B``) is the solo program
with a leading scan axis written in: per-scan normalization, the prefilter
and resample over axes 1 and 2, one U-Net call per tile chunk over all B
scans, per-scan overlap-add and decisions.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.convert import load_into
from ..models.plans import ArchSpec, ModelSpec
from ..models.unet import UNet, stats_override
from ..ops.gaussian import gaussian_map
from ..ops.normalize import nonzero_norm_mask, normalize_channels
from ..ops.resample import apply_separable, axis_weights, bspline_prefilter
from ..utils import trace
from ..utils.device import exact_numerics, hold_exact_numerics, resolve_device
from ..utils.logging import log
from .tiling import (accumulate_tiles, accumulate_tiles_sharded, pad_amounts,
                     padded_shape, tile_positions)
from .wire import _wire_restore, plain_wire, ready_event, to_host, upload


def _mirror_combos(axes: Sequence[int]) -> List[Tuple[int, ...]]:
    """All subsets of the allowed mirror axes (identity first).
    Axes are spatial: 0 = y, 1 = x."""
    combos: List[Tuple[int, ...]] = [()]
    for ax in axes:
        combos += [c + (ax,) for c in combos]
    return combos


def compute_new_shape(shape: Sequence[int], old_spacing: Sequence[float],
                      new_spacing: Sequence[float]) -> Tuple[int, ...]:
    """nnU-Net target shape: round(shape * old / new)."""
    return tuple(int(round(n * o / s))
                 for n, o, s in zip(shape, old_spacing, new_spacing))


def spacing_key(spacing: Sequence[float]) -> Tuple[float, ...]:
    """A spacing as the program caches and the batcher's queue key it:
    each value rounded to 6 places."""
    return tuple(round(float(s), 6) for s in spacing)


def _nonzero_bbox(arr: np.ndarray) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Bounding box of non-zero pixels over all channels; the full image if
    everything is zero."""
    mask = np.any(arr != 0, axis=-1) if arr.ndim == 3 else (arr != 0)
    ys, xs = np.nonzero(mask)
    if ys.size == 0:
        return (0, arr.shape[0]), (0, arr.shape[1])
    return ((int(ys.min()), int(ys.max()) + 1),
            (int(xs.min()), int(xs.max()) + 1))


class ScanEngine:
    """One model configuration's scan programs, cached per input shape (and
    wire, and batch), and the solo host API around them. Subclasses give
    the U-Net batch function (:meth:`_net`), the accumulator's leading
    shape (``acc_prefix``), the decision on the device (:meth:`_decide`)
    and its host-side finish (:meth:`_finish`).

    An engine on a card holds :func:`~..utils.device.exact_numerics` for
    its whole life (released by :meth:`close` or when it is collected), so
    concurrent programs never switch the process-wide flags.

    :param device: ``None`` = the CUDA card (raises without one); pass
        ``'cpu'`` to run on the CPU
    :param compute_dtype: ``None`` (exact, fp32) or ``torch.bfloat16``
        (fast: bf16 U-Net forwards)
    :param forward_batch_cap: bound on the tile x TTA forward batch of one
        scan
    :param dtype: the programs' work dtype. Only ``torch.float32``: the
        reference's engines take the parameter, but raise ``TypeError`` on
        the first predict with any other, so another value raises
        ``ValueError`` here
    """

    kind = 'scan'

    def __init__(self, spec: ModelSpec, tile_step_size: float,
                 use_mirroring: bool, compute_dtype: Optional[torch.dtype],
                 device, forward_batch_cap: int = 64,
                 dtype: torch.dtype = torch.float32):
        if compute_dtype not in (None, torch.bfloat16):
            raise ValueError(f'compute_dtype must be None or torch.bfloat16, '
                             f'got {compute_dtype}')
        if dtype != torch.float32:
            raise ValueError(f'dtype must be torch.float32, got {dtype}')
        self.device = resolve_device(device)
        self.spec = spec
        self.tile_step_size = float(tile_step_size)
        self.use_mirroring = bool(use_mirroring)
        self.compute_dtype = compute_dtype
        self.forward_batch_cap = int(forward_batch_cap)
        self.compact_wire = False
        self.acc_prefix: Tuple[int, ...] = ()
        self.n_folds = 0
        # the tile-sharded solo program's mesh and axis (EnsembleEngine)
        self.tile_mesh = None
        self.tile_axis = 'data'
        self._cache: Dict[Tuple, object] = {}
        # request threads and the micro-batcher build programs concurrently:
        # one shape builds once
        self._cache_lock = threading.RLock()
        release = (hold_exact_numerics() if self.device.type == 'cuda'
                   else (lambda: None))
        self._numerics = weakref.finalize(self, release)

    def close(self) -> None:
        """Release the engine's hold on the exact numerics settings."""
        self._numerics()

    def _load_net(self, arch: ArchSpec, sd: Dict[str, torch.Tensor]) -> UNet:
        net = UNet(arch)
        load_into(net, sd)
        net = net.to(self.device).eval()
        return net.prepare_fast() if self.compute_dtype is not None else net

    # -- what a subclass gives ----------------------------------------------

    def _net(self, batch: torch.Tensor) -> torch.Tensor:
        """(B, C, ph, pw) -> (*acc_prefix[:-1], B, L, ph, pw) fold-mean
        logits."""
        raise NotImplementedError

    def _decide(self, logits: torch.Tensor) -> torch.Tensor:
        """(*acc_prefix[:-1], *lead, L, H, W) logits on the input grid ->
        the device result that is downloaded, ``lead`` first."""
        raise NotImplementedError

    def _finish(self, out: np.ndarray) -> np.ndarray:
        """The downloaded result -> (H, W[, L]) uint8."""
        return out

    def _pack(self, out: torch.Tensor):
        """The served result of a program (the compact wire's pair in the
        ensemble engine)."""
        return out

    # -- the programs -----------------------------------------------------

    def _build(self, in_shape: Tuple[int, int], in_spacing: Tuple[float, float],
               wire=None, batch: Optional[int] = None,
               force_norm_mask: bool = False, with_logits: bool = False):
        """The program of one cropped shape: (program, meta). ``program``
        takes host arrays; ``meta['raw']`` is its device part, device
        tensors in, the decided result out (no compaction, no statistics
        override), for the programs that compose it with more device work
        (the volume and cohort programs).

        ``with_logits``: the program returns (result, logits): beside the
        decided result, the fold-mean logits after the order-1 inverse
        resample, channels last (h, w, L) on the cropped input grid, in
        float32.

        ``force_norm_mask``: the masked program. Every channel takes the
        z-score statistics of the mask (a scan's true extent inside a
        padded canvas), and everything outside the mask is zero again
        after normalization, as the exact program pads zeros after it
        (schemes that ignore the mask, CTNormalization, shift the zeros)."""
        pre = self.spec.preprocess
        if force_norm_mask:
            pre = dataclasses.replace(
                pre, use_mask_for_norm=(True,) * len(pre.use_mask_for_norm))
        patch = tuple(pre.patch_size)
        dev = self.device

        rs_shape = compute_new_shape(in_shape, in_spacing, pre.spacing)
        pad_shape = padded_shape(rs_shape, patch)
        pads = pad_amounts(rs_shape, pad_shape)
        tiles = tile_positions(pad_shape, patch, self.tile_step_size)
        mirrors = _mirror_combos(self.spec.allowed_mirroring_axes
                                 if self.use_mirroring else ())
        gauss = torch.tensor(gaussian_map(patch), device=dev)

        def _w(n_in, n_out, order):
            if n_in == n_out:
                return None
            coords = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
            return torch.tensor(axis_weights(n_in, coords, order, outside='edge'),
                                dtype=torch.float32, device=dev)

        w_down = [_w(in_shape[k], rs_shape[k], 3) for k in range(2)]
        w_up = [_w(rs_shape[k], in_shape[k], 1) for k in range(2)]
        down_axes = [k for k in range(2) if w_down[k] is not None]
        lead = () if batch is None else (int(batch),)
        a0 = len(lead)  # the first spatial axis of (*lead, H, W, C)

        def device_program(x: torch.Tensor,
                           nz_mask: Optional[torch.Tensor]) -> torch.Tensor:
            # x: the wire payload, (*lead, H, W, C) on the device
            with trace.span('program.normalize'):
                x = _wire_restore(x, wire)
                if batch is None:
                    work = normalize_channels(x, pre, nz_mask)
                else:  # statistics per scan
                    work = torch.stack([normalize_channels(
                        x[i], pre, None if nz_mask is None else nz_mask[i])
                        for i in range(batch)])
                if force_norm_mask and nz_mask is not None:
                    work = torch.where(nz_mask[..., None], work, 0.0)
            with trace.span('program.resample'):
                if down_axes:
                    work = bspline_prefilter(work, [a0 + k for k in down_axes])
                    work = apply_separable(work, w_down, axes=(a0, a0 + 1))
                work = F.pad(work.movedim(-1, -3),
                             (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
            with trace.span('program.tiles'):
                acc = torch.zeros(self.acc_prefix[:-1] + lead
                                  + self.acc_prefix[-1:] + pad_shape,
                                  device=dev)
                wacc = torch.zeros((1,) + pad_shape, device=dev)
                tile_kw = dict(patch=patch, mirrors=mirrors, gauss=gauss,
                               chunk_cap=self.forward_batch_cap)
                if batch is None and self.tile_mesh is not None:
                    accumulate_tiles_sharded(work, tiles, self._net, acc,
                                             wacc, self.tile_mesh,
                                             self.tile_axis, **tile_kw)
                else:
                    accumulate_tiles(work, tiles, self._net, acc, wacc,
                                     **tile_kw)
            with trace.span('program.merge'):
                logits = acc / torch.clamp(wacc, min=1e-8)
                logits = logits[..., pads[0][0]:pads[0][0] + rs_shape[0],
                                pads[1][0]:pads[1][0] + rs_shape[1]]
            with trace.span('program.upsample'):
                logits = apply_separable(logits, w_up, axes=(-2, -1))
            with trace.span('program.decide'):
                if with_logits:
                    return self._decide(logits), logits.movedim(-3, -1)
                return self._decide(logits)

        def program(payload, nz_mask: Optional[np.ndarray] = None):
            """Host payload (and mask) in, the device result out, without
            waiting for the card. The batched program takes one-pass
            InstanceNorm statistics, as the reference's does."""
            stats = (stats_override('1pass') if batch is not None
                     else contextlib.nullcontext())
            with torch.inference_mode(), exact_numerics(), stats:
                with trace.span('program.upload'):
                    x, m = upload(payload, dev), upload(nz_mask, dev)
                with trace.span('program.enqueue'):
                    out = device_program(x, m)
                    with trace.span('program.pack'):
                        if with_logits:
                            return self._pack(out[0]), out[1]
                        return self._pack(out)

        meta = {'rs_shape': rs_shape, 'n_tiles': len(tiles),
                'n_mirror': len(mirrors),
                'needs_mask': any(pre.use_mask_for_norm),
                'raw': device_program}
        return program, meta

    def _cached(self, key: tuple, build, describe):
        """The program cached under ``key``, built once: on a miss
        ``build()`` runs in a ``program.build`` span and ``describe(hit)``
        is logged. The lock is re-entrant: a build may build the program it
        extends."""
        with self._cache_lock:
            hit = self._cache.get(key)
            if hit is None:
                with trace.span('program.build'):
                    hit = self._cache[key] = build()
                log(describe(hit))
        return hit

    def _program(self, in_shape, in_spacing, wire=None, logits=False):
        """The solo program for one cropped shape, spacing and input wire,
        built once: (program, meta). ``logits``: its variant that also
        returns the logits (:meth:`_build`), cached under its own key."""
        wire = plain_wire(wire)
        key = (tuple(in_shape), spacing_key(in_spacing),
               wire) + (('logits',) if logits else ())
        return self._cached(
            key, lambda: self._build(tuple(in_shape), tuple(in_spacing), wire,
                                     with_logits=logits),
            lambda hit: f'prepared {self.kind} program for shape={key[0]} '
            f'({hit[1]["n_tiles"]} tiles, {hit[1]["n_mirror"]} mirrors, '
            f'{self.n_folds} folds, '
            f'{"fast" if self.compute_dtype else "exact"}, {self.device}'
            + (f', int16 wire {wire}' if wire else '')
            + (', logits' if logits else '') + ')')

    # -- host API -----------------------------------------------------------

    def _crop(self, arr: np.ndarray):
        """(H, W[, C]) input -> (cropped (h, w, C), its normalization mask
        or None, bbox): nnU-Net crop_to_nonzero."""
        if arr.ndim == 2:
            arr = arr[..., None]
        if arr.shape[-1] != self.spec.arch.in_channels:
            raise ValueError(
                f'Input has {arr.shape[-1]} channels; the models expect '
                f'{self.spec.arch.in_channels}')
        (y0, y1), (x0, x1) = _nonzero_bbox(arr)
        cropped = np.ascontiguousarray(arr[y0:y1, x0:x1])
        mask = (nonzero_norm_mask(cropped)
                if any(self.spec.preprocess.use_mask_for_norm) else None)
        return cropped, mask, ((y0, y1), (x0, x1))

    def _place(self, seg_c: np.ndarray, bbox, full) -> np.ndarray:
        """Re-embed a cropped result into the full input extent. A third
        bbox entry (y, x, h, w) is the scan's window in a shape bucket
        (pad_quantum), sliced out first."""
        if len(bbox) == 3:
            sy, sx, h, w = bbox[2]
            seg_c = seg_c[sy:sy + h, sx:sx + w]
            bbox = bbox[:2]
        (y0, y1), (x0, x1) = bbox
        if seg_c.shape[:2] == tuple(full):
            return seg_c
        seg = np.zeros(tuple(full) + seg_c.shape[2:], np.uint8)
        seg[y0:y1, x0:x1] = seg_c
        return seg

    def predict_array(self, arr: np.ndarray, spacing_yx: Sequence[float],
                      return_logits: bool = False):
        """(H, W, C) float array with array-order (y, x) spacing -> the
        engine's uint8 result on the full (H, W) grid. Crops to the nonzero
        bounding box first (nnU-Net crop_to_nonzero). ``return_logits``:
        ``(seg, logits, bbox)``, the fold-mean logits (h, w, L) float32 on
        the cropped grid, where the decision was taken, and the crop
        ``((y0, y1), (x0, x1))``, through the logits variant of the
        program (its own cache entry)."""
        cropped, mask, bbox = self._crop(arr)
        program, _ = self._program(cropped.shape[:2], spacing_yx,
                                   logits=return_logits)
        out = program(cropped.astype(np.float32), mask)
        ready = ready_event(out)
        seg_d, logits_d = out if return_logits else (out, None)
        seg = self._place(self._finish(to_host(seg_d, ready)), bbox,
                          arr.shape[:2])
        if not return_logits:
            return seg
        return seg, to_host(logits_d, ready), bbox
