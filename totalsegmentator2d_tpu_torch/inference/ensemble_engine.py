"""EnsembleEngine: all anatomical-group models and folds on one scan.

The solo program of the reference package (inference/program.py) with the
G x F U-Nets of every group run one after another on the same tile batch,
the fold mean per group, then a per-group sigmoid>0.5 (or argmax), the
117-channel concat and bit-packing on the device.

``compute_dtype=None`` is the exact fp32 program; ``torch.bfloat16`` the
fast one, whose U-Nets run bf16 (models/unet.py) with every parameter
rounded to bf16 first, as the reference's fast ensemble stores them
(``ensemble_engine.py:438-443`` there).

Serving, as in the reference package:

- the **int16 input wire** and the **compact mask wire**
  (inference/wire.py; the names the reference keeps in this module are
  imported here): every program's masks are wrapped where they are
  launched and fetched once, by ``wire.DeviceResult.get``, in the
  ``engine.fetch`` span that counts the bytes copied from the card;
- **async dispatch** (:meth:`EnsembleEngine.predict_array_async` /
  :meth:`~EnsembleEngine.finish_array`, or
  :meth:`~EnsembleEngine.finish_groups`, which unpacks, places and splits
  the masks into each group's array in one native pass, into arrays whose
  pages the engine's pages thread mapped while the scan ran when it was
  dispatched by :meth:`~EnsembleEngine.predict_groups_async`) and
  **micro-batching**
  (``auto_batch=N``: concurrent requests of one shape coalesce into the
  batched program, inference/batching.py);
- **quantized-shape serving** (``pad_quantum=N``): every crop rides the
  bucket program of its shape bucket (inference/bucket.py), so scans of
  different sizes share a program and a micro-batch.

The geometry-as-data programs beside it: the **volume program**
(:meth:`~EnsembleEngine.predict_volume`: the (Z, Y, X) volume uploads in
its own dtype and is projected on the card), the **cohort programs**
(:meth:`~EnsembleEngine.predict_cohort`, same-shape volumes in one batched
program, and :meth:`~EnsembleEngine.predict_cohort_mixed`, grouped by exact
shape or padded into shape buckets through the masked program).

Over a ``torch.distributed`` mesh (parallel/): ``tile_mesh=`` spreads one
scan's tile grid over the ranks of a mesh axis, whose partial accumulators
are summed (inference/tiling.accumulate_tiles_sharded); ``mesh=`` on the
cohort programs runs each data rank's rows through its batched program and
gathers the packed masks, so every rank returns the whole cohort. Every
rank of the mesh makes the same call.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import weakref
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..io.native import (MaskArrays, assemble_masks, map_mask_arrays,
                         maps_ahead)
from ..models.convert import round_to_bf16
from ..models.plans import ModelSpec
from ..models.unet import UNet
from ..ops.normalize import nonzero_norm_mask
from ..ops.projection import project_array, project_arrays_np
from ..utils.device import exact_numerics
from ..utils import trace
from ..utils.logging import warn
from .batching import DynamicBatcher
from .bucket import BucketProgram
from .program import ScanEngine, spacing_key
from .wire import (DeviceResult, _compact_meta, _compact_pack, _pack_bits,
                   _wire_pack, plain_wire, ready_event, to_host, unpack_bits,
                   upload, wire_detect)
# the wire's public names that the reference keeps in its module of this name
from .wire import (fetch_compact, fetch_compact_batch,  # noqa: F401
                   fetch_split, occupied_count, pick_prefix, prefix_buckets,
                   uncompact)


def pad_head(params: Dict[str, torch.Tensor], n_labels: int,
             max_labels: int) -> Dict[str, torch.Tensor]:
    """Pad every segmentation head of a state dict from n_labels to
    max_labels outputs with zero weights and biases: the padded logits are
    exactly 0 and are sliced away before any decision."""
    if n_labels == max_labels:
        return params
    extra = max_labels - n_labels
    out = dict(params)
    for k, v in params.items():
        if k.startswith('decoder.seg_layers.'):
            out[k] = torch.cat([v, v.new_zeros((extra,) + v.shape[1:])])
    return out


def _nonzero_range(vol: np.ndarray, axis: int):
    """[first, last + 1) of the slices along ``axis`` that hold a nonzero
    voxel, or None: the volume's nonzero bounding box along that axis,
    found from both ends inward (a CT's air is nonzero, so this reads one
    slice per end instead of the whole volume)."""
    n = vol.shape[axis]
    lo = next((i for i in range(n) if np.take(vol, i, axis).any()), None)
    if lo is None:
        return None
    hi = next(i for i in range(n - 1, lo - 1, -1)
              if np.take(vol, i, axis).any())
    return lo, hi + 1


#: the Results whose arrays the pages thread may hold mapped ahead of their
#: finish (1.82 GB each for a detector-size radiograph); a scan dispatched
#: beyond them gets no job, and its pass allocates its arrays as it goes
PAGES_AHEAD = 2


class _Paged:
    """A :meth:`EnsembleEngine.predict_groups_async` handle: the scan's
    :meth:`~EnsembleEngine.predict_array_async` handle, the ``merge`` of
    its Result, and the pages thread's job mapping the Result's arrays
    (None: no job). The job holds one of the engine's ``PAGES_AHEAD``
    slots until a finish takes its arrays or it is dropped, or this handle
    is gone unfinished (``release``, a finalizer, frees it once)."""
    __slots__ = ('handle', 'merge', 'pages', 'release', '__weakref__')

    def __init__(self, handle, merge: bool, pages: Optional[Future] = None,
                 slots: Optional[threading.Semaphore] = None):
        self.handle, self.merge, self.pages = handle, merge, pages
        self.release = (weakref.finalize(self, slots.release)
                        if pages is not None else None)

    def take(self) -> Optional[MaskArrays]:
        """Wait for the job and take its arrays, and free its slot; None
        without a job, or where it failed (the system refused a mapping) or
        was cancelled."""
        if self.pages is None:
            return None
        try:
            box = self.pages.result()
        except Exception:
            box = None
        self.release()
        return box.pop() if box else None

    def drop(self) -> None:
        """Let go of a job whose arrays no finish will take: cancelled if
        it has not started, else its arrays dropped as it ends, so nothing
        that still holds the job (a traceback) keeps them mapped."""
        if self.pages is None:
            return
        if self.pages.cancel():
            self.release()
        else:
            self.pages.add_done_callback(lambda _: self.take())


class EnsembleEngine(ScanEngine):
    """Fused multi-group multi-fold inference.

    :param specs: per-group ModelSpecs; architectures must match except for
        the segmentation-head width, and preprocessing must be identical
    :param group_fold_params: state_dicts[group][fold] of the UNet module
    :param dtype: the work dtype, ``torch.float32`` only (see
        :class:`~.program.ScanEngine`)
    :param compute_dtype: ``None`` (exact) or ``torch.bfloat16`` (fast)
    :param forward_batch_cap: bound on one scan's tile x TTA forward batch
    :param auto_batch: N = concurrent :meth:`predict_array_async` requests
        coalesce into batched programs of N scans (DynamicBatcher, its
        dispatcher thread stops in :meth:`close`); None = every request
        runs the solo program on the caller's thread
    :param compact_wire: the programs return the compacted masks and the
        host fetches only their occupied tiles (default on; TS2D_COMPACT=0
        or False: the plain packed array). Bit-identical either way.
    :param pad_quantum: N = quantized-shape serving: a crop rides the
        bucket program of its shape rounded up to a multiple of N per axis
        (inference/bucket.py), whose masks match the exact per-shape
        program's up to borderline pixels; None = the exact programs
    :param tile_mesh: a mesh (parallel.make_mesh): the solo program's
        tile grid shards over its ``tile_axis``, each rank running its
        contiguous share, and the partial accumulators are summed over the
        axis; every rank calls predict with the same scan. Not with
        ``auto_batch``.
    :param tile_axis: the mesh axis of ``tile_mesh`` (default 'data')
    :param device: ``None`` = the CUDA card (raises without one); pass
        ``'cpu'`` to run on the CPU
    """

    kind = 'ensemble'

    def __init__(self, specs: Sequence[ModelSpec],
                 group_fold_params: Sequence[Sequence[Dict[str, torch.Tensor]]],
                 tile_step_size: float = 0.5, use_mirroring: bool = True,
                 dtype: torch.dtype = torch.float32,
                 compute_dtype: Optional[torch.dtype] = None, tile_mesh=None,
                 tile_axis: str = 'data', forward_batch_cap: int = 64,
                 auto_batch: Optional[int] = None,
                 pad_quantum: Optional[int] = None,
                 compact_wire: Optional[bool] = None, device=None):
        if pad_quantum is not None and int(pad_quantum) < 1:
            raise ValueError('pad_quantum must be >= 1')
        if auto_batch is not None and tile_mesh is not None:
            # the batcher stacks scans into the batched program; the
            # tile-sharded program spreads one scan over the ranks: scale
            # throughput OR one scan's latency, not both
            raise ValueError('auto_batch cannot be combined with tile_mesh')
        if not specs:
            raise ValueError('At least one group is required')
        # before anything can raise: close() reads them
        self._batcher = self._pager = None
        super().__init__(specs[0], tile_step_size, use_mirroring,
                         compute_dtype, device, forward_batch_cap, dtype)
        self.specs = list(specs)
        if tile_mesh is not None:
            from ..parallel.mesh import axis_size, check_mesh
            if not axis_size(check_mesh(tile_mesh), tile_axis):
                raise ValueError(f'tile_mesh has no axis {tile_axis!r}')
        self.tile_mesh, self.tile_axis = tile_mesh, tile_axis
        head_free = dataclasses.replace(self.spec.arch, out_channels=0)
        for s in specs[1:]:
            if s.preprocess != self.spec.preprocess:
                raise ValueError('All groups must share one preprocessing '
                                 'configuration')
            if dataclasses.replace(s.arch, out_channels=0) != head_free:
                raise ValueError('All groups must share one architecture '
                                 '(up to the segmentation-head width)')
        for s in specs:
            # the merge maps channel i <-> label value i+1 (multilabel) and
            # one_hot[..., 1:] <-> sorted values (softmax): both need
            # contiguous 1-based label values
            if s.labels and sorted(s.labels) != list(range(1, len(s.labels) + 1)):
                raise ValueError(
                    f'Label values must be contiguous starting at 1 for the '
                    f'fused ensemble; got {sorted(s.labels)}')
        self.label_counts = [s.arch.out_channels for s in specs]
        # packed output channels per group: softmax groups drop background
        self.output_label_counts = [
            s.arch.out_channels - (0 if s.multilabel else 1) for s in specs]
        self.max_labels = max(self.label_counts)
        self.n_groups = len(specs)
        self.n_folds = len(group_fold_params[0])
        if any(len(f) != self.n_folds for f in group_fold_params):
            raise ValueError('All groups must provide the same fold count')
        self.acc_prefix = (self.n_groups, self.max_labels)
        if compact_wire is None:
            compact_wire = os.environ.get('TS2D_COMPACT', '1') != '0'
        self.compact_wire = bool(compact_wire)
        self.pad_quantum = int(pad_quantum) if pad_quantum else None

        arch = dataclasses.replace(self.spec.arch, out_channels=self.max_labels)
        self.models: List[List[UNet]] = []
        for g, folds in enumerate(group_fold_params):
            row = []
            for sd in folds:
                sd = pad_head(sd, self.label_counts[g], self.max_labels)
                if compute_dtype is not None:
                    sd = round_to_bf16(sd)
                row.append(self._load_net(arch, sd))
            self.models.append(row)
        if auto_batch is not None:
            self._batcher = DynamicBatcher(self, max_batch=auto_batch)
        # maps each scan's Result arrays while the scan runs (finish_groups)
        self._pager = ThreadPoolExecutor(1, thread_name_prefix='ts2d-pages')
        self._pages_slots = threading.BoundedSemaphore(PAGES_AHEAD)

    def close(self) -> None:
        """Stop the micro-batch dispatcher thread (if enabled) and the
        pages thread, and release the exact-numerics hold."""
        if self._batcher is not None:
            self._batcher.stop()
            self._batcher = None
        if self._pager is not None:
            self._pager.shutdown(wait=False, cancel_futures=True)
            self._pager = None
        super().close()

    def set_batch_linger(self, linger_ms: float) -> None:
        """Throughput knob for the micro-batcher: hold a partial batch up to
        ``linger_ms`` waiting for it to fill (a partial batch pads to
        max_batch and costs a full program). 0 = dispatch at once
        (latency first, the default)."""
        if self._batcher is None:
            raise RuntimeError('micro-batching is not enabled '
                               '(construct with auto_batch=N)')
        self._batcher.linger_ms = float(linger_ms)

    @property
    def total_labels(self) -> int:
        """Total packed output channels (softmax groups contribute
        out_channels - 1: background is dropped on device)."""
        return sum(self.output_label_counts)

    def labels(self) -> Dict[int, str]:
        """Merged label map: 1-based values in group order."""
        out: Dict[int, str] = {}
        v = 0
        for s in self.specs:
            for _, name in sorted(s.labels.items()):
                v += 1
                out[v] = name
        return out

    # -- the programs -----------------------------------------------------

    def _net(self, batch: torch.Tensor) -> torch.Tensor:
        """(B, C, ph, pw) -> (G, B, Lp, ph, pw): every group's fold mean."""
        outs = []
        for folds in self.models:
            logits = [m.forward_nchw(batch, self.compute_dtype) for m in folds]
            outs.append(torch.stack(logits).mean(dim=0))
        return torch.stack(outs)

    def _decide(self, logits: torch.Tensor) -> torch.Tensor:
        """(G, *lead, Lp, H, W) -> (*lead, H, W, ceil(L/8)) packed
        per-group decisions, channels last."""
        parts = []
        for g, n in enumerate(self.label_counts):
            lg = logits[g, ..., :n, :, :].movedim(-3, -1)
            if self.specs[g].multilabel:
                parts.append((torch.sigmoid(lg) > 0.5).to(torch.uint8))
            else:
                parts.append(F.one_hot(torch.argmax(lg, dim=-1), n)
                             .to(torch.uint8)[..., 1:])
        return _pack_bits(torch.cat(parts, dim=-1))

    def _pack(self, out: torch.Tensor):
        return _compact_pack(out) if self.compact_wire else out

    def _finish(self, out: np.ndarray) -> np.ndarray:
        return unpack_bits(out, self.total_labels)

    def _compact_layout(self, h: int, w: int) -> dict:
        return _compact_meta(h, w, -(-self.total_labels // 8))

    def _build(self, in_shape, in_spacing, wire=None, batch=None,
               force_norm_mask=False, with_logits=False):
        program, meta = super()._build(in_shape, in_spacing, wire, batch,
                                       force_norm_mask, with_logits)
        if self.compact_wire:
            meta['compact'] = self._compact_layout(in_shape[0], in_shape[1])
        return program, meta

    def _build_bucket(self, bucket, in_spacing, wire=None, batch=None):
        """The bucket program (inference/bucket.py), solo or batched."""
        program = BucketProgram(self, bucket, in_spacing, wire, batch)
        meta = program.meta
        if self.compact_wire:
            meta['compact'] = self._compact_layout(bucket[0], bucket[1])
        return program, meta

    def _program_bucket(self, bucket, in_spacing, wire=None):
        wire = plain_wire(wire)
        return self._cached(
            ('bucket', tuple(bucket), spacing_key(in_spacing), wire),
            lambda: self._build_bucket(tuple(bucket), tuple(in_spacing), wire),
            lambda hit: f'prepared bucket serving program for bucket='
            f'{tuple(bucket)} (q={self.pad_quantum}, <= '
            f'{hit[1]["n_tiles_max"]} tiles'
            + (f', int16 wire {wire}' if wire else '') + ')')

    def _program_padded(self, in_shape, in_spacing, wire=None):
        """The masked program: normalization statistics from an explicit
        valid-extent mask instead of the whole array, for the padded
        mixed-shape cohorts."""
        wire = plain_wire(wire)
        return self._cached(
            ('2d-masked', tuple(in_shape), spacing_key(in_spacing), wire),
            lambda: self._build(tuple(in_shape), tuple(in_spacing), wire,
                                force_norm_mask=True),
            lambda _: f'prepared masked ensemble program for shape='
            f'{tuple(in_shape)}' + (f', int16 wire {wire}' if wire else ''))

    def _serving_program(self, in_shape, in_spacing, wire=None):
        """The program predict_array dispatches: the bucket program under
        quantized-shape serving, the exact per-shape one otherwise."""
        if self.pad_quantum is not None:
            return self._program_bucket(in_shape, in_spacing, wire)
        return self._program(in_shape, in_spacing, wire)

    def _batched_program(self, batch: int, in_shape, in_spacing,
                         has_mask: bool, wire=None):
        """The serving program over a stacked batch of ``batch`` scans of
        one (bucket) shape (the micro-batching dispatch path): (program,
        meta), where meta is the solo program's, shared, so the compact
        wire's hints live in one dict."""
        wire = plain_wire(wire)
        bucketed = self.pad_quantum is not None
        _, meta = self._serving_program(in_shape, in_spacing, wire)
        build = self._build_bucket if bucketed else self._build
        return self._cached(
            ('batch', int(batch), tuple(in_shape), spacing_key(in_spacing),
             bool(has_mask), wire, bucketed),
            lambda: (build(tuple(in_shape), tuple(in_spacing), wire,
                           batch=int(batch))[0], meta),
            lambda _: f'prepared batched ensemble program for shape='
            f'{tuple(in_shape)} batch={batch}' + (' (bucket)' if bucketed
                                                  else ''))

    # -- host API ------------------------------------------------------------

    def predict_array_async(self, arr: np.ndarray, spacing_yx: Sequence[float]):
        """Crop (nnU-Net crop_to_nonzero) and dispatch without waiting for
        the card; returns a handle for :meth:`finish_array`. With
        micro-batching the request joins the dispatcher's queue; without,
        the solo program is launched on this thread. Under pad_quantum the
        crop goes flush into its shape bucket with a valid-extent mask."""
        with trace.span('engine.crop'):
            cropped, mask, bbox = self._crop(arr)
            if self.pad_quantum is not None:
                q = self.pad_quantum
                h, w = cropped.shape[:2]
                qh, qw = -(-h // q) * q, -(-w // q) * q
                emb = np.zeros((qh, qw) + cropped.shape[2:], cropped.dtype)
                emb[:h, :w] = cropped
                m = np.zeros((qh, qw), bool)
                m[:h, :w] = mask if mask is not None else True
                cropped, mask = emb, m
                bbox = bbox + ((0, 0, h, w),)
        # exactly-integral channels (CT MIP, integer X-rays) ride the wire
        # as int16: half the upload bytes, bit-identical results
        with trace.span('engine.wire'):
            wire = wire_detect(cropped)
        if self._batcher is not None:
            return self._batcher.submit(cropped, mask, spacing_yx, bbox,
                                        arr.shape[:2], wire)
        return (self._launch_solo(cropped, mask, spacing_yx, wire), None,
                bbox, arr.shape[:2])

    def predict_groups_async(self, arr: np.ndarray,
                             spacing_yx: Sequence[float],
                             merge: bool = True) -> _Paged:
        """:meth:`predict_array_async` for :meth:`finish_groups`, with
        ``merge``. Where the Result has an array large enough to map ahead
        (``io.native.maps_ahead``) and fewer than ``PAGES_AHEAD`` Results
        hold mapped pages, the pages thread is first given the job of
        mapping and populating its arrays (``engine.pages``), which it does
        while the scan is cropped, run and fetched, so that the finish's
        pass writes into present pages."""
        if self._pager is None:
            raise RuntimeError('the engine is closed')
        counts = self.output_label_counts
        pages = None
        if (maps_ahead(arr.shape[:2], counts, merge)
                and self._pages_slots.acquire(blocking=False)):
            pages = self._pager.submit(self._map_pages, arr.shape[:2],
                                       merge, trace.scans())
        paged = _Paged(None, merge, pages, self._pages_slots)
        try:
            paged.handle = self.predict_array_async(arr, spacing_yx)
        except BaseException:
            paged.drop()
            raise
        return paged

    def _map_pages(self, full, merge: bool, scans) -> List:
        """The pages thread's job: [the Result's arrays from
        ``io.native.map_mask_arrays``], a list that :meth:`_Paged.take`
        empties."""
        with trace.span('engine.pages', scan=scans):
            got = map_mask_arrays(full, self.output_label_counts, merge)
            if got is not None:
                trace.count_bytes(sum(a.nbytes for a in (got[0], *got[1])
                                      if a is not None))
            return [got]

    def _launch_solo(self, cropped: np.ndarray, mask, spacing_yx,
                     wire) -> DeviceResult:
        """The serving program on one cropped scan, launched without
        waiting for the card (on the caller's thread, or the batcher's for
        a lone request)."""
        fn, meta = self._serving_program(cropped.shape[:2], spacing_yx, wire)
        with trace.span('program.wire_pack'):
            payload = _wire_pack(cropped, wire)
        return DeviceResult(fn(payload, mask), meta.get('compact'))

    def _wait_packed(self, handle):
        """Wait for a :meth:`predict_array_async` handle, (DeviceResult,
        the scan's row in it or None, bbox, full (H, W)) or the batcher's
        future of one: (the scan's packed masks on the host, its bbox, the
        full (H, W))."""
        if isinstance(handle, Future):
            with trace.span('engine.wait'):
                result, idx, bbox, full = handle.result()
                packed = result.get()
        else:
            result, idx, bbox, full = handle
            packed = result.get()
        return (packed if idx is None else packed[idx]), bbox, full

    def finish_array(self, handle) -> np.ndarray:
        """Wait for a :meth:`predict_array_async` handle; returns the
        full-size merged multilabel one-hot uint8 segmentation."""
        packed, bbox, full = self._wait_packed(handle)
        with trace.span('engine.unpack'):
            seg = unpack_bits(packed, self.total_labels)
        with trace.span('engine.place'):
            return self._place(seg, bbox, full)

    def finish_groups(self, paged: _Paged
                      ) -> Tuple[Optional[np.ndarray], List[np.ndarray]]:
        """Wait for a :meth:`predict_groups_async` handle; returns (the
        merged segmentation :meth:`finish_array` returns, or None without
        its ``merge``; [each group's channels of it, in group order]), every
        array C-contiguous and its own memory. One native pass unpacks,
        places and splits the masks on the host's cores
        (``io.native.assemble_masks``), into the arrays the pages thread
        mapped where the dispatch gave it the job (waited for in
        ``engine.pages_wait``; fresh ones where it failed); without the
        library, numpy's unpack, place and copies give the same arrays."""
        merge = paged.merge
        packed, bbox, full = self._wait_packed(paged.handle)
        out = None
        if paged.pages is not None:
            with trace.span('engine.pages_wait'):
                out = paged.take()
        counts = self.output_label_counts
        with trace.span('engine.unpack'):
            window = bbox[2] if len(bbox) == 3 else (0, 0) + packed.shape[:2]
            (y0, _), (x0, _) = bbox[:2]
            got = assemble_masks(packed, window, (y0, x0), full, counts,
                                 merge, out)
            if got is not None:
                return got
            seg = self._place(unpack_bits(packed, self.total_labels), bbox,
                              full)
            ends = np.cumsum([0] + counts)
            return (np.ascontiguousarray(seg) if merge else None,
                    [np.ascontiguousarray(seg[..., a:b])
                     for a, b in zip(ends[:-1], ends[1:])])

    def predict_array(self, arr: np.ndarray, spacing_yx: Sequence[float]
                      ) -> np.ndarray:
        """(H, W, C) float array -> (H, W, sum(labels)) merged multilabel
        one-hot uint8."""
        return self.finish_array(self.predict_array_async(arr, spacing_yx))

    def warmup(self, in_shape: Sequence[int],
               in_spacing: Optional[Sequence[float]] = None,
               wire=None) -> None:
        """Run the serving program once on an all-zero input of this shape
        (under pad_quantum: of its bucket), and the batched program too when
        micro-batching is on: the first requests then find their programs
        built and the card's libraries loaded. ``wire``: the input-wire
        variant (None = float32; a per-channel bool tuple = that int16
        wire, see wire_detect)."""
        if in_spacing is None:
            in_spacing = self.spec.preprocess.spacing
        if wire is not None and len(wire) != self.spec.arch.in_channels:
            raise ValueError(f'wire needs {self.spec.arch.in_channels} '
                             f'channel flags; got {wire}')
        in_shape = tuple(in_shape)
        if self.pad_quantum is not None:
            q = self.pad_quantum
            in_shape = tuple(-(-d // q) * q for d in in_shape)
        dummy = np.zeros(in_shape + (self.spec.arch.in_channels,), np.float32)
        if self.pad_quantum is not None:
            mask = np.ones(in_shape, bool)
        elif any(self.spec.preprocess.use_mask_for_norm):
            mask = nonzero_norm_mask(dummy)
        else:
            mask = None
        fn, _ = self._serving_program(in_shape, tuple(in_spacing), wire)
        outs = [fn(_wire_pack(dummy, wire), mask)]
        if self._batcher is not None:
            B = self._batcher.max_batch
            fn, _ = self._batched_program(B, in_shape, tuple(in_spacing),
                                          mask is not None, wire)
            stacked = np.stack([dummy] * B)
            outs.append(fn(_wire_pack(stacked, wire),
                           None if mask is None else np.stack([mask] * B)))
        for out in outs:
            to_host(out[0] if isinstance(out, tuple) else out,
                    ready_event(out))

    # -- the volume program --------------------------------------------------

    def _project(self, vols: torch.Tensor, modes, axis: int) -> torch.Tensor:
        """The channel projections of device volumes along ``axis``,
        float32 channels last."""
        return torch.stack([project_array(vols, m, axis).squeeze(axis).float()
                            for m in modes], dim=-1)

    def _host_projection(self, vol: np.ndarray, modes) -> np.ndarray:
        """(Z, Y, X) -> (Z, X, C) float32 on the host."""
        return np.concatenate(project_arrays_np(vol, modes, 1),
                              axis=1).transpose(0, 2, 1).astype(np.float32)

    def _build_volume(self, vol_shape: Tuple[int, int, int],
                      spacing_yx: Tuple[float, float],
                      modes: Tuple[str, ...]):
        """ONE program for a (Z, Y, X) RAI volume: it uploads in its own
        dtype, is projected along Y on the card, and the solo 2D program
        runs on the (Z, X, C) projection. Returns (program, compact meta);
        the program returns (masks, projection) on the device."""
        _, meta2d = self._program(vol_shape[::2], spacing_yx)
        if meta2d['needs_mask']:
            raise ValueError('masked-norm plans take the host-projection path')
        raw, dev = meta2d['raw'], self.device

        def program(vol: np.ndarray):
            with torch.inference_mode(), exact_numerics():
                x2d = self._project(upload(vol, dev), modes, 1)
                return self._pack(raw(x2d, None)), x2d

        return program, meta2d.get('compact')

    def predict_volume_async(self, vol: np.ndarray,
                             spacing_yx: Sequence[float],
                             modes: Sequence[str]):
        """Dispatch a volume's prediction without waiting for the card;
        returns a handle for :meth:`finish_volume`. The volume is cropped
        on the host to its nonzero (z, x) bounding box before the upload:
        for the channel modes this equals nnU-Net's crop_to_nonzero of the
        projected image (an all-zero (z, ., x) column projects to 0 in every
        mode), and it shrinks the transfer.

        A plan with use_mask_for_norm needs the hole-filled host mask: it
        projects on the host and runs the 2D program (predict_array)."""
        modes = tuple(modes)
        if any(self.spec.preprocess.use_mask_for_norm):
            proj = self._host_projection(vol, modes)
            return ('hostproj', self.predict_array_async(proj, spacing_yx),
                    proj)
        full_zx = (vol.shape[0], vol.shape[2])
        bbox = (_nonzero_range(vol, 0), _nonzero_range(vol, 2))
        if bbox[0] is None:  # an all-zero volume: no crop
            bbox = ((0, vol.shape[0]), (0, vol.shape[2]))
        (z0, z1), (x0, x1) = bbox
        cropped = vol[z0:z1, :, x0:x1]
        fn, cmeta = self._cached(
            ('vol', cropped.shape, spacing_key(spacing_yx), modes),
            lambda: self._build_volume(tuple(cropped.shape),
                                       tuple(spacing_yx), modes),
            lambda _: f'prepared volume program for shape={cropped.shape}')
        masks, proj = fn(cropped)
        return ('device', DeviceResult(masks, cmeta), proj, bbox, full_zx)

    def finish_volume(self, handle) -> Tuple[np.ndarray, np.ndarray]:
        """Wait for a :meth:`predict_volume_async` handle; returns (merged
        masks (Z, X, sum L), projections (Z, X, C))."""
        if handle[0] == 'hostproj':
            _, inner, proj = handle
            return self.finish_array(inner), proj
        _, result, proj_d, bbox, full_zx = handle
        seg_c = unpack_bits(result.get(), self.total_labels)
        proj_c = to_host(proj_d, result.ready)
        (z0, z1), (x0, x1) = bbox
        if seg_c.shape[:2] == full_zx:
            return seg_c, proj_c
        seg = np.zeros(full_zx + seg_c.shape[2:], np.uint8)
        seg[z0:z1, x0:x1] = seg_c
        proj = np.zeros(full_zx + proj_c.shape[2:], proj_c.dtype)
        proj[z0:z1, x0:x1] = proj_c
        return seg, proj

    def predict_volume(self, vol: np.ndarray, spacing_yx: Sequence[float],
                       modes: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """A (Z, Y, X) RAI volume, projected along the coronal (Y) axis on
        the card -> (merged multilabel masks (Z, X, sum L), projections
        (Z, X, C))."""
        return self.finish_volume(
            self.predict_volume_async(vol, spacing_yx, modes))

    # -- the cohort programs ---------------------------------------------------

    @staticmethod
    def _over_data(mesh, run, rows, *args) -> np.ndarray:
        """``run(*rows, *args)`` (the packed host masks of those rows) over
        the mesh's data axis: the row arrays are padded to a multiple of
        its size D by repeating the last scan, each data rank runs its
        contiguous share, and the shares are gathered over the axis, so
        every rank returns the packed masks of all the rows."""
        if mesh is None:
            return run(*rows, *args)
        from ..parallel.collectives import all_gather_cat
        from ..parallel.mesh import (axis_index, axis_size, check_mesh,
                                     data_axis, named)
        ax = data_axis(check_mesh(mesh))
        D, r = axis_size(mesh, ax), axis_index(mesh, ax)
        n = len(rows[0])
        k = -(-n // D)
        if k * D != n:
            rows = [np.concatenate([a, np.repeat(a[-1:], k * D - n, axis=0)])
                    for a in rows]
        mine = run(*[a[r * k:(r + 1) * k] for a in rows], *args)
        return all_gather_cat(torch.from_numpy(mine), 0,
                              named(mesh, ax)).numpy()[:n]

    def _build_cohort(self, n: int, vol_shape: Tuple[int, int, int],
                      spacing_yx: Tuple[float, float],
                      modes: Tuple[str, ...]):
        """(N, Z, Y, X) same-shape volumes -> their (N, Z, X) masks in one
        batched program. Unlike the batched serving program it keeps the
        solo program's two-pass statistics: a scan's masks are the volume
        program's."""
        _, meta2d = self._program(vol_shape[::2], spacing_yx)
        if meta2d['needs_mask']:
            raise ValueError('masked-norm plans take the host-projection path')
        _, bmeta = self._build(tuple(vol_shape[::2]), tuple(spacing_yx),
                               batch=n)
        raw, dev = bmeta['raw'], self.device

        def program(vols: np.ndarray):
            with torch.inference_mode(), exact_numerics():
                return self._pack(raw(self._project(upload(vols, dev), modes,
                                                    2), None))

        return program, meta2d.get('compact')

    def predict_cohort(self, vols: np.ndarray, spacing_yx: Sequence[float],
                       modes: Sequence[str], mesh=None) -> np.ndarray:
        """(N, Z, Y, X) same-shape RAI volumes -> merged multilabel masks
        (N, Z, X, sum L) uint8 from one batched program. With ``mesh``,
        data parallel over its 'data' (or first) axis: each data rank runs
        its share of the scans (N padded to a multiple of the axis by
        repeating the last scan) and every rank returns the whole cohort.
        For volumes of several shapes, :meth:`predict_cohort_mixed`."""
        modes = tuple(modes)
        if any(self.spec.preprocess.use_mask_for_norm):
            # exact masked normalization needs the hole-filled host mask:
            # project on the host and queue the 2D path (requests coalesce
            # in the micro-batcher when it is on); every rank runs them all
            if mesh is not None:
                warn('predict_cohort ignores the mesh for masked-norm '
                     'plans (exact hole-filled masks are host-side)',
                     once=True)
            handles = [self.predict_array_async(
                self._host_projection(np.ascontiguousarray(v), modes),
                spacing_yx) for v in vols]
            return np.stack([self.finish_array(h) for h in handles])
        from ..parallel.mesh import mesh_key
        packed = self._over_data(mesh, self._cohort_packed,
                                 [np.ascontiguousarray(vols)], spacing_yx,
                                 modes, mesh_key(mesh))
        return unpack_bits(packed, self.total_labels)

    def _cohort_packed(self, vols, spacing_yx, modes, mkey) -> np.ndarray:
        """One batched cohort program's packed host masks."""
        fn, cmeta = self._cached(
            ('cohort', vols.shape, spacing_key(spacing_yx), modes, mkey),
            lambda: self._build_cohort(vols.shape[0], tuple(vols.shape[1:]),
                                       tuple(spacing_yx), modes),
            lambda _: f'prepared cohort program for batch={vols.shape[0]} '
            f'shape={vols.shape[1:]}')
        return DeviceResult(fn(vols), cmeta).get()

    def _build_cohort_padded(self, n: int, vol_shape: Tuple[int, int, int],
                             spacing_yx: Tuple[float, float],
                             modes: Tuple[str, ...]):
        """(N, Zq, Yq, Xq) zero-padded volumes and their true (z, y, x)
        extents -> masks through the batched masked program. The padding is
        masked out of the projections (a zero would beat a negative HU in
        the MIP, and the AIP divides by the true y extent), each scan is
        centred in the bucket as the exact program's symmetric pad places
        it, and the valid extent is the normalization mask; what remains
        is the resample and tile grids seeing the padded extent."""
        for m in modes:
            if m not in ('max', 'mean', 'min'):
                raise ValueError(
                    f"bucket='pad' supports max/mean/min projections; "
                    f"got {m!r} (use bucket='exact')")
        _, meta2d = self._program_padded(vol_shape[::2], spacing_yx)
        _, bmeta = self._build(tuple(vol_shape[::2]), tuple(spacing_yx),
                               batch=n, force_norm_mask=True)
        raw, dev = bmeta['raw'], self.device
        Z, Y, X = vol_shape

        def program(vols: np.ndarray, exts: np.ndarray):
            zl, yl, xl = (exts[:, k] for k in range(3))
            shifts = [(int(a), int(b)) for a, b in zip((Z - zl) // 2,
                                                       (X - xl) // 2)]
            ymask = np.arange(Y)[None, :] < yl[:, None]
            flush = np.zeros((len(exts), Z, X), bool)
            placed = np.zeros((len(exts), Z, X), bool)
            for i, (z, x, (sz, sx)) in enumerate(zip(zl, xl, shifts)):
                flush[i, :z, :x] = True
                placed[i, sz:sz + z, sx:sx + x] = True
            with torch.inference_mode(), exact_numerics():
                v = upload(vols, dev).float()
                ym = upload(ymask, dev)[:, None, :, None]
                chans = []
                for m in modes:
                    if m == 'max':
                        c = torch.where(ym, v, -torch.inf).amax(dim=2)
                    elif m == 'min':
                        c = torch.where(ym, v, torch.inf).amin(dim=2)
                    else:
                        c = (torch.where(ym, v, 0.0).sum(
                            dim=2, dtype=torch.float64)
                            / upload(yl.astype(np.float64), dev)[:, None, None]
                            ).float()
                    chans.append(c)
                x2d = torch.where(upload(flush, dev)[..., None],
                                  torch.stack(chans, dim=-1), 0.0)
                x2d = torch.stack([torch.roll(x2d[i], s, dims=(0, 1))
                                   for i, s in enumerate(shifts)])
                return self._pack(raw(x2d, upload(placed, dev)))

        return program, meta2d.get('compact')

    def predict_cohort_mixed(self, vols: Sequence[np.ndarray], spacing_yx,
                             modes: Sequence[str], mesh=None,
                             bucket: str = 'exact',
                             pad_quantum: int = 32) -> list:
        """Volumes of different shapes and spacings, in input order.

        ``bucket='exact'`` groups scans by (shape, spacing): each group is
        one :meth:`predict_cohort` program, and every scan's masks are its
        solo masks. ``bucket='pad'`` pads each scan into the bucket of its
        shape rounded up to a multiple of ``pad_quantum`` per axis, centred
        as the exact program places it, with masked projections and
        normalization statistics over its true extent: one program per
        bucket, whose masks differ from exact mode where the resample and
        tile grids see the padded extent. Masked-norm plans take 'exact'.

        :param spacing_yx: one (y, x) spacing for all scans, or one per scan
        :param mesh: data parallel over its 'data' (or first) axis, each
            exact group or padded bucket as :meth:`predict_cohort`
        :returns: list of per-scan merged masks (Z, X, sum L)
        """
        if bucket not in ('exact', 'pad'):
            raise ValueError(f"bucket must be 'exact' or 'pad'; got {bucket!r}")
        vols = list(vols)
        n = len(vols)
        sps = (list(spacing_yx) if not np.isscalar(spacing_yx[0])
               else [tuple(spacing_yx)] * n)
        if len(sps) != n:
            raise ValueError('spacing_yx must be one spacing or one per scan')
        if bucket == 'pad' and any(self.spec.preprocess.use_mask_for_norm):
            warn("bucket='pad' is not available for masked-norm plans "
                 "(exact hole-filled host masks); using exact buckets",
                 once=True)
            bucket = 'exact'
        modes = tuple(modes)
        out: list = [None] * n
        q = 1 if bucket == 'exact' else max(1, int(pad_quantum))
        groups: Dict[Tuple, list] = {}
        for i, (v, sp) in enumerate(zip(vols, sps)):
            key = (tuple(-(-d // q) * q for d in v.shape), spacing_key(sp))
            groups.setdefault(key, []).append(i)
        for (shape, sp), idxs in sorted(groups.items()):
            if bucket == 'exact':
                segs = self.predict_cohort(np.stack([vols[i] for i in idxs]),
                                           sp, modes, mesh=mesh)
                for i, seg in zip(idxs, segs):
                    out[i] = seg
                continue
            dtype = np.result_type(*[vols[i].dtype for i in idxs])
            batch = np.zeros((len(idxs),) + shape, dtype)
            exts = np.zeros((len(idxs), 3), np.int64)
            for j, i in enumerate(idxs):
                z, y, x = vols[i].shape
                batch[j, :z, :y, :x] = vols[i]
                exts[j] = vols[i].shape
            segs = self._predict_cohort_padded(batch, exts, sp, modes, mesh)
            for j, i in enumerate(idxs):
                z, _, x = vols[i].shape
                sz, sx = (shape[0] - z) // 2, (shape[2] - x) // 2
                out[i] = segs[j, sz:sz + z, sx:sx + x]
        return out

    def _predict_cohort_padded(self, vols: np.ndarray, exts: np.ndarray,
                               spacing_yx, modes: Tuple[str, ...],
                               mesh=None) -> np.ndarray:
        """One padded bucket (N, Zq, Yq, Xq) with its true extents, data
        parallel over ``mesh`` as :meth:`predict_cohort`."""
        from ..parallel.mesh import mesh_key
        return unpack_bits(self._over_data(
            mesh, self._cohort_padded_packed, [vols, exts], spacing_yx, modes,
            mesh_key(mesh)), self.total_labels)

    def _cohort_padded_packed(self, vols, exts, spacing_yx, modes, mkey
                              ) -> np.ndarray:
        """One padded bucket's batched program: its packed host masks."""
        fn, cmeta = self._cached(
            ('cohortpad', vols.shape, spacing_key(spacing_yx), modes, mkey),
            lambda: self._build_cohort_padded(vols.shape[0],
                                              tuple(vols.shape[1:]),
                                              tuple(spacing_yx), modes),
            lambda _: f'prepared padded cohort program for '
            f'batch={vols.shape[0]} bucket={vols.shape[1:]}')
        return DeviceResult(fn(vols, exts), cmeta).get()
