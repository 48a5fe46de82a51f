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

- the **int16 wire**: exactly-integral channels (a CT's MIP) upload as
  int16 and are cast back on the device, bit-identical
  (:func:`wire_detect`, :func:`_wire_pack`, ``program._wire_restore``);
- the **compact mask wire**: the program returns the packed masks'
  nonzero 8-byte tiles compacted to a prefix plus an occupancy bitmap
  (:func:`_compact_pack`); the host fetches the bitmap and only the prefix
  its count needs (:func:`fetch_compact`), bit-identical to the plain wire;
- **async dispatch** (:meth:`EnsembleEngine.predict_array_async` /
  :meth:`~EnsembleEngine.finish_array`) and **micro-batching**
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
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.convert import round_to_bf16
from ..models.plans import ModelSpec
from ..models.unet import UNet
from ..ops.normalize import nonzero_norm_mask
from ..ops.projection import project_array, project_arrays_np
from ..utils.device import exact_numerics
from ..utils.logging import log, warn
from .bucket import BucketProgram
from .program import ScanEngine, ready_event, to_host, upload


def pad_head(sd: Dict[str, torch.Tensor], n_labels: int,
             max_labels: int) -> Dict[str, torch.Tensor]:
    """Pad every segmentation head of a state dict from n_labels to
    max_labels outputs with zero weights and biases: the padded logits are
    exactly 0 and are sliced away before any decision."""
    if n_labels == max_labels:
        return sd
    extra = max_labels - n_labels
    out = dict(sd)
    for k, v in sd.items():
        if k.startswith('decoder.seg_layers.'):
            out[k] = torch.cat([v, v.new_zeros((extra,) + v.shape[1:])])
    return out


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a (..., L) 0/1 uint8 tensor into (..., ceil(L/8)) uint8, little
    bit order (numpy ``np.unpackbits(..., bitorder='little')``)."""
    L = bits.shape[-1]
    Lpad = -(-L // 8) * 8
    if Lpad != L:
        bits = F.pad(bits, (0, Lpad - L))
    grouped = bits.reshape(bits.shape[:-1] + (Lpad // 8, 8))
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8,
                           device=bits.device)
    return (grouped * weights).sum(dim=-1, dtype=torch.uint8)


def unpack_bits(packed: np.ndarray, n_labels: int) -> np.ndarray:
    """Host-side inverse of :func:`_pack_bits`."""
    packed = np.ascontiguousarray(packed)
    bits = np.unpackbits(packed.reshape(-1), bitorder='little')
    bits = bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,))
    return bits[..., :n_labels]


# -- compact mask wire: ship only the nonzero tiles of the packed masks ------
#
# Per-label foreground is a few percent of a projection on real anatomy, so
# most packed bytes are zero. The program cuts the packed bytes, plane by
# plane (a label byte-plane's support is spatially local, so its tiles go
# zero together), into tiles of _COMPACT_TILE bytes and moves the occupied
# ones to a dense prefix by cumsum positions (no sort, no host sync); the
# host fetches the occupancy bitmap, whose popcount sizes a bucketed prefix
# of the buffer, and only that prefix. The bucket the last result of the
# same program needed is fetched speculatively beside the bitmap.

_COMPACT_TILE = 8
# the host rebuild moves each 8-byte tile as one uint64: a 1-D boolean
# scatter of words is several times faster than one of 8-byte rows
_TILE_WORD = np.uint64


def _compact_meta(h: int, w: int, n_bytes: int) -> dict:
    total = h * w * n_bytes
    return {'shape': (h, w, n_bytes), 'T': -(-total // _COMPACT_TILE)}


def prefix_buckets(T: int) -> Tuple[int, ...]:
    """Fetchable prefix lengths (occupied-tile counts round up to one of
    these): fixed fractions of the tile count."""
    return tuple(sorted({max(1, -(-T // 16)), -(-T // 8), -(-T // 4),
                         -(-T // 2), T + 1}))


def pick_prefix(count: int, T: int) -> int:
    for b in prefix_buckets(T):
        if b >= count:
            return b
    return T + 1  # pragma: no cover - the last bucket always covers


def _compact_pack(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device side: (..., H, W, nB) bit-packed masks -> (buf, occ): ``buf``
    (..., T+1, _COMPACT_TILE) uint8 with the occupied plane-major tiles in
    a dense prefix and every other row zero, ``occ`` the packed tile
    occupancy bitmap (..., ceil(T/8)).

    An index scatter, then a row gather: every unoccupied tile scatters its
    index to the trash row T, so which one lands there depends on the order
    of a duplicate-index scatter (unspecified on a card), but every
    candidate is an all-zero tile (occupied means nonzero), so the trash
    row, and the whole buffer, are the same whatever the order."""
    lead = tuple(packed.shape[:-3])
    flat = packed.movedim(-1, -3).reshape(lead + (-1,))
    pad = (-flat.shape[-1]) % _COMPACT_TILE
    if pad:
        flat = F.pad(flat, (0, pad))
    tiles = flat.reshape(lead + (-1, _COMPACT_TILE))
    T = tiles.shape[-2]
    occ = (tiles != 0).any(dim=-1)
    pos = torch.cumsum(occ, dim=-1) - 1
    idx = torch.where(occ, pos, T)
    src = torch.full(lead + (T + 1,), T, dtype=torch.long,
                     device=packed.device)
    src.scatter_(-1, idx, torch.arange(T, device=packed.device)
                 .expand(lead + (T,)))
    tiles_p = torch.cat([tiles, tiles.new_zeros(lead + (1, _COMPACT_TILE))],
                        dim=-2)
    buf = torch.gather(tiles_p, -2,
                       src[..., None].expand(lead + (T + 1, _COMPACT_TILE)))
    return buf, _pack_bits(occ.to(torch.uint8))


def occupied_count(occ_packed: np.ndarray, T: int) -> int:
    """Occupied-tile count from the fetched bitmap (host side)."""
    bits = np.unpackbits(np.ascontiguousarray(occ_packed).reshape(-1),
                         bitorder='little')
    return int(bits[:T].sum())


def uncompact(prefix: np.ndarray, occ_packed: np.ndarray, count: int,
              shape: Tuple[int, int, int]) -> np.ndarray:
    """Host side: rebuild the (H, W, nB) packed-mask array from a fetched
    buffer prefix (length >= count) and the occupancy bitmap. Bit-identical
    to the plain wire."""
    h, w, n_bytes = shape
    total = h * w * n_bytes
    T = -(-total // _COMPACT_TILE)
    occ = np.unpackbits(np.ascontiguousarray(occ_packed).reshape(-1),
                        bitorder='little')[:T].astype(bool)
    out = np.zeros(T, _TILE_WORD)
    out[occ] = _words(prefix[:count])
    planes = out.view(np.uint8)[:total].reshape(n_bytes, h, w)
    return np.ascontiguousarray(planes.transpose(1, 2, 0))


def _words(tiles: np.ndarray) -> np.ndarray:
    """(n, _COMPACT_TILE) uint8 tiles as n tile words."""
    return np.ascontiguousarray(tiles).view(_TILE_WORD).reshape(-1)


_fetch_pools: Dict[str, object] = {}
_fetch_pool_lock = threading.Lock()


def _fetch_pool(kind: str, workers: int):
    """Shared thread pools for result downloads: the fetch paths run once
    per scan in the serving loop. 'slab' tasks never submit into a pool
    and 'spec' tasks only into 'slab', so they cannot deadlock."""
    with _fetch_pool_lock:
        pool = _fetch_pools.get(kind)
        if pool is None:
            from concurrent.futures import ThreadPoolExecutor
            pool = ThreadPoolExecutor(
                workers, thread_name_prefix=f'ts2d-fetch-{kind}')
            _fetch_pools[kind] = pool
        return pool


def fetch_split(dev, min_bytes: int = 1_000_000, streams: int = 1,
                ready=None) -> np.ndarray:
    """Fetch a device array as ``streams`` concurrent contiguous slabs
    along axis 0, each on its own copy stream; the concatenated slabs are
    bit-identical to the whole array. Arrays under ``min_bytes``, or with
    fewer than two rows, take one copy. ``ready``: the event after the
    program (:func:`~.program.ready_event`). One stream by default: the
    reference's 4 slabs aggregate a remote tunnel's streams, but a card on
    PCIe fills the link with one copy, and 4 slabs measured ~10x slower
    (PERF.md)."""
    n = dev.shape[0] if getattr(dev, 'ndim', 0) >= 1 else 0
    if n >= 2 and streams > 1 and dev.nbytes >= min_bytes:
        k = min(streams, n)
        bounds = [n * i // k for i in range(k + 1)]
        slabs = [(dev[bounds[i]:bounds[i + 1]], i) for i in range(k)]
        # 8 workers: two fetch_split calls can run at once (a speculative
        # prefix beside another program's result)
        parts = list(_fetch_pool('slab', 8).map(
            lambda s: to_host(s[0], ready, s[1]), slabs))
        return np.concatenate(parts)
    return to_host(dev, ready)


def _fetch_speculative(occ, spec_thunk, ready=None):
    """Fetch the occupancy bitmap, with an optional speculative prefix fetch
    running beside it. Returns ``(occ_np, speculative_result_or_None)``."""
    if spec_thunk is None:
        return to_host(occ, ready), None
    spec = _fetch_pool('spec', 2).submit(spec_thunk)
    occ_np = to_host(occ, ready)
    return occ_np, spec.result()


def fetch_compact(dev_pair, cmeta: dict, ready=None) -> np.ndarray:
    """Fetch a compacted solo result: the occupancy bitmap, plus only the
    bucketed prefix its count needs. The bucket the last solo result of
    this program needed (``cmeta['hint_solo']``; the batched fetch keeps
    its own ``hint_batch``) is fetched beside the bitmap; when it does not
    cover the new count, the covering bucket is fetched whole. Always
    bit-identical: :func:`uncompact` reads exactly ``prefix[:count]``."""
    buf, occ = dev_pair
    T = cmeta['T']
    hint = cmeta.get('hint_solo')
    occ_np, prefix = _fetch_speculative(
        occ, (lambda: fetch_split(buf[:hint], ready=ready)) if hint else None,
        ready)
    count = occupied_count(occ_np, T)
    k = pick_prefix(count, T)
    if prefix is None or count > hint:
        prefix = fetch_split(buf[:k], ready=ready)
    cmeta['hint_solo'] = k
    return uncompact(prefix, occ_np, count, cmeta['shape'])


def fetch_compact_batch(dev_pair, cmeta: dict, ready=None) -> np.ndarray:
    """Fetch a batch of compacted results ((B, T+1, tile) buffer, (B, occB)
    bitmaps): one prefix slab sized by the largest per-scan count, then one
    vectorized scatter per batch. Speculation as in :func:`fetch_compact`
    (own ``hint_batch`` slot). Returns the plain packed (B, H, W, nB)
    array, bit-identical to the plain wire."""
    buf, occ = dev_pair
    T = cmeta['T']
    h, w, n_bytes = cmeta['shape']
    hint = cmeta.get('hint_batch')
    occ_np, slab = _fetch_speculative(
        occ, (lambda: fetch_split(buf[:, :hint], ready=ready)) if hint
        else None, ready)
    bits = np.unpackbits(np.ascontiguousarray(occ_np), axis=-1,
                         bitorder='little')[:, :T].astype(bool)
    counts = bits.sum(axis=-1)
    kmax = pick_prefix(int(counts.max()), T)
    if slab is None or int(counts.max()) > hint:
        slab = fetch_split(buf[:, :kmax], ready=ready)
    cmeta['hint_batch'] = kmax
    B = slab.shape[0]
    out = np.zeros((B, T), _TILE_WORD)
    out[bits] = _words(np.concatenate([slab[i, :counts[i]] for i in range(B)]))
    total = h * w * n_bytes
    planes = out.view(np.uint8)[:, :total].reshape(B, n_bytes, h, w)
    return np.ascontiguousarray(planes.transpose(0, 2, 3, 1))


# -- int16 wire: exactly-integral channels upload at half width -------------
#
# CT MIP channels (and integer X-rays) hold exactly-integral float values,
# which an int16 carries losslessly at half the bytes; the device casts back
# to float before normalization, so results are bit-identical to the
# float32 wire. The AIP (mean) channel is fractional and stays float32.


def wire_detect(arr: np.ndarray) -> Tuple[bool, ...]:
    """Per-channel int16 eligibility of a float (H, W, C) array: every
    value integral and within int16 range. NaN/inf fail the equality and
    land on the float32 wire."""
    wire = []
    for c in range(arr.shape[-1]):
        ch = arr[..., c]
        wire.append(bool(ch.size and np.all(np.trunc(ch) == ch)
                         and ch.min() >= -32768 and ch.max() <= 32767))
    return tuple(wire)


def _wire_pack(arr: np.ndarray, wire) -> object:
    """Split (..., C) float32 into the wire payload: the int16 channels
    and the float32 channels as two arrays (int channels first). All-float
    wires return the array unchanged; all-int wires return a 1-tuple."""
    if wire is None or not any(wire):
        return np.ascontiguousarray(arr, np.float32)
    ii = [c for c, w in enumerate(wire) if w]
    ff = [c for c, w in enumerate(wire) if not w]
    xi = np.ascontiguousarray(arr[..., ii]).astype(np.int16)
    if not ff:
        return (xi,)
    return (xi, np.ascontiguousarray(arr[..., ff], np.float32))


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


class EnsembleEngine(ScanEngine):
    """Fused multi-group multi-fold inference.

    :param specs: per-group ModelSpecs; architectures must match except for
        the segmentation-head width, and preprocessing must be identical
    :param group_fold_params: state_dicts[group][fold] of the UNet module
    :param compute_dtype: ``None`` (exact) or ``torch.bfloat16`` (fast)
    :param device: ``None`` = the CUDA card (raises without one); pass
        ``'cpu'`` to run on the CPU
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
    """

    kind = 'ensemble'

    def __init__(self, specs: Sequence[ModelSpec],
                 group_fold_params: Sequence[Sequence[Dict[str, torch.Tensor]]],
                 tile_step_size: float = 0.5, use_mirroring: bool = True,
                 compute_dtype: Optional[torch.dtype] = None, device=None,
                 forward_batch_cap: int = 64,
                 auto_batch: Optional[int] = None,
                 compact_wire: Optional[bool] = None,
                 pad_quantum: Optional[int] = None, tile_mesh=None,
                 tile_axis: str = 'data'):
        if pad_quantum is not None and int(pad_quantum) < 1:
            raise ValueError('pad_quantum must be >= 1')
        if auto_batch is not None and tile_mesh is not None:
            # the batcher stacks scans into the batched program; the
            # tile-sharded program spreads one scan over the ranks: scale
            # throughput OR one scan's latency, not both
            raise ValueError('auto_batch cannot be combined with tile_mesh')
        if not specs:
            raise ValueError('At least one group is required')
        self._batcher = None  # before anything can raise: close() reads it
        super().__init__(specs[0], tile_step_size, use_mirroring,
                         compute_dtype, device, forward_batch_cap)
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
            from .batching import DynamicBatcher
            self._batcher = DynamicBatcher(self, max_batch=auto_batch)

    def close(self) -> None:
        """Stop the micro-batch dispatcher thread (if enabled) and release
        the exact-numerics hold."""
        if self._batcher is not None:
            self._batcher.stop()
            self._batcher = None
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
               force_norm_mask=False):
        program, meta = super()._build(in_shape, in_spacing, wire, batch,
                                       force_norm_mask)
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
        if wire is not None and not any(wire):
            wire = None
        key = ('bucket', tuple(bucket),
               tuple(round(float(s), 6) for s in in_spacing), wire)
        with self._cache_lock:
            hit = self._cache.get(key)
            if hit is None:
                hit = self._build_bucket(tuple(bucket), tuple(in_spacing),
                                         wire)
                self._cache[key] = hit
                log(f'prepared bucket serving program for bucket={key[1]} '
                    f'(q={self.pad_quantum}, <= {hit[1]["n_tiles_max"]} '
                    f'tiles' + (f', int16 wire {wire}' if wire else '') + ')')
        return hit

    def _program_padded(self, in_shape, in_spacing, wire=None):
        """The masked program: normalization statistics from an explicit
        valid-extent mask instead of the whole array, for the padded
        mixed-shape cohorts."""
        if wire is not None and not any(wire):
            wire = None
        key = ('2d-masked', tuple(in_shape),
               tuple(round(float(s), 6) for s in in_spacing), wire)
        with self._cache_lock:
            hit = self._cache.get(key)
            if hit is None:
                hit = self._build(tuple(in_shape), tuple(in_spacing), wire,
                                  force_norm_mask=True)
                self._cache[key] = hit
                log(f'prepared masked ensemble program for shape={key[1]}'
                    + (f', int16 wire {wire}' if wire else ''))
        return hit

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
        if wire is not None and not any(wire):
            wire = None
        key = ('batch', int(batch), tuple(in_shape),
               tuple(round(float(s), 6) for s in in_spacing), bool(has_mask),
               wire, self.pad_quantum is not None)
        with self._cache_lock:
            hit = self._cache.get(key)
            if hit is None:
                _, meta = self._serving_program(in_shape, in_spacing, wire)
                build = (self._build_bucket if self.pad_quantum is not None
                         else self._build)
                fn, _ = build(tuple(in_shape), tuple(in_spacing), wire,
                              batch=int(batch))
                hit = self._cache[key] = (fn, meta)
                log(f'prepared batched ensemble program for shape='
                    f'{tuple(in_shape)} batch={batch}'
                    + (' (bucket)' if self.pad_quantum is not None else ''))
        return hit

    # -- host API ------------------------------------------------------------

    def predict_array_async(self, arr: np.ndarray, spacing_yx: Sequence[float]):
        """Crop (nnU-Net crop_to_nonzero) and dispatch without waiting for
        the card; returns a handle for :meth:`finish_array`. With
        micro-batching the request joins the dispatcher's queue; without,
        the solo program is launched on this thread. Under pad_quantum the
        crop goes flush into its shape bucket with a valid-extent mask."""
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
        wire = wire_detect(cropped)
        if self._batcher is not None:
            return ('future',
                    self._batcher.submit(cropped, mask, spacing_yx, bbox,
                                         arr.shape[:2], wire))
        fn, meta = self._serving_program(cropped.shape[:2], spacing_yx, wire)
        out = fn(_wire_pack(cropped, wire), mask)
        return (out, bbox, arr.shape[:2], meta.get('compact'),
                ready_event(out))

    def finish_array(self, handle) -> np.ndarray:
        """Wait for a :meth:`predict_array_async` handle; returns the
        full-size merged multilabel one-hot uint8 segmentation."""
        if handle[0] == 'future':
            batch_result, idx, bbox, full = handle[1].result()
            packed = batch_result.get()
            if idx is not None:
                packed = packed[idx]
            return self._place(unpack_bits(packed, self.total_labels),
                               bbox, full)
        out, bbox, full, cmeta, ready = handle
        return self._place(self._fetch_masks(out, cmeta, ready), bbox, full)

    def _fetch_masks(self, out, cmeta, ready, batch=False) -> np.ndarray:
        """A program's device masks as unpacked host masks."""
        return unpack_bits(self._fetch_packed(out, cmeta, ready, batch),
                           self.total_labels)

    def _fetch_packed(self, out, cmeta, ready, batch=False) -> np.ndarray:
        """A program's device masks as packed host masks."""
        if cmeta is not None:
            return (fetch_compact_batch if batch else fetch_compact)(
                out, cmeta, ready)
        return to_host(out, ready)

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
        key = ('vol', cropped.shape,
               tuple(round(float(s), 6) for s in spacing_yx), modes)
        with self._cache_lock:
            hit = self._cache.get(key)
            if hit is None:
                hit = self._build_volume(tuple(cropped.shape),
                                         tuple(spacing_yx), modes)
                self._cache[key] = hit
                log(f'prepared volume program for shape={cropped.shape}')
        fn, cmeta = hit
        masks, proj = fn(cropped)
        return ('device', masks, proj, bbox, full_zx, cmeta,
                ready_event(proj))

    def finish_volume(self, handle) -> Tuple[np.ndarray, np.ndarray]:
        """Wait for a :meth:`predict_volume_async` handle; returns (merged
        masks (Z, X, sum L), projections (Z, X, C))."""
        if handle[0] == 'hostproj':
            _, inner, proj = handle
            return self.finish_array(inner), proj
        _, masks, proj_d, bbox, full_zx, cmeta, ready = handle
        seg_c = self._fetch_masks(masks, cmeta, ready)
        proj_c = to_host(proj_d, ready)
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
        key = ('cohort', vols.shape,
               tuple(round(float(s), 6) for s in spacing_yx), modes, mkey)
        with self._cache_lock:
            hit = self._cache.get(key)
            if hit is None:
                hit = self._build_cohort(vols.shape[0], tuple(vols.shape[1:]),
                                         tuple(spacing_yx), modes)
                self._cache[key] = hit
                log(f'prepared cohort program for batch={vols.shape[0]} '
                    f'shape={vols.shape[1:]}')
        fn, cmeta = hit
        out = fn(vols)
        return self._fetch_packed(out, cmeta, ready_event(out), batch=True)

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
            key = (tuple(-(-d // q) * q for d in v.shape),
                   tuple(round(float(s), 6) for s in sp))
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
        key = ('cohortpad', vols.shape,
               tuple(round(float(s), 6) for s in spacing_yx), modes, mkey)
        with self._cache_lock:
            hit = self._cache.get(key)
            if hit is None:
                hit = self._build_cohort_padded(vols.shape[0],
                                                tuple(vols.shape[1:]),
                                                tuple(spacing_yx), modes)
                self._cache[key] = hit
                log(f'prepared padded cohort program for '
                    f'batch={vols.shape[0]} bucket={vols.shape[1:]}')
        fn, cmeta = hit
        out = fn(vols, exts)
        return self._fetch_packed(out, cmeta, ready_event(out), batch=True)
