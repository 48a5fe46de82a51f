"""Everything that crosses the link between the host and the card, both ways.

- the **int16 input wire**: exactly-integral channels (a CT's MIP, integer
  X-rays) upload as int16 and are cast back on the device, bit-identical
  (:func:`wire_detect`, :func:`_wire_pack`, :func:`_wire_restore`), through
  pinned memory (:func:`upload`);
- the **mask wire**: the programs bit-pack their decisions on the device
  (:func:`_pack_bits`, :func:`unpack_bits` on the host); the **compact
  mask wire** ships only their nonzero 8-byte tiles, a prefix plus an
  occupancy bitmap (:func:`_compact_pack`), and the host fetches the bitmap
  and only the prefix its count needs (:func:`fetch_compact`,
  :func:`fetch_compact_batch`), bit-identical to the plain wire;
- the **copies**: :func:`to_host` on a side stream after the program's
  :func:`ready_event`, :func:`fetch_split` in slabs;
- :class:`DeviceResult`, a launched program's masks fetched once: its
  ``get`` is the one fetch of every program of the fused engine, and the
  one ``engine.fetch`` span, which counts the bytes copied from the card
  (utils/trace.py :func:`count_bytes`).

It imports nothing from the rest of ``inference/``, which imports it.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import trace

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


def plain_wire(wire):
    """The wire as programs and queues key it: the all-float wire is the
    plain program's, None."""
    return None if wire is None or not any(wire) else wire


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


def _wire_restore(payload, wire, dtype=torch.float32) -> torch.Tensor:
    """Device-side inverse of :func:`_wire_pack`: cast, concat, and
    restore the original channel order (nothing to reorder when the int
    channels already lead, as the (MIP, AIP) = (int16, float32) CT case).
    Any leading axes pass through."""
    if wire is None or not any(wire):
        return payload.to(dtype)
    ii = [c for c, w in enumerate(wire) if w]
    ff = [c for c, w in enumerate(wire) if not w]
    parts = [payload[0].to(dtype)]
    if ff:
        parts.append(payload[1].to(dtype))
    cat = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
    perm = np.argsort(np.asarray(ii + ff))
    if np.array_equal(perm, np.arange(len(perm))):
        return cat
    return cat[..., torch.as_tensor(perm, device=cat.device)]


def upload(arr: Optional[np.ndarray], device: torch.device):
    """A host array (or a tuple of them) on the device. To a card it goes
    through pinned memory without blocking: a copy from pageable memory
    would wait for the work already queued on the stream."""
    if arr is None:
        return None
    if isinstance(arr, tuple):
        return tuple(upload(a, device) for a in arr)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != 'cuda':
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


# -- the copies to the host -------------------------------------------------


def ready_event(out):
    """A CUDA event recorded on the current stream after the work that
    makes ``out`` (a tensor or a tuple of them): the fetch waits on it and
    not on what is queued later. None for a result off the card."""
    t = out[0] if isinstance(out, tuple) else out
    if not isinstance(t, torch.Tensor) or t.device.type != 'cuda':
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev


_fetch_streams: Dict[Tuple[int, int], object] = {}
_fetch_streams_lock = threading.Lock()


def _fetch_stream(device: torch.device, i: int):
    key = (device.index if device.index is not None
           else torch.cuda.current_device(), i)
    with _fetch_streams_lock:
        s = _fetch_streams.get(key)
        if s is None:
            s = _fetch_streams[key] = torch.cuda.Stream(device=key[0])
        return s


def to_host(dev, ready=None, stream_index: int = 0) -> np.ndarray:
    """A device result on the host as a numpy array. A CUDA tensor is
    copied into pinned memory on a side stream (``stream_index`` picks one
    of several) that waits for ``ready`` (the event recorded after the
    program), or, without one, for the work queued so far on the current
    stream: the copy never queues behind programs launched after it."""
    if not isinstance(dev, torch.Tensor):
        return np.asarray(dev)
    if dev.device.type != 'cuda':
        return dev.numpy()
    stream = _fetch_stream(dev.device, stream_index)
    if ready is not None:
        stream.wait_event(ready)
    else:
        stream.wait_stream(torch.cuda.current_stream(dev.device))
    host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
    with torch.cuda.stream(stream):
        host.copy_(dev, non_blocking=True)
        dev.record_stream(stream)
    with trace.span('engine.device_wait'):
        stream.synchronize()
    return host.numpy()


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
    program (:func:`ready_event`). One stream by default: the reference's
    4 slabs aggregate a remote tunnel's streams, but a card on PCIe fills
    the link with one copy, and 4 slabs measured ~10x slower (PERF.md)."""
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


# -- the mask wire ----------------------------------------------------------


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a (..., L) 0/1 uint8 tensor into (..., ceil(L/8)) uint8, little
    bit order (numpy ``np.unpackbits(..., bitorder='little')``)."""
    L = bits.shape[-1]
    Lpad = -(-L // 8) * 8
    if Lpad != L:
        bits = F.pad(bits, (0, Lpad - L))
    grouped = bits.reshape(bits.shape[:-1] + (Lpad // 8, 8))
    # a host list copied to the card: the copy waits for the work queued
    # before it, so inside a program the host waits for the card here
    with trace.span('program.sync'):
        weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128],
                               dtype=torch.uint8, device=bits.device)
    return (grouped * weights).sum(dim=-1, dtype=torch.uint8)


def unpack_bits(packed: np.ndarray, n_labels: int) -> np.ndarray:
    """Host-side inverse of :func:`_pack_bits`."""
    packed = np.ascontiguousarray(packed)
    bits = np.unpackbits(packed.reshape(-1), bitorder='little')
    bits = bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,))
    return bits[..., :n_labels]


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


def _fetch_speculative(occ, spec_thunk, ready=None):
    """Fetch the occupancy bitmap, with an optional speculative prefix fetch
    running beside it. Returns ``(occ_np, speculative_result_or_None)``."""
    if spec_thunk is None:
        return to_host(occ, ready), None
    spec = _fetch_pool('spec', 2).submit(spec_thunk)
    occ_np = to_host(occ, ready)
    with trace.span('engine.device_wait'):
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
    fetched = occ_np.nbytes + (prefix.nbytes if prefix is not None else 0)
    count = occupied_count(occ_np, T)
    k = pick_prefix(count, T)
    if prefix is None or count > hint:
        prefix = fetch_split(buf[:k], ready=ready)
        fetched += prefix.nbytes
    cmeta['hint_solo'] = k
    trace.count_bytes(fetched)
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
    fetched = occ_np.nbytes + (slab.nbytes if slab is not None else 0)
    bits = np.unpackbits(np.ascontiguousarray(occ_np), axis=-1,
                         bitorder='little')[:, :T].astype(bool)
    counts = bits.sum(axis=-1)
    kmax = pick_prefix(int(counts.max()), T)
    if slab is None or int(counts.max()) > hint:
        slab = fetch_split(buf[:, :kmax], ready=ready)
        fetched += slab.nbytes
    cmeta['hint_batch'] = kmax
    trace.count_bytes(fetched)
    B = slab.shape[0]
    out = np.zeros((B, T), _TILE_WORD)
    out[bits] = _words(np.concatenate([slab[i, :counts[i]] for i in range(B)]))
    total = h * w * n_bytes
    planes = out.view(np.uint8)[:, :total].reshape(B, n_bytes, h, w)
    return np.ascontiguousarray(planes.transpose(0, 2, 3, 1))


# -- the one fetch ----------------------------------------------------------


class DeviceResult:
    """A launched program's device masks, fetched once: the first
    :meth:`get` (the batcher's watcher, or the caller's finish) downloads
    them; the rest read the cached host copy. Built right after the launch,
    on the launching thread: it records the event the copies wait for
    (:attr:`ready`) and the scan ids its ``engine.fetch`` span carries.

    With a ``compact`` layout (the default mask wire) the device value is
    a (buf, occupancy bitmap) pair and only the occupied prefix is fetched,
    by :func:`fetch_compact` for a solo buffer (rank 2) and
    :func:`fetch_compact_batch` for a batch. A plain result can download as
    a fixed number of contiguous slabs along axis 0 on concurrent copy
    streams (never per row: a solo output's axis 0 is the image height).
    The default is one stream: on the card's PCIe link 4 slabs measured
    ~10x slower than one copy (:func:`fetch_split`). :meth:`get` returns
    the plain packed (B, H, W, nB) / (H, W, nB) array either way."""

    # below this one copy is enough and the slab slices are not worth it
    _SPLIT_MIN_BYTES = 1_000_000
    _SPLIT_STREAMS = 1

    def __init__(self, dev, compact: Optional[dict] = None):
        self._dev = dev
        self._compact = compact
        self.ready = ready_event(dev)
        self._scans = trace.scans()
        self._np: Optional[np.ndarray] = None
        self._lock = threading.Lock()

    def get(self) -> np.ndarray:
        with self._lock:
            if self._np is None:
                # a result built while nothing recorded serves the scans
                # of the span it is fetched in
                span = trace.span('engine.fetch', scan=self._scans or None)
                with torch.inference_mode(), span:
                    self._np = self._fetch()
                self._dev = None
        return self._np

    def _fetch(self) -> np.ndarray:
        if self._compact is not None:
            fetch = (fetch_compact if self._dev[0].ndim == 2
                     else fetch_compact_batch)
            return fetch(self._dev, self._compact, self.ready)
        host = fetch_split(self._dev, min_bytes=self._SPLIT_MIN_BYTES,
                           streams=self._SPLIT_STREAMS, ready=self.ready)
        trace.count_bytes(host.nbytes)
        return host
