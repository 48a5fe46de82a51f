"""Dynamic micro-batching for the fused ensemble engine.

Requests that arrive while the card is busy are stacked into ONE batched
program (the solo program with a leading scan axis, inference/program.py):
8 scans share one set of kernel launches and each U-Net call sees 8 times
the images, so the host's per-launch work and the small-batch kernels
amortize over the batch. This replaces the reference tool's host process
pool (one resident predictor process per model fed round-robin) as the
concurrency mechanism on one card.

Batching policy, the reference package's: requests group by (cropped
shape, spacing, masked-norm, input wire); whatever is queued when the
dispatcher frees goes out as one batch. A batch is padded to ``max_batch``
(repeating the last scan; the padding rows are sliced off on the device
before the download), so each input shape has two programs, the solo and
the max_batch one. A device busy -> accumulate / idle -> dispatch rule,
a burst ramp, ``min_fill``, ``linger_ms`` and a reorder for a full batch
of another key decide when a batch goes (see :class:`DynamicBatcher`).

Threads: the dispatcher launches the programs, one watcher per program
pre-fetches its result to the host; both run under
``torch.inference_mode`` (grad mode is per thread) and launch on the
default stream, and the download waits on the event recorded right after
its program, not on the programs launched after it.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils.logging import log, warn


class _BatchResult:
    """Fetch-once holder for a dispatched program's device output: the
    first consumer (the watcher, normally) downloads it; the rest read the
    cached host copy.

    A large plain result can download as a fixed number of contiguous
    slabs along axis 0 on concurrent copy streams (never per row: a solo
    output's axis 0 is the image height); their concatenation is
    bit-identical to the whole array. The default is one stream: on the
    card's PCIe link 4 slabs measured ~10x slower than one copy
    (ensemble_engine.fetch_split). With a ``compact`` layout (the
    default mask wire) the device value is a (buf, occupancy bitmap) pair
    and only the occupied prefix is fetched (ensemble_engine.fetch_compact).
    ``get`` returns the plain packed (B, H, W, nB) / (H, W, nB) array
    either way. ``ready`` is the CUDA event recorded after the program.
    """

    # below this one copy is enough and the slab slices are not worth it
    _SPLIT_MIN_BYTES = 1_000_000
    _SPLIT_STREAMS = 1

    def __init__(self, dev, compact: Optional[dict] = None, ready=None):
        self._dev = dev
        self._compact = compact
        self._ready = ready
        self._np: Optional[np.ndarray] = None
        self._lock = threading.Lock()

    def get(self) -> np.ndarray:
        with self._lock:
            if self._np is None:
                with torch.inference_mode():
                    if self._compact is not None:
                        self._np = self._fetch_compacted()
                    else:
                        self._np = self._fetch_split(self._dev)
                self._dev = None
        return self._np

    def _fetch_split(self, dev) -> np.ndarray:
        from .ensemble_engine import fetch_split
        return fetch_split(dev, min_bytes=self._SPLIT_MIN_BYTES,
                           streams=self._SPLIT_STREAMS, ready=self._ready)

    def _fetch_compacted(self) -> np.ndarray:
        from .ensemble_engine import fetch_compact, fetch_compact_batch
        buf, _ = self._dev
        if buf.ndim == 2:  # a solo program's output
            return fetch_compact(self._dev, self._compact, self._ready)
        return fetch_compact_batch(self._dev, self._compact, self._ready)


class DynamicBatcher:
    """Coalesces concurrent ``predict_array_async`` requests into batched
    programs. One daemon dispatcher thread; submissions return futures
    resolving to ``(_BatchResult, index | None, bbox, full_shape)``.

    The engine gives ``_serving_program(shape, spacing, wire)`` and
    ``_batched_program(max_batch, shape, spacing, has_mask, wire)``, each
    -> (program, meta); a program takes the host payload (and mask) and
    returns its device result without waiting for the card.
    """

    def __init__(self, engine, max_batch: int = 8, linger_ms: float = 0.0,
                 accumulate_gap_ms: float = 50.0, min_fill: int = 4):
        if max_batch < 1:
            raise ValueError('max_batch must be >= 1')
        self.engine = engine
        self.max_batch = int(max_batch)
        # throughput knob: when > 0 the dispatcher holds a partial batch up
        # to this long waiting for it to fill (a partial batch pads to
        # max_batch and costs a full program). Mutable at runtime. When 0
        # the arrival-aware policy below applies instead.
        self.linger_ms = float(linger_ms)
        # arrival-aware coalescing: a dispatch returns as soon as its
        # kernels are queued, so a dispatcher that pops eagerly outruns any
        # arrival rate and every request would ride a solo program. Device
        # idle -> dispatch at once (solo latency unchanged); device busy ->
        # accumulate while submissions keep streaming in, dispatch when the
        # head batch fills or arrivals pause for accumulate_gap_ms. Program
        # completion (the watcher's fetch) is only the idle signal, never a
        # dispatch gate.
        self.accumulate_gap_ms = float(accumulate_gap_ms)
        # a padded partial batch costs the whole max_batch program however
        # few scans ride it; below this occupancy queued scans go out as
        # solos. Clamped to max_batch, or a small max_batch could never
        # coalesce.
        self.min_fill = max(1, min(int(min_fill), self.max_batch))
        # burst ramp: when the device comes off idle, the first dispatches
        # go out as solos even if a batch could form, so the first results
        # come at solo latency; a full queued batch cancels it
        self.ramp_solos = 3
        self._ramp_left = 0
        self._inflight = 0
        self._last_submit = 0.0
        # occupancy for /metrics: occupancy[i] programs carried i+1 scans
        self._occupancy = [0] * self.max_batch
        # FIFO of (key, t_enqueued, item); item = (cropped, mask, bbox,
        # full, future)
        self._pending: List[Tuple[tuple, float, tuple]] = []
        self._cv = threading.Condition()
        self._stopped = False
        # elasticity: a dispatcher that died of an internal error (its
        # waiters already got the exception) restarts on the next submit,
        # up to this many consecutive failures; a healthy dispatch resets
        # the count
        self.max_restarts = 3
        self._crashes = 0          # consecutive (reset by a healthy dispatch)
        self._crashes_total = 0    # lifetime, for /metrics
        self._user_stopped = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name='ts2d-batcher')
        self._thread.start()

    def submit(self, cropped: np.ndarray, mask: Optional[np.ndarray],
               spacing, bbox, full, wire=None) -> Future:
        if wire is not None and not any(wire):
            wire = None
        key = (cropped.shape[:2],
               tuple(round(float(s), 6) for s in spacing),
               mask is not None,
               # scans on different int16 wires run different programs and
               # must not co-batch
               wire)
        fut: Future = Future()
        item = (cropped, mask, bbox, full, fut)
        with self._cv:
            if self._user_stopped:
                raise RuntimeError('batcher is stopped')
            if self._stopped or not self._thread.is_alive():
                # the dispatcher died of an internal error (its waiters got
                # it); restart it, unless it is crash-looping
                if self._crashes >= self.max_restarts:
                    raise RuntimeError(
                        f'batcher dispatcher died {self._crashes} '
                        f'consecutive times; giving up (see prior errors)')
                warn(f'batcher dispatcher died; restarting '
                     f'({self._crashes}/{self.max_restarts} consecutive '
                     f'failures)')
                self._stopped = False
                # _inflight is NOT reset: watchers of the crashed
                # incarnation still hold +1 each and decrement when their
                # fetches finish
                self._ramp_left = 0
                self._thread = threading.Thread(target=self._run, daemon=True,
                                                name='ts2d-batcher')
                self._thread.start()
            self._pending.append((key, time.monotonic(), item))
            self._last_submit = time.monotonic()
            self._cv.notify()
        return fut

    def stats(self) -> dict:
        """Dispatch occupancy: ``batch_occupancy[i]`` programs carried
        ``i+1`` real scans, and the totals derived from it."""
        with self._cv:
            occ = list(self._occupancy)
            crashes = self._crashes_total
        programs = sum(occ)
        scans = sum((i + 1) * c for i, c in enumerate(occ))
        return {
            'batch_occupancy': occ,
            'batch_programs': programs,
            'batch_scans': scans,
            'batch_scans_coalesced': scans - occ[0] if occ else 0,
            'batch_mean_occupancy': (scans / programs) if programs else 0.0,
            'batch_dispatcher_crashes': crashes,
        }

    def stop(self, timeout: float = 10.0) -> bool:
        """Let the dispatcher drain its queue and wait for it to exit.
        Returns False when the join timed out (the daemon thread is then
        still finishing a dispatch)."""
        with self._cv:
            self._stopped = True
            self._user_stopped = True
            self._cv.notify()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            warn(f'batcher dispatcher still running after the {timeout:.0f}s '
                 f'stop timeout; it exits after the dispatch in flight')
            return False
        return True

    # -- dispatcher ----------------------------------------------------------

    def _take_batch(self, cap: Optional[int] = None):
        """Pop the oldest request plus every queued request with its key, up
        to ``cap`` (default max_batch). Caller holds _cv."""
        key = self._pending[0][0]
        cap = self.max_batch if cap is None else cap
        take, rest = [], []
        for entry in self._pending:
            if entry[0] == key and len(take) < cap:
                take.append(entry[2])
            else:
                rest.append(entry)
        self._pending = rest
        return key, take

    def _full_key(self):
        """The first request key with a full batch pending, else None: the
        one fullness rule of every policy. Caller holds the lock."""
        counts: dict = {}
        for k, _, _ in self._pending:
            counts[k] = counts.get(k, 0) + 1
            if counts[k] >= self.max_batch:
                return k
        return None

    def _run(self):
        try:
            with torch.inference_mode():
                self._loop()
        except BaseException as ex:  # the dispatcher is dying: fail waiters
            with self._cv:
                # stopped FIRST, so a concurrent submit cannot slip an item
                # in after the drain
                self._stopped = True
                self._crashes += 1
                self._crashes_total += 1
                pending, self._pending = self._pending, []
            for _, _, (*_, fut) in pending:
                if not fut.done():
                    fut.set_exception(
                        RuntimeError(f'batcher dispatcher died: {ex!r}'))
            raise

    def _loop(self):
        while True:
            with self._cv:
                while not self._pending and not self._stopped:
                    self._cv.wait()
                if not self._pending:
                    return  # stopped and drained
                linger = self.linger_ms / 1e3
                if linger > 0 and not self._stopped:
                    # wait for the OLDEST request's batch to fill, up to a
                    # deadline anchored at its enqueue time (re-arming it
                    # per round would let majority-shape traffic postpone a
                    # minority request forever). A full batch of another
                    # key may go first; past the deadline the oldest goes
                    # out partial.
                    key0, t0, _ = self._pending[0]
                    deadline = t0 + linger

                    def _mine():
                        return sum(1 for k, _, _ in self._pending
                                   if k == key0)

                    while (_mine() < self.max_batch
                           and self._full_key() is None
                           and not self._stopped):
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cv.wait(timeout=remaining)
                    full = self._full_key()
                    if (full is not None and full != key0
                            and time.monotonic() < deadline):
                        # a ready-full batch of another key goes first; key0
                        # keeps its deadline for the next round
                        self._pending.sort(key=lambda e: e[0] != full)
                take_cap = None
                if linger <= 0 and not self._stopped:
                    if self._ramp_left <= 0 and self._inflight == 0:
                        # the device went idle: a fresh burst begins
                        self._ramp_left = self.ramp_solos
                    if self._ramp_left > 0 and self._full_key() is not None:
                        # a full batch is already queued: the caller submits
                        # faster than solos retire; ride the batch
                        self._ramp_left = 0
                    if self._ramp_left > 0:
                        self._ramp_left -= 1
                        take_cap = 1
                    else:
                        # device busy: hold the queue while submissions keep
                        # streaming in; dispatch on a full head batch or an
                        # arrival pause
                        gap = self.accumulate_gap_ms / 1e3
                        cnt = 0
                        while not self._stopped and self._pending:
                            head = self._pending[0][0]
                            cnt = sum(1 for k, _, _ in self._pending
                                      if k == head)
                            if (cnt >= self.max_batch
                                    or self._inflight == 0
                                    or self._full_key() is not None):
                                break
                            since = time.monotonic() - self._last_submit
                            if since >= gap:
                                break
                            self._cv.wait(timeout=gap - since + 1e-3)
                        if not self._pending:
                            continue
                        full = self._full_key()
                        if full is not None and full != self._pending[0][0]:
                            # a ready-full batch of another key must not wait
                            # behind a minority-shape head; the stable sort
                            # keeps FIFO within each key
                            self._pending.sort(key=lambda e: e[0] != full)
                            cnt = self.max_batch
                        if cnt < self.min_fill:
                            # a padded partial batch costs the full program;
                            # this few scans run cheaper as solos
                            take_cap = 1
                key, take = self._take_batch(take_cap)
            try:
                self._dispatch(key, take)
                with self._cv:
                    self._crashes = 0  # a healthy dispatch resets the count
            except BaseException as ex:  # every waiting caller gets it
                for *_, fut in take:
                    if not fut.done():
                        fut.set_exception(ex)
                if not isinstance(ex, Exception):
                    raise  # KeyboardInterrupt / SystemExit: die loudly

    def _track(self, br: _BatchResult) -> None:
        """Count a dispatched program as in flight and pre-fetch its result
        from a watcher thread; the fetch's end is the idle signal, and by
        the time a consumer reads the result it is already on the host."""
        with self._cv:
            self._inflight += 1

        def watch():
            try:
                br.get()
            except BaseException:
                pass  # the consumer's own read raises it
            finally:
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify()

        threading.Thread(target=watch, daemon=True,
                         name='ts2d-batch-watch').start()

    def _dispatch(self, key, take):
        from .ensemble_engine import _wire_pack
        from .program import ready_event
        engine = self.engine
        _, spacing, has_mask, wire = key
        # claim every future first: a caller that cancelled (a timed-out
        # request) gets no result and does not fail its batch mates
        take = [it for it in take if it[-1].set_running_or_notify_cancel()]
        if not take:
            return
        B = len(take)
        if B == 1:
            # the solo program: no batched program for the sequential case
            cropped, mask, bbox, full, fut = take[0]
            fn, meta = engine._serving_program(cropped.shape[:2], spacing,
                                               wire)
            out = fn(_wire_pack(cropped, wire), mask)
            br = _BatchResult(out, compact=meta.get('compact'),
                              ready=ready_event(out))
            self._track(br)
            with self._cv:
                self._occupancy[0] += 1
            fut.set_result((br, None, bbox, full))
            return
        log(f'micro-batching engaged ({B} concurrent scans coalesced into '
            f'one device program); results may differ from solo runs on '
            f'borderline pixels - use batching=False / --no-batching for '
            f'bitwise reproducibility', once=True)
        fnb, meta = engine._batched_program(
            self.max_batch, take[0][0].shape[:2], spacing, has_mask, wire)
        compact = meta.get('compact')
        pad = self.max_batch - B
        stacked = np.stack([it[0] for it in take] + [take[-1][0]] * pad)
        mb = (np.stack([it[1] for it in take] + [take[-1][1]] * pad)
              if has_mask else None)
        out = fnb(_wire_pack(stacked, wire), mb)
        if B < self.max_batch:
            # drop the padding rows on the device: they are never fetched
            out = (tuple(o[:B] for o in out) if compact is not None
                   else out[:B])
        br = _BatchResult(out, compact=compact, ready=ready_event(out))
        self._track(br)
        with self._cv:
            self._occupancy[B - 1] += 1
        for i, (_, _, bbox, full, fut) in enumerate(take):
            fut.set_result((br, i, bbox, full))
