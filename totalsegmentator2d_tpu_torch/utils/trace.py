"""Stage timing, the port's span recorder, and the device profiler hook.

:class:`StageTimer` records ordered wall-clock marks per task, like the
reference tool's per-task timestamps (start/get/.../done), and reports
their deltas.

:func:`span` marks one stage of a scan's path through the port, from
``TS2D.predict_async`` to its ``Result``: the host half, the batcher's
queue, the program's upload and enqueue, the watcher's fetch and the
finish (the names are listed in PERF.md). A span records its name, start
and end (``time.perf_counter_ns``), its parent span, its thread and the
scan ids it serves; a span opened without ``scan`` serves its parent's
scans, so every span of one scan carries that scan's id on the caller's,
the dispatcher's and the watcher's threads, and a batched program's spans
carry every id in the batch. A span may carry a count of bytes
(:func:`count_bytes`: the ``engine.fetch`` span counts the bytes its fetch
copied from the card). Spans are kept in a bounded in-memory buffer
while the recorder is enabled (:func:`enable` ... :func:`collect`,
:func:`disable`) and while a ``torch.profiler`` runs, and :func:`collect`
gives them on the profiler's unix clock as well. While a profiler runs each
span also opens a host range of the same name in the profiler's trace, so
a Perfetto trace shows the port's stages beside its kernels. With the
recorder off and no profiler running, :func:`span` returns one shared
no-op context manager.

:func:`device_trace` records a ``torch.profiler`` trace of what runs
inside it (host ops, the port's spans, and the CUDA kernels when a card is
used) and writes it as a Chrome/Perfetto JSON trace into a directory.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

from .logging import log


class StageTimer:
    """Ordered wall-clock stage marks with deltas."""

    def __init__(self, name: str = 'task'):
        self.name = name
        self.marks: Dict[str, float] = {}
        self.mark('start')

    def mark(self, stage: str) -> None:
        self.marks[stage] = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str):
        try:
            yield
        finally:
            self.mark(name)

    def deltas(self) -> Dict[str, float]:
        items = list(self.marks.items())
        return {b[0]: b[1] - a[1] for a, b in zip(items, items[1:])}

    def total(self) -> float:
        vals = list(self.marks.values())
        return vals[-1] - vals[0] if len(vals) > 1 else 0.0

    def report(self) -> str:
        parts = [f'{k}: {v * 1000:.1f}ms' for k, v in self.deltas().items()]
        return f'[{self.name}] ' + ', '.join(parts) + \
            f' | total {self.total() * 1000:.1f}ms'


# -- the span recorder --------------------------------------------------------

# spans kept: ~20 a scan, so the last few thousand scans of a long-running
# server with tracing on
CAPACITY = 100_000

# ``span(name, scan=NEW)``: the span takes a new scan id (a scan's root)
NEW = object()

def _profiling() -> bool:
    """Whether a torch.profiler runs in this process: the flag its start
    sets. (``torch.autograd._profiler_enabled()`` is per thread: False on
    the batcher's threads while the caller's thread is profiled, and on
    every thread under ``profile_all_threads``.)"""
    return _profiler._is_profiler_enabled


# a host range that the profiler records as a CPU op: ``record_function``'s
# user ranges are also mirrored onto the card's timeline, as device events
# of the same name around the kernels launched inside them, which a trace's
# kernel count and busy time would read as kernels
_Twin = torch._C._profiler._RecordFunctionFast


class Span(NamedTuple):
    """A closed span. Times in ns: ``start_ns`` / ``end_ns`` on
    ``time.perf_counter_ns``, ``unix_start_ns`` / ``unix_end_ns`` the same
    instants on the unix clock that ``torch.profiler``'s trace uses."""
    id: int
    name: str
    parent: Optional[int]
    thread: int
    thread_name: str
    scans: Tuple[int, ...]
    start_ns: int
    end_ns: int
    unix_start_ns: int
    unix_end_ns: int
    nbytes: int = 0   # the bytes counted into it (:func:`count_bytes`)


class Recorder:
    """The span buffer and the recording switch (one per process: the
    module's functions use :data:`RECORDER`)."""

    def __init__(self, capacity: int = CAPACITY):
        self.on = False
        self._spans: deque = deque(maxlen=capacity)
        self._span_ids = itertools.count(1)
        self._scan_ids = itertools.count(1)
        self._local = threading.local()
        self._clock = _clock_pair()

    def stack(self) -> list:
        """This thread's open spans, innermost last."""
        stack = getattr(self._local, 'stack', None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def add(self, span_id: int, name: str, parent: Optional[int],
            scans: tuple, start_ns: int, end_ns: int,
            nbytes: int = 0) -> None:
        t = threading.current_thread()
        # deque.append is atomic: threads need no lock here
        self._spans.append((span_id, name, parent, t.ident, t.name, scans,
                            start_ns, end_ns, nbytes))

    def new_span(self) -> int:
        return next(self._span_ids)

    def new_scan(self) -> int:
        return next(self._scan_ids)

    def enable(self) -> None:
        self._spans.clear()
        self._clock = _clock_pair()
        self.on = True

    def collect(self) -> List[Span]:
        perf_ns, unix_ns = self._clock
        shift = unix_ns - perf_ns
        return [Span(*s[:8], s[6] + shift, s[7] + shift, s[8])
                for s in list(self._spans)]


def _clock_pair() -> Tuple[int, int]:
    """One (perf_counter_ns, time_ns) pair read back to back."""
    return time.perf_counter_ns(), time.time_ns()


_NOOP = contextlib.nullcontext()


class _Span:
    __slots__ = ('name', 'scans', 'id', 'parent', 'start', 'twin', 'nbytes')

    def __init__(self, name: str, scan):
        self.name = name
        self.scans = scan

    def __enter__(self):
        stack = RECORDER.stack()
        parent = stack[-1] if stack else None
        if self.scans is NEW:
            self.scans = (RECORDER.new_scan(),)
        elif self.scans is None:
            self.scans = parent.scans if parent is not None else ()
        else:
            self.scans = tuple(self.scans)
        self.id = RECORDER.new_span()
        self.parent = parent.id if parent is not None else None
        self.twin = None
        self.nbytes = 0
        if _profiling():
            self.twin = _Twin(self.name)
            self.twin.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        RECORDER.stack().pop()
        if self.twin is not None:
            self.twin.__exit__(None, None, None)
        RECORDER.add(self.id, self.name, self.parent, self.scans, self.start,
                     end, self.nbytes)
        return False


RECORDER = Recorder()


def recording() -> bool:
    """True while spans are kept: the recorder is enabled or a profiler
    runs."""
    return RECORDER.on or _profiling()


def span(name: str, scan=None):
    """A context manager that records one stage. ``scan``: the tuple of
    scan ids the stage serves (:data:`NEW` takes a new id; None: the
    enclosing span's). Costs one flag check when nothing records."""
    if not (RECORDER.on or _profiler._is_profiler_enabled):
        return _NOOP
    return _Span(name, scan)


def scans() -> Tuple[int, ...]:
    """The scan ids of this thread's innermost open span; () when none."""
    stack = RECORDER.stack() if recording() else ()
    return stack[-1].scans if stack else ()


def count_bytes(n: int) -> None:
    """Add ``n`` bytes to this thread's innermost open span; nothing when
    nothing records or no span is open."""
    if not (RECORDER.on or _profiler._is_profiler_enabled):
        return
    stack = RECORDER.stack()
    if stack:
        stack[-1].nbytes += int(n)


def stamp() -> Optional[Tuple[Tuple[int, ...], int]]:
    """While recording, (the current scans, now): the start of a span that
    another thread closes with :func:`record`; else None."""
    if not recording():
        return None
    return scans(), time.perf_counter_ns()


def record(name: str, stamped) -> None:
    """Close a span opened by :func:`stamp` (on any thread) at now. It has
    no parent and no profiler range: a profiler's range opens and closes on
    one thread."""
    if stamped is not None:
        got, start = stamped
        RECORDER.add(RECORDER.new_span(), name, None, got, start,
                     time.perf_counter_ns())


def enable() -> None:
    """Start recording into an emptied buffer."""
    RECORDER.enable()


def disable() -> None:
    RECORDER.on = False


def collect() -> List[Span]:
    """A snapshot of the recorded spans, in the order they closed. A span's
    ``parent`` is its parent's ``id``."""
    return RECORDER.collect()


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """``torch.profiler`` trace of the block, written to
    ``<log_dir>/ts2d-<pid>-<time>.pt.trace.json`` (open it in Perfetto or
    chrome://tracing); a no-op when ``log_dir`` is falsy. It holds the host
    ops and the port's spans of every thread (the caller's, the batcher's
    dispatcher and watchers, the pipeline's), and the CUDA kernels when a
    card is available."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    every_thread = torch._C._profiler._ExperimentalConfig(
        profile_all_threads=True)
    with profile(activities=activities,
                 experimental_config=every_thread) as prof:
        yield
    path = os.path.join(log_dir, f'ts2d-{os.getpid()}-{time.time_ns()}'
                                 f'.pt.trace.json')
    prof.export_chrome_trace(path)
    log(f'device trace written to {path}')
