"""The one traffic generator: a closed loop over a mix's volumes.

A mix file gives the entry (``predict``: one blocking ``TS2D.predict`` at a
time; ``async``: ``predict_async`` + ``finish_predict``), the scans kept in
flight, the volumes' shapes and spacing, and how many scans the traced run
profiles. Callers wait for each ``Result`` before they send the next scan.
The volumes are sent in cycles, each cycle every volume once in an order
drawn from the seed, and a window ends on a cycle's end, so every run of a
cell does the same work in another order.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Callable, List, Optional

import numpy as np

now = time.perf_counter


def _mark(name: str):
    from torch.profiler import record_function
    return record_function(name)


def _no_mark(name: str):
    return contextlib.nullcontext()


def order(n: int, seed: int):
    """Endless volume indices: cycles of 0..n-1, each shuffled by the seed."""
    rng = np.random.default_rng([int(seed), 1])
    while True:
        yield from (int(i) for i in rng.permutation(n))


class Sample:
    """One result of each volume, drawn uniformly from the seed among that
    volume's results (a reservoir of one), kept for the comparison."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng([int(seed), 2])
        self.seen: dict = {}
        self.kept: dict = {}

    def offer(self, volume: int, result) -> None:
        self.seen[volume] = self.seen.get(volume, 0) + 1
        if self.rng.random() * self.seen[volume] < 1.0:
            self.kept[volume] = result.get_segmentation().array


class ClosedLoop:
    """``in_flight`` callers sharing one thread, as ScanPipeline keeps its
    window: the oldest scan is finished before the next is sent."""

    def __init__(self, tool, images: list, seed: int, in_flight: int,
                 split: bool, on_result: Optional[Callable] = None,
                 annotate: bool = False):
        self.tool, self.images = tool, images
        self.order = order(len(images), seed)
        self.in_flight = int(in_flight)
        self.split = split          # predict_async + finish_predict
        self.on_result = on_result
        # name the calls into the program in a profiler's trace
        self.mark = _mark if annotate else _no_mark
        self.pending: deque = deque()
        self.submitted = 0
        self.failed = 0
        self.latency: List[float] = []
        self.volumes: List[int] = []   # the volume of each finished scan
        self.dispatch_s: List[float] = []
        self.errors: List[str] = []    # the first few failures, for stderr

    def _submit(self) -> None:
        v = next(self.order)
        self.submitted += 1
        t0 = now()
        try:
            if self.split:
                with self.mark('benchmark.predict_async'):
                    handle = self.tool.predict_async(self.images[v])
                self.dispatch_s.append(now() - t0)
            else:
                handle = ('done', self.tool.predict(self.images[v]))
        except Exception as ex:  # a failed scan counts, and the run goes on
            handle = ('failed', self._failed(ex))
        self.pending.append((v, t0, handle))

    def _failed(self, ex: Exception) -> Exception:
        if len(self.errors) < 3:
            self.errors.append(repr(ex))
        return ex

    def _finish(self) -> None:
        v, t0, handle = self.pending.popleft()
        result = None
        if handle[0] == 'done':
            result = handle[1]
        elif handle[0] != 'failed':
            try:
                with self.mark('benchmark.finish_predict'):
                    result = self.tool.finish_predict(handle)
            except Exception as ex:
                self._failed(ex)
        if result is None:
            self.failed += 1
            return
        self.latency.append(now() - t0)
        self.volumes.append(v)
        if self.on_result is not None:
            self.on_result(v, result)

    def _step(self, stop: Callable[[], bool]) -> bool:
        """Send scans while the window allows and fewer than ``in_flight``
        wait, then finish the oldest; False when none was left."""
        while len(self.pending) < self.in_flight and not stop():
            self._submit()
        if not self.pending:
            return False
        self._finish()
        return True

    def window(self, seconds: float, drain: bool = True) -> float:
        """Send scans until ``seconds`` have passed and a cycle has ended,
        and (with ``drain``) finish them all; returns the window's seconds,
        from its first send to its last finish."""
        t0 = now()
        deadline = t0 + seconds
        n = len(self.images)

        def stop():
            return now() >= deadline and self.submitted % n == 0

        while self._step(stop):
            if not drain and stop():
                break
        return now() - t0

    def finished(self) -> int:
        return len(self.volumes) + self.failed

    def finish_count(self, count: int) -> None:
        """Keep the loop going until ``count`` more scans have finished."""
        target = self.finished() + count
        while self.finished() < target:
            self._step(lambda: False)

    def drain(self) -> None:
        while self._step(lambda: True):
            pass
