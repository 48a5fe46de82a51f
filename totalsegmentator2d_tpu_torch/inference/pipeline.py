"""ScanPipeline: the pipelined multi-case mode (CLI directory inputs).

The reference tool runs cases strictly one after another. Here the host
stages overlap the card: a reader thread reads the next cases ahead, the
main thread dispatches predictions without waiting (``TS2D.predict_async``)
and keeps up to ``in_flight`` scans queued, where the fused engine's
micro-batcher coalesces them into batched programs
(inference/batching.py), and save workers export results in the
background. Throughput then approaches max(device time, IO time) instead
of their sum.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Callable, Iterable, List, Optional, Tuple

from ..io import read_image
from ..utils.logging import log, warn
from ..utils.trace import StageTimer
from .runner import AsyncRunner


class ScanPipeline:
    """Drive ``tool.predict`` over many cases with read-ahead and async
    export.

    :param tool: a TS2D instance (or anything with ``predict(img,
        collapse=...)``, optionally ``predict_async`` / ``finish_predict``)
    :param prefetch: how many cases to read ahead
    :param save_workers: background export threads
    :param in_flight: dispatched, unfinished predictions to keep queued (8
        matches the engine's max_batch); 1 for tools without a truly
        asynchronous ``predict_async``
    """

    def __init__(self, tool, prefetch: int = 2, save_workers: int = 2,
                 in_flight: int = 8):
        self.tool = tool
        self.prefetch = max(1, int(prefetch))
        self.in_flight = max(1, int(in_flight))
        self._saver = AsyncRunner(num_workers=max(1, int(save_workers)),
                                  name='ts2d-save')

    def run(self, cases: Iterable[Tuple[str, str]], *,
            collapse: bool = False,
            on_result: Optional[Callable] = None,
            save_kwargs: Optional[dict] = None,
            progress: bool = True) -> List[StageTimer]:
        """Process (name, path) cases. With ``save_kwargs`` each result is
        exported in the background by ``Result.save(name=name,
        **save_kwargs)``; ``on_result(name, result)`` runs on this thread.
        Returns the per-case stage timers."""
        cases = list(cases)
        q: 'queue.Queue' = queue.Queue(maxsize=self.prefetch)
        timers: List[StageTimer] = []

        def reader():
            for name, path in cases:
                timer = StageTimer(name)
                try:
                    img = read_image(path)
                    timer.mark('read')
                    q.put((name, img, timer, None))
                except BaseException as ex:
                    q.put((name, None, timer, ex))
            q.put(None)

        t = threading.Thread(target=reader, daemon=True, name='ts2d-reader')
        t.start()
        self._saver.start()

        n = len(cases)
        done = 0
        save_futures = []
        # dispatched, unfinished predictions, finished in dispatch order
        pending: 'deque' = deque()
        has_async = hasattr(self.tool, 'predict_async')
        # a window helps only when predict_async really returns before the
        # card is done (TS2D.supports_async); queueing finished Results
        # would only hold their volumes and delay the exports
        truly_async = has_async and getattr(self.tool, 'supports_async', True)
        window = self.in_flight if truly_async else 1

        def finish_one():
            name, handle, timer = pending.popleft()
            try:
                res = (self.tool.finish_predict(handle) if has_async
                       else handle)
            except Exception as ex:
                # one bad case must not stop the run
                warn(f'Failed to predict case {name}: {ex}')
                timers.append(timer)
                return
            timer.mark('predict')
            if save_kwargs is not None:
                save_futures.append(
                    (name, self._saver.submit(
                        self._save, res, name, dict(save_kwargs),
                        timer, task_id=f'save-{name}')))
            if on_result is not None:
                on_result(name, res)
            timers.append(timer)

        try:
            while True:
                item = q.get()
                if item is None:
                    break
                name, img, timer, err = item
                done += 1
                if err is not None:
                    warn(f'Failed to read case {name}: {err}')
                    timers.append(timer)
                    continue
                if progress:
                    log(f'[{done}/{n}] Processing: {name}')
                try:
                    handle = (self.tool.predict_async(img, collapse=collapse)
                              if has_async
                              else self.tool.predict(img, collapse=collapse))
                except Exception as ex:
                    warn(f'Failed to predict case {name}: {ex}')
                    timers.append(timer)
                    continue
                timer.mark('dispatch')
                pending.append((name, handle, timer))
                # drain only past the window: '>=' would cap the in-flight
                # count at window-1 and the batcher could never fill
                while len(pending) > window:
                    finish_one()
            while pending:
                finish_one()
            self._saver.wait()
            for name, fut in save_futures:
                exc = fut.exception() if fut.done() else None
                if exc is not None:
                    warn(f'Failed to save case {name}: {exc}')
        finally:
            self._saver.stop()
        return timers

    @staticmethod
    def _save(res, name: str, save_kwargs: dict, timer: StageTimer) -> None:
        res.save(name=name, **save_kwargs)
        timer.mark('saved')
