"""AsyncRunner: host-side task-parallel serving.

The counterpart of the reference tool's ParallelPredictor, which spawns
worker processes and ships images through temporary files: here the card
is shared and a dispatch returns before the card is done, so a thread pool
feeding the resident engine is the construct. Threads overlap file IO and
preprocessing with device time; the stream orders device work.

As the reference: a start/submit/wait/stop lifecycle with non-blocking
submission, warmup tasks run before serving, dead workers fail their
queued tasks instead of hanging callers, and a graceful stop with poison
pills and a timeout.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
import traceback
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional

from ..utils.logging import warn
from ..utils.trace import StageTimer


class Task:
    def __init__(self, task_id: str, fn: Callable, args: tuple, kwargs: dict):
        self.id = task_id
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.future: Future = Future()
        self.timer = StageTimer(task_id)


class AsyncRunner:
    def __init__(self, num_workers: int = 1, name: str = 'ts2d'):
        self._num_workers = max(1, int(num_workers))
        self._name = name
        # holds Task objects and ('pill', generation) poison pills
        self._queue: 'queue.Queue[object]' = queue.Queue()
        self._threads: List[threading.Thread] = []
        self._tasks: Dict[str, Task] = {}
        # finished tasks drop their payloads at once (a long batch run must
        # not keep every result); only recent timers are kept
        self._recent_timers: 'collections.OrderedDict[str, dict]' = \
            collections.OrderedDict()
        # RLock: Future.cancel() in stop() runs the done-callback
        # synchronously while the lock is held
        self._lock = threading.RLock()
        self._stopping = threading.Event()
        self._counter = 0
        # worker generation: pills carry the generation they were issued
        # for, so pills a stop() left unconsumed cannot kill the workers of
        # the next start()
        self._gen = 0

    # -- lifecycle -----------------------------------------------------------

    def start(self, warmup: Optional[Callable] = None, wait: bool = False):
        """Start the workers; ``warmup`` runs once per worker before it
        serves tasks."""
        if self._threads:
            return self
        self._stopping.clear()
        self._gen += 1
        for i in range(self._num_workers):
            t = threading.Thread(target=self._worker,
                                 args=(i, warmup, self._gen),
                                 name=f'{self._name}-worker-{i}', daemon=True)
            t.start()
            self._threads.append(t)
        if wait and warmup is not None:
            self.submit(lambda: None).result()
        return self

    def _worker(self, idx: int, warmup: Optional[Callable], gen: int):
        try:
            if warmup is not None:
                warmup()
        except Exception:
            traceback.print_exc()
            warn(f'{self._name}-worker-{idx} failed during warmup')
            # keep serving: per-task errors surface on their futures
        while not self._stopping.is_set():
            if self._gen != gen:
                # a stop() timed out while this worker was in a task and a
                # new generation has started: exit instead of competing
                # with the new workers
                break
            try:
                task = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if isinstance(task, tuple):  # poison pill ('pill', gen)
                if task[1] >= gen:
                    break
                continue  # a stale pill of an earlier generation
            # RUNNING from here: cancel() now fails instead of succeeding on
            # a task in flight (set_result would then raise in the worker)
            if not task.future.set_running_or_notify_cancel():
                continue  # cancelled while queued
            task.timer.mark('get')
            try:
                result = task.fn(*task.args, **task.kwargs)
                task.timer.mark('done')
                task.future.set_result(result)
            except BaseException as ex:
                task.timer.mark('failed')
                task.future.set_exception(ex)

    def submit(self, fn: Callable, *args, task_id: Optional[str] = None,
               **kwargs) -> Future:
        if not self._threads:
            self.start()
        if not self.alive():
            raise RuntimeError(f'{self._name}: all workers are dead')
        with self._lock:
            self._counter += 1
            tid = task_id or f'task{self._counter}'
        task = Task(tid, fn, args, kwargs)
        with self._lock:
            self._tasks[tid] = task

        def _on_done(_fut, tid=tid, timer=task.timer):
            with self._lock:
                self._tasks.pop(tid, None)
                self._recent_timers[tid] = dict(timer.marks)
                while len(self._recent_timers) > 256:
                    self._recent_timers.popitem(last=False)

        task.future.add_done_callback(_on_done)
        self._queue.put(task)
        return task.future

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted task is done. Raises if the workers
        died with tasks pending."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                pending = [t for t in self._tasks.values()
                           if not t.future.done()]
            if not pending:
                return
            if not self.alive():
                for t in pending:
                    if not t.future.done():
                        t.future.set_exception(
                            RuntimeError('worker died with tasks pending'))
                raise RuntimeError(
                    f'{self._name}: all workers died with '
                    f'{len(pending)} tasks pending')
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f'{len(pending)} tasks still pending')
            time.sleep(0.01)

    def alive(self) -> bool:
        return any(t.is_alive() for t in self._threads)

    def stop(self, timeout: float = 10.0) -> None:
        """Graceful stop: poison pills, then the abort flag."""
        for _ in self._threads:
            self._queue.put(('pill', self._gen))
        for t in self._threads:
            t.join(timeout / max(len(self._threads), 1))
        self._stopping.set()
        still = [t for t in self._threads if t.is_alive()]
        if still:
            warn(f'{self._name}: {len(still)} workers did not stop in time')
        self._threads = []
        with self._lock:
            # a snapshot: cancel() runs _on_done synchronously, which pops
            # from _tasks
            for task in list(self._tasks.values()):
                if not task.future.done():
                    # queued tasks cancel; RUNNING ones finish in their
                    # worker and resolve normally
                    task.future.cancel()
            self._tasks.clear()

    def timestamps(self, task_id: str) -> Optional[Dict[str, float]]:
        with self._lock:
            task = self._tasks.get(task_id)
            if task is not None:
                return dict(task.timer.marks)
            return (dict(self._recent_timers[task_id])
                    if task_id in self._recent_timers else None)

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
