"""Stage timing and the device profiler hook.

:class:`StageTimer` records ordered wall-clock marks per task, like the
reference tool's per-task timestamps (start/get/.../done), and reports
their deltas. :func:`device_trace` records a ``torch.profiler`` trace of
what runs inside it (host ops, and the CUDA kernels when a card is used)
and writes it as a Chrome/Perfetto JSON trace into a directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

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

    def log(self) -> None:
        log(self.report())


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """``torch.profiler`` trace of the block, written to
    ``<log_dir>/ts2d-<pid>-<time>.pt.trace.json`` (open it in Perfetto or
    chrome://tracing); a no-op when ``log_dir`` is falsy. CUDA kernels are
    recorded when a card is available."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, f'ts2d-{os.getpid()}-{time.time_ns()}'
                                 f'.pt.trace.json')
    prof.export_chrome_trace(path)
    log(f'device trace written to {path}')
