"""The traced run's device trace: a bounded slice of scans under
``torch.profiler``, reduced to kernel intervals, the device's busy time
(the union of kernel intervals) and the idle gaps between them, each gap
named by what the host was doing in its middle."""

from __future__ import annotations

import contextlib
from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, Tuple

from . import arith

MARK = 'benchmark.slice'
# device activities that are copies or fills, not kernel launches
NOT_KERNELS = ('Memcpy', 'Memset')


@dataclass
class Slice:
    """Times in seconds on the profiler's clock."""
    start: float
    end: float
    kernels: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]] = field(repr=False)
    scans: List[int] = field(default_factory=list)  # volumes finished in it

    @property
    def window_s(self) -> float:
        return self.end - self.start

    @property
    def busy_s(self) -> float:
        return arith.busy((s, e) for _, s, e in self.kernels)

    def launches(self) -> int:
        return sum(1 for n, _, _ in self.kernels if not n.startswith(NOT_KERNELS))

    def device_s(self, names) -> float:
        """Device seconds of the kernels whose name holds one of ``names``."""
        return sum(e - s for n, s, e in self.kernels
                   if any(k in n for k in names))

    def breakdown(self, top: int = 10) -> dict:
        by_name = defaultdict(float)
        for n, s, e in self.kernels:
            by_name[n[:160]] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(arith.gaps([(s, e) for _, s, e in self.kernels],
                                 self.start, self.end),
                      key=lambda g: g[0] - g[1])[:top]
        return {'device_ops': [[n, t] for n, t in ops],
                'idle_gaps': [[self.host_at((s + e) / 2), e - s]
                              for s, e in idle]}

    def host_at(self, t: float) -> str:
        """The innermost host operation running at ``t`` on any thread."""
        best = None
        for n, s, e in self.host:
            if s <= t < e and n != MARK and (best is None
                                              or e - s < best[2] - best[1]):
                best = (n, s, e)
        return best[0] if best else 'host outside any profiled op'


@contextlib.contextmanager
def profiled():
    """Profile the block; yields a list that receives the :class:`Slice`
    (without its scans) when the block ends."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    out: list = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(MARK):
            yield out
    kernels, host, mark = [], [], None
    for ev in prof.events():
        span = (ev.name, ev.time_range.start / 1e6, ev.time_range.end / 1e6)
        if ev.device_type == DeviceType.CUDA:
            kernels.append(span)
        elif ev.name == MARK:
            mark = span
        else:
            host.append(span)
    if mark is None:
        raise RuntimeError('the profiler recorded no slice marker')
    _, start, end = mark
    # the slice's share of each kernel: in-flight work runs past its ends
    kernels = [(n, max(s, start), min(e, end)) for n, s, e in kernels
               if e > start and s < end]
    out.append(Slice(start, end, kernels, host))
