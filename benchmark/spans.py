"""The port's own spans (``totalsegmentator2d_tpu_torch.utils.trace``) of
the traced run's profiled slice, for the per-layer metrics that read them.

The port records its spans while a profiler runs, so the slice's spans are
in the port's buffer after the run. The slice ends just after the last
``api.finish_predict`` it waited for, and its spans are those that opened
and closed inside it: a span still open when the profiler stops is
stretched by the profiler's own work at its end (one program's enqueue
read 6.4 s on an H100). Each metric is a sum over spans of one name, less the
time of some of their descendants, per scan: a span serves the scans it
carries (a scan the recorder did not see start is id 0), and at least one.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Iterable, List, Optional

# the profiler opens before the slice's marker: spans that opened between
# the two belong to the slice too
MARGIN_NS = 50_000_000


def of_slice(run) -> Optional[list]:
    """The port's spans that opened and closed in ``run``'s profiled slice;
    None without a slice, or from a port that records no spans."""
    if run.slice is None or not run.slice.scans:
        return None
    try:
        from totalsegmentator2d_tpu_torch.utils.trace import collect
    except ImportError:
        return None
    spans = collect()
    ends = [s.end_ns for s in spans if s.name == 'api.finish_predict']
    if not ends:
        return None
    end = max(ends)
    start = end - int(run.slice.window_s * 1e9) - MARGIN_NS
    return [s for s in spans if start <= s.start_ns and s.end_ns <= end]


def ms_per_scan(spans: Optional[List], name: str,
                less: Iterable[str] = ()) -> Optional[float]:
    """Milliseconds per scan of the spans called ``name``, each less its
    descendants called one of ``less``; None when there is no such span."""
    if not spans:
        return None
    mine = [s for s in spans if s.name == name]
    if not mine:
        return None
    less = set(less)
    children = defaultdict(list)
    for s in spans:
        if s.parent is not None:
            children[s.parent].append(s)

    def cut_ns(sid: int) -> int:
        total = 0
        for c in children.get(sid, ()):
            total += (c.end_ns - c.start_ns if c.name in less
                      else cut_ns(c.id))
        return total

    ns = sum(s.end_ns - s.start_ns - cut_ns(s.id) for s in mine)
    return ns / 1e6 / sum(max(1, len(s.scans)) for s in mine)
