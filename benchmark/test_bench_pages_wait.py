"""The ``engine.pages_wait_ms`` reader on hand-made spans: ms a scan of
the finish's wait for its mapped pages, and None where the port records no
such span (a port without the pages thread, no slice, no spans)."""

import os
import time
from types import SimpleNamespace

import pytest

from benchmark import manifest
from totalsegmentator2d_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC = 'engine.pages_wait_ms'
MS = 1_000_000


def _run(window_s=1.0):
    return SimpleNamespace(slice=SimpleNamespace(window_s=window_s,
                                                 scans=[0, 1]))


def _record(waits):
    """Two scans' finishes by hand, each with the pages thread's job and,
    where ``waits`` says so, the finish's wait for it. Offsets in ms."""
    trace.enable()
    trace.disable()
    t0 = time.perf_counter_ns()
    ids = iter(range(1, 100))

    def add(name, start, end, parent=None, scans=(1,)):
        sid = next(ids)
        trace.RECORDER.add(sid, name, parent, scans, t0 + start * MS,
                           t0 + end * MS)
        return sid
    for scan, at in ((1, 0), (2, 400)):
        add('engine.pages', at + 5, at + 150, scans=(scan,))
        fin = add('api.finish_predict', at + 200, at + 300, scans=(scan,))
        add('engine.wait', at + 200, at + 210, fin, scans=(scan,))
        if waits:
            add('engine.pages_wait', at + 210, at + 210 + 12 * scan, fin,
                scans=(scan,))
        add('engine.unpack', at + 240, at + 280, fin, scans=(scan,))


@pytest.fixture(autouse=True)
def _empty_recorder():
    yield
    trace.enable()
    trace.disable()


def test_reads_ms_a_scan_of_the_wait():
    _record(waits=True)
    read = manifest.reader(ROOT, METRIC)
    assert read(_run()) == pytest.approx((12 + 24) / 2)
    # the wait is part of the finish's host time, which it moves
    assert manifest.reader(ROOT, 'api.finish_host_ms')(_run()) \
        == pytest.approx(90)


def test_none_without_the_span():
    _record(waits=False)     # a port that maps no pages ahead
    read = manifest.reader(ROOT, METRIC)
    assert read(_run()) is None
    assert read(SimpleNamespace(slice=None)) is None
    trace.enable()
    trace.disable()
    assert read(_run()) is None
