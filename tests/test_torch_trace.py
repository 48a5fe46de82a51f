"""The port's span recorder (utils/trace.py) on the CPU: the span tree of one
traced scan from ``TS2D.predict_async`` to its ``Result`` with batching on
and off, the ids a coalesced batch carries, the batcher's solo counts, the
off path, the profiler twins and their clock, the bounded buffer,
concurrent recording and the byte count a span carries, on the small
fixture set of tests/model_fixtures.py."""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tests.model_fixtures import build_group_set
from totalsegmentator2d_tpu_torch.api import TS2D
from totalsegmentator2d_tpu_torch.inference import (DynamicBatcher,
                                                    EnsembleEngine,
                                                    ensemble_engine)
from totalsegmentator2d_tpu_torch.io import MedicalImage, native
from totalsegmentator2d_tpu_torch.utils import trace

KEY = 'ts2d-v9-test'
STAGES = ('program.normalize', 'program.resample', 'program.tiles',
          'program.merge', 'program.upsample', 'program.decide',
          'program.pack')
# each span's parent; a tuple where either may hold it (None: a root)
PROGRAM = dict({s: 'program.enqueue' for s in STAGES},
               **{'program.sync': ('program.decide', 'program.pack')})
TREE = {
    True: dict(PROGRAM, **{
        'api.predict_async': None, 'api.project': 'api.predict_async',
        'api.reorient': 'api.project', 'engine.crop': 'api.predict_async',
        'engine.wire': 'api.predict_async', 'batcher.queue': None,
        'batcher.dispatch': None, 'program.build': 'batcher.dispatch',
        'program.wire_pack': 'batcher.dispatch',
        'program.upload': 'batcher.dispatch',
        'program.enqueue': 'batcher.dispatch', 'engine.fetch': None,
        'api.finish_predict': None, 'engine.wait': 'api.finish_predict',
        'engine.pages': None, 'engine.pages_wait': 'api.finish_predict',
        'engine.unpack': 'api.finish_predict',
        'api.assemble': 'api.finish_predict',
        'api.split': 'api.assemble'}),
    False: dict(PROGRAM, **{
        'api.predict_async': None, 'api.project': 'api.predict_async',
        'api.reorient': 'api.project', 'engine.crop': 'api.predict_async',
        'engine.wire': 'api.predict_async',
        'program.build': 'api.predict_async',
        'program.wire_pack': 'api.predict_async',
        'program.upload': 'api.predict_async',
        'program.enqueue': 'api.predict_async',
        'api.finish_predict': None, 'engine.fetch': 'api.finish_predict',
        'engine.pages': None, 'engine.pages_wait': 'api.finish_predict',
        'engine.unpack': 'api.finish_predict',
        'api.assemble': 'api.finish_predict',
        'api.split': 'api.assemble'}),
}


@pytest.fixture(scope='module', autouse=True)
def _two_threads():
    """Two intra-op threads: the batcher runs torch beside the caller."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _recorder_off():
    trace.disable()
    yield
    trace.disable()


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('zoo'))
    build_group_set(root, model=KEY, spacing=(1.2, 2.0))
    return root


@pytest.fixture(scope='module')
def ct():
    """A small int16 CT (z, y, x) whose projection crops and resamples."""
    rng = np.random.default_rng(0)
    vol = np.zeros((40, 30, 50), np.int16)
    vol[4:-4, 3:-3, 5:-5] = rng.integers(-500, 800, (32, 24, 40))
    return MedicalImage(array=vol, spacing=(1.0, 1.0, 2.6))


def _tool(root, batching):
    return TS2D(key=KEY, use_remote=False, fetch_remote=False, local=root,
                device='cpu', batching=batching)


def _idle(batcher, timeout=30.0):
    """Wait until no program of ``batcher`` is being fetched."""
    deadline = time.monotonic() + timeout
    while batcher._inflight and time.monotonic() < deadline:
        time.sleep(0.005)
    assert not batcher._inflight


def _check_tree(spans, tree):
    by_id = {s.id: s for s in spans}
    assert {s.name for s in spans} == set(tree)
    for s in spans:
        assert s.start_ns <= s.end_ns, s
        want = tree[s.name]
        want = want if isinstance(want, tuple) else (want,)
        parent = by_id.get(s.parent)
        assert (parent.name if parent else None) in want, s
        if parent is not None:
            assert parent.thread == s.thread, s
            assert parent.start_ns <= s.start_ns <= s.end_ns \
                <= parent.end_ns, s
    assert trace.RECORDER.stack() == [], 'a span was left open'


@pytest.mark.parametrize('batching', [True, False])
def test_traced_scan_gives_the_span_tree(root, ct, monkeypatch, batching):
    monkeypatch.setattr(native, 'PAGES_MIN_BYTES', 0)   # small arrays too
    with _tool(root, batching) as tool:
        trace.enable()
        handle = tool.predict_async(ct)
        if batching:  # the watcher, not the caller, fetches the result
            _idle(tool._fused._batcher)
        result = tool.finish_predict(handle)
        spans = trace.collect()
    assert result.get_segmentation() is not None
    _check_tree(spans, TREE[batching])
    roots = [s for s in spans if s.name == 'api.predict_async']
    assert len(roots) == 1 and len(roots[0].scans) == 1
    assert all(s.scans == roots[0].scans for s in spans)
    threads = {s.thread for s in spans}
    assert len(threads) == (4 if batching else 2)
    assert {s.thread_name for s in spans} == {
        threading.main_thread().name, 'ts2d-pages_0'} | (
            {'ts2d-batcher', 'ts2d-batch-watch'} if batching else set())
    # the Result's pages are mapped on their own thread, before the finish
    # waits them out of it
    pages, = (s for s in spans if s.name == 'engine.pages')
    wait, = (s for s in spans if s.name == 'engine.pages_wait')
    assert pages.thread_name == 'ts2d-pages_0'
    assert pages.end_ns <= wait.end_ns and pages.nbytes == sum(
        a.nbytes for a in [result.get_segmentation().array]
        + [result.get_segmentation(m).array for m in result.models])


def test_blocking_predict_holds_both_halves(root, ct):
    with _tool(root, False) as tool:
        tool.predict(ct)
        trace.enable()
        tool.predict(ct)
        spans = trace.collect()
    top = [s for s in spans if s.parent is None]
    assert [s.name for s in top] == ['api.predict']
    children = {s.name for s in spans if s.parent == top[0].id}
    assert children == {'api.project', 'engine.crop', 'engine.wire',
                        'program.wire_pack', 'program.upload',
                        'program.enqueue', 'api.finish_predict'}
    assert all(s.scans == top[0].scans for s in spans)


@pytest.mark.parametrize('batching', [True, False])
def test_scans_in_flight_wait_for_their_own_pages(root, ct, monkeypatch,
                                                  batching):
    """Three scans dispatched before any finishes: each of the first
    ``PAGES_AHEAD``'s ``engine.pages`` (on the pages thread, with the bytes
    it mapped) and ``engine.pages_wait`` (in its finish) carry that scan's
    id alone; the scan dispatched past them has neither."""
    monkeypatch.setattr(native, 'PAGES_MIN_BYTES', 0)
    ahead = ensemble_engine.PAGES_AHEAD
    assert ahead < 3
    with _tool(root, batching) as tool:
        trace.enable()
        handles = [tool.predict_async(ct) for _ in range(3)]
        for h in handles:
            tool.finish_predict(h)
        spans = trace.collect()
    roots = [s.scans for s in sorted(spans, key=lambda s: s.start_ns)
             if s.name == 'api.predict_async']
    assert len(set(roots)) == 3 and all(len(r) == 1 for r in roots)
    for name in ('engine.pages', 'engine.pages_wait'):
        mine = [s for s in spans if s.name == name]
        assert sorted(s.scans for s in mine) == sorted(roots[:ahead]), name
    pages = [s for s in spans if s.name == 'engine.pages']
    assert {s.thread_name for s in pages} == {'ts2d-pages_0'}
    assert len({s.nbytes for s in pages}) == 1 and pages[0].nbytes > 0


def test_coalesced_scans_share_one_dispatch(root, ct):
    with _tool(root, True) as tool:
        b = tool._fused._batcher
        b.ramp_solos, b.min_fill = 0, 2
        trace.enable()
        with b._cv:  # both queue before the dispatcher can take one
            handles = [tool.predict_async(ct) for _ in range(2)]
        for h in handles:
            tool.finish_predict(h)
        spans = trace.collect()
        assert b.stats()['batch_occupancy'][1] == 1
    ids = sorted(s.scans[0] for s in spans if s.name == 'api.predict_async')
    assert len(set(ids)) == 2
    dispatch = [s for s in spans if s.name == 'batcher.dispatch']
    assert len(dispatch) == 1 and sorted(dispatch[0].scans) == ids
    for name in ('program.enqueue', 'program.tiles', 'engine.fetch'):
        got = [s for s in spans if s.name == name]
        assert len(got) == 1 and sorted(got[0].scans) == ids, name
    assert sorted(s.scans[0] for s in spans if s.name == 'batcher.queue') \
        == ids


class HeldArray:
    """A device result whose host fetch waits for ``release``."""

    def __init__(self, arr, release):
        self.arr, self.release = np.asarray(arr), release

    def __array__(self, dtype=None, copy=None):
        assert self.release.wait(timeout=30)
        return self.arr


class HeldEngine:
    """Enough of EnsembleEngine for DynamicBatcher: programs whose results
    are fetched only once the test releases them, which keeps the device
    'busy' until then."""

    def __init__(self):
        self.release = threading.Event()

    _launch_solo = EnsembleEngine._launch_solo

    def _serving_program(self, shape, spacing, wire=None):
        return (lambda x, mask=None: HeldArray(np.asarray(x)[None],
                                               self.release)), {}

    def _batched_program(self, batch, shape, spacing, has_mask, wire=None):
        return (lambda x, mask=None: HeldArray(x, self.release)), {}


def test_stats_count_solo_reasons():
    eng = HeldEngine()
    b = DynamicBatcher(eng, max_batch=8, accumulate_gap_ms=5.0, min_fill=4)
    b.ramp_solos = 1
    scan = np.zeros((6, 5, 2), np.float32)
    try:
        first = b.submit(scan, None, (1.5, 1.5), (0, 0), (6, 5))
        first.result(timeout=10)   # dispatched: its fetch keeps the card busy
        with b._cv:
            rest = [b.submit(scan, None, (1.5, 1.5), (0, 0), (6, 5))
                    for _ in range(2)]
        for f in rest:
            f.result(timeout=10)
        reasons = b.stats()['batch_solo_reasons']
    finally:
        eng.release.set()
        b.stop()
    assert reasons == {'ramp': 1, 'below_min_fill': 2}


def test_recorder_off_records_nothing(root, ct):
    assert trace.span('a') is trace.span('b', scan=(3,))
    assert trace.span('c', scan=trace.NEW) is trace.span('a')
    assert trace.scans() == () and trace.stamp() is None
    trace.enable()
    trace.disable()
    with _tool(root, True) as tool:
        tool.finish_predict(tool.predict_async(ct))
        tool.predict(ct)
    assert trace.collect() == []


def test_profiler_twins_match_the_spans(root, ct):
    """Every span but the batcher's queue (it crosses threads) has a host
    event of its name under the profiler, nested as the span is, starting
    where the span starts on the profiler's clock."""
    with _tool(root, True) as tool:
        tool.predict(ct)
        t0 = time.perf_counter_ns()
        every = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=every) as prof:
            tool.finish_predict(tool.predict_async(ct))
        spans = [s for s in trace.collect() if s.start_ns >= t0]
    base = prof.profiler.kineto_results.trace_start_ns()
    names = {s.name for s in spans}
    events = [e for e in prof.events()
              if e.name in names and e.device_type == DeviceType.CPU]
    by_id = {s.id: s for s in spans}
    assert 'program.enqueue' in names and 'engine.fetch' in names
    for s in spans:
        if s.name == 'batcher.queue':
            continue
        mine = [e for e in events if e.name == s.name]
        assert mine, s.name
        ev = min(mine, key=lambda e: abs(base + e.time_range.start * 1000
                                         - s.unix_start_ns))
        assert abs(base + ev.time_range.start * 1000
                   - s.unix_start_ns) < 1e6, s.name
        up = ev.cpu_parent
        while up is not None and up.name not in names:
            up = up.cpu_parent
        want = by_id[s.parent].name if s.parent is not None else None
        assert (up.name if up is not None else None) == want, s.name


def test_unix_clock_and_bounded_buffer():
    trace.enable()
    with trace.span('outer', scan=trace.NEW):
        now = time.time_ns()
    (s,) = trace.collect()
    assert abs(s.unix_start_ns - now) < 1e6
    rec = trace.Recorder(capacity=5)
    for i in range(12):
        rec.add(rec.new_span(), f's{i}', None, (), i, i + 1)
    assert [x.name for x in rec.collect()] == [f's{i}' for i in range(7, 12)]


def test_concurrent_recording_loses_nothing():
    """More threads than cores open nested spans at a short switch
    interval: every span is kept once, nested on its own thread."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    trace.enable()

    def work():
        for _ in range(50):
            with trace.span('outer', scan=trace.NEW):
                with trace.span('inner'):
                    pass

    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    spans = trace.collect()
    by_id = {s.id: s for s in spans}
    assert len(spans) == len(by_id) == 16 * 50 * 2
    inner = [s for s in spans if s.name == 'inner']
    assert all(by_id[s.parent].thread == s.thread
               and by_id[s.parent].scans == s.scans for s in inner)
    assert len({s.scans for s in inner}) == 16 * 50


def test_count_bytes_off_and_outside_a_span():
    trace.count_bytes(10)   # nothing records
    trace.enable()
    trace.count_bytes(5)    # no span open
    with trace.span('outer', scan=trace.NEW):
        with trace.span('inner'):
            trace.count_bytes(3)
            trace.count_bytes(4)
        trace.count_bytes(1)
    got = {s.name: s.nbytes for s in trace.collect()}
    assert got == {'inner': 7, 'outer': 1}
