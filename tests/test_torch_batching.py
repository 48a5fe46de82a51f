"""The PyTorch port's host runtime against fakes: the DynamicBatcher policy,
its cancellation and elastic restart (the cases of
tests/test_020_batching.py), the fetch-once _BatchResult, the AsyncRunner
(tests/test_009_runtime.py) and ScanPipeline.

A fake engine records every dispatched program and its batch size; a
SlowArray output stands for a device result whose download takes real
time, which is what keeps the device 'busy' for the policy."""

import threading
import time

import numpy as np
import pytest
import torch

from totalsegmentator2d_tpu_torch.inference import (AsyncRunner,
                                                    DynamicBatcher,
                                                    ScanPipeline)
from totalsegmentator2d_tpu_torch.inference.batching import _BatchResult
from totalsegmentator2d_tpu_torch.utils.trace import StageTimer, device_trace


class SlowArray:
    """A device result whose host fetch (``__array__``) takes ``delay``
    seconds."""

    def __init__(self, arr, delay):
        self.arr = np.asarray(arr)
        self.delay = delay
        self.fetched = threading.Event()

    def __array__(self, dtype=None, copy=None):
        time.sleep(self.delay)
        self.fetched.set()
        out = self.arr if dtype is None else self.arr.astype(dtype)
        return np.array(out) if copy else out

    def __getitem__(self, key):
        # the device-side padding slice of _dispatch
        return SlowArray(self.arr[key], self.delay)


def _restore(x):
    """The payload as one float32 array (the int16 wires of these tests
    keep the channel order)."""
    if isinstance(x, tuple):
        return np.concatenate([np.asarray(p, np.float32) for p in x], -1)
    return np.asarray(x)


class FakeEngine:
    """Looks enough like EnsembleEngine for DynamicBatcher: the programs
    return their input stack and record every dispatch's batch size."""

    def __init__(self, fetch_delay=0.0):
        self.fetch_delay = fetch_delay
        self.dispatches = []      # (kind, program rows)
        self.outputs = []         # the SlowArray of each dispatch
        self._lock = threading.Lock()

    def _serving_program(self, shape, spacing, wire=None):
        def fn(x, mask=None):
            out = SlowArray(_restore(x)[None], self.fetch_delay)
            with self._lock:
                self.dispatches.append(('solo', 1))
                self.outputs.append(out)
            return out
        return fn, {}

    def _batched_program(self, max_batch, shape, spacing, has_mask,
                         wire=None):
        def fnb(xb, mb=None):
            arr = _restore(xb)
            assert arr.shape[0] == max_batch, 'a batch pads to max_batch'
            out = SlowArray(arr, self.fetch_delay)
            with self._lock:
                self.dispatches.append(('batch', arr.shape[0]))
                self.outputs.append(out)
            return out
        return fnb, {}


def _mk(i, shape=(16, 12)):
    """A scan whose content encodes its submission index."""
    return np.full(shape + (2,), float(i), np.float32)


def _submit_locked(b, items, wire=None):
    """Queue every item before the dispatcher can run (the condition's lock
    is re-entrant)."""
    with b._cv:
        return [b.submit(it, None, (1.5, 1.5), (0, 0), it.shape, wire)
                for it in items]


def _drain(futs, timeout=30):
    return [f.result(timeout=timeout) for f in futs]


def _row(res):
    br, idx, _, _ = res
    return br.get()[0 if idx is None else idx]


class TestPolicy:
    def test_idle_device_dispatches_solo_immediately(self):
        eng = FakeEngine()
        b = DynamicBatcher(eng, max_batch=8)
        try:
            t0 = time.monotonic()
            br, idx, _, _ = b.submit(_mk(0), None, (1.5, 1.5), (0, 0),
                                     (16, 12)).result(timeout=10)
            assert time.monotonic() - t0 < 0.5 * b.accumulate_gap_ms / 1e3 + 1
            assert idx is None and eng.dispatches == [('solo', 1)]
            np.testing.assert_array_equal(br.get()[0], _mk(0))
        finally:
            b.stop()

    def test_deep_queue_cancels_the_ramp(self):
        # 12 queued at once: a full batch waits, so the ramp cancels; 8
        # coalesce, the 4 left ride a padded batch (>= min_fill)
        eng = FakeEngine(fetch_delay=1.0)
        b = DynamicBatcher(eng, max_batch=8, accumulate_gap_ms=30.0)
        try:
            res = _drain(_submit_locked(b, [_mk(i) for i in range(12)]))
            assert eng.dispatches == [('batch', 8), ('batch', 8)]
            for i, r in enumerate(res):
                np.testing.assert_array_equal(_row(r), _mk(i))
            st = b.stats()
            assert st['batch_occupancy'][7] == 1 and st['batch_occupancy'][3] == 1
            assert st['batch_programs'] == 2 and st['batch_scans'] == 12
            assert st['batch_scans_coalesced'] == 12
            assert st['batch_mean_occupancy'] == pytest.approx(6.0)
        finally:
            b.stop()

    def test_burst_ramp_engages_on_shallow_queue(self):
        eng = FakeEngine(fetch_delay=1.0)
        b = DynamicBatcher(eng, max_batch=8, accumulate_gap_ms=30.0)
        try:
            res = _drain(_submit_locked(b, [_mk(i) for i in range(5)]))
            assert eng.dispatches == [('solo', 1)] * 5
            for i, r in enumerate(res):
                np.testing.assert_array_equal(_row(r), _mk(i))
        finally:
            b.stop()

    def test_below_min_fill_goes_solo(self):
        eng = FakeEngine(fetch_delay=1.0)
        b = DynamicBatcher(eng, max_batch=8, min_fill=4,
                           accumulate_gap_ms=20.0)
        b.ramp_solos = 0
        try:
            _drain(_submit_locked(b, [_mk(i) for i in range(3)]))
            assert eng.dispatches == [('solo', 1)] * 3
        finally:
            b.stop()

    def test_partial_batch_slices_padding_before_fetch(self):
        eng = FakeEngine()
        b = DynamicBatcher(eng, max_batch=8, min_fill=4)
        b.ramp_solos = 0
        try:
            res = _drain(_submit_locked(b, [_mk(i) for i in range(5)]))
            assert eng.dispatches == [('batch', 8)]
            for i, (br, idx, _, _) in enumerate(res):
                assert idx == i
                np.testing.assert_array_equal(br.get()[idx], _mk(i))
            assert res[0][0].get().shape[0] == 5  # the [:5] device slice
        finally:
            b.stop()

    @pytest.mark.parametrize('other', ['shape', 'wire'])
    def test_different_keys_never_co_batch(self, other):
        eng = FakeEngine()
        b = DynamicBatcher(eng, max_batch=8, min_fill=2)
        b.ramp_solos = 0
        try:
            a = [_mk(i) for i in range(4)]
            if other == 'shape':
                c = [_mk(10 + i, shape=(20, 12)) for i in range(4)]
                with b._cv:
                    futs = _submit_locked(b, a) + _submit_locked(b, c)
            else:  # one shape, two input wires
                c = [_mk(10 + i) for i in range(4)]
                with b._cv:
                    futs = (_submit_locked(b, a, wire=(True, False))
                            + _submit_locked(b, c, wire=(True, True)))
            res = _drain(futs)
            assert eng.dispatches == [('batch', 8), ('batch', 8)]
            assert eng.outputs[0].arr[0, 0, 0, 0] == 0.0
            assert eng.outputs[1].arr[0, 0, 0, 0] == 10.0
            for want, r in zip(a + c, res):
                np.testing.assert_array_equal(_row(r), want)
        finally:
            b.stop()

    def test_all_float_wire_is_the_plain_key(self):
        eng = FakeEngine()
        b = DynamicBatcher(eng, max_batch=2)
        b.ramp_solos = 0
        try:
            with b._cv:
                futs = (_submit_locked(b, [_mk(0)], wire=(False, False))
                        + _submit_locked(b, [_mk(1)]))
            _drain(futs)
            assert eng.dispatches == [('batch', 2)]
        finally:
            b.stop()

    def test_watcher_prefetches_and_clears_inflight(self):
        eng = FakeEngine(fetch_delay=0.2)
        b = DynamicBatcher(eng, max_batch=8)
        try:
            b.submit(_mk(0), None, (1.5, 1.5), (0, 0), (16, 12)).result(10)
            assert eng.outputs[0].fetched.wait(timeout=5)
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline and b._inflight != 0:
                time.sleep(0.01)
            assert b._inflight == 0
        finally:
            b.stop()

    def test_small_max_batch_still_coalesces(self):
        eng = FakeEngine()
        b = DynamicBatcher(eng, max_batch=2)
        assert b.min_fill == 2
        b.ramp_solos = 0
        try:
            res = _drain(_submit_locked(b, [_mk(i) for i in range(4)]))
            assert eng.dispatches == [('batch', 2)] * 2
            for i, r in enumerate(res):
                np.testing.assert_array_equal(_row(r), _mk(i))
        finally:
            b.stop()

    def test_full_batch_of_other_key_skips_minority_head(self):
        eng = FakeEngine(fetch_delay=1.0)
        b = DynamicBatcher(eng, max_batch=4, min_fill=2,
                           accumulate_gap_ms=2000.0)
        b.ramp_solos = 0
        try:
            b.submit(_mk(99), None, (1.5, 1.5), (0, 0), (16, 12)).result(10)
            a = _mk(0)
            c = [_mk(10 + i, shape=(20, 12)) for i in range(4)]
            futs = _submit_locked(b, [a] + c)
            t0 = time.monotonic()
            while time.monotonic() < t0 + 10:
                with eng._lock:
                    if ('batch', 4) in eng.dispatches:
                        break
                time.sleep(0.005)
            waited = time.monotonic() - t0
            assert ('batch', 4) in eng.dispatches
            assert waited < 0.5, waited  # not after the gap or the fetch
            res = _drain(futs)
            for want, r in zip([a] + c, res):
                np.testing.assert_array_equal(_row(r), want)
        finally:
            b.stop()

    def test_arrival_pause_flushes_partial_as_solos(self):
        eng = FakeEngine(fetch_delay=1.0)
        b = DynamicBatcher(eng, max_batch=8, accumulate_gap_ms=40.0)
        b.ramp_solos = 1
        try:
            futs = _submit_locked(b, [_mk(i) for i in range(3)])
            t0 = time.monotonic()
            _drain(futs)
            assert eng.dispatches == [('solo', 1)] * 3
            assert time.monotonic() - t0 < 0.9
        finally:
            b.stop()

    def test_linger_fills_the_batch_of_the_oldest_request(self):
        # with a linger the oldest request's batch waits to fill: 3 scans
        # arriving one by one ride one program
        eng = FakeEngine()
        b = DynamicBatcher(eng, max_batch=3, linger_ms=5000.0)
        try:
            futs = []
            for i in range(3):
                futs.append(b.submit(_mk(i), None, (1.5, 1.5), (0, 0),
                                     (16, 12)))
                time.sleep(0.05)
            res = _drain(futs)
            assert eng.dispatches == [('batch', 3)]
            for i, r in enumerate(res):
                np.testing.assert_array_equal(_row(r), _mk(i))
        finally:
            b.stop()

    def test_linger_deadline_sends_a_partial_batch(self):
        eng = FakeEngine()
        b = DynamicBatcher(eng, max_batch=4, linger_ms=100.0)
        try:
            futs = _submit_locked(b, [_mk(i) for i in range(2)])
            t0 = time.monotonic()
            _drain(futs)
            assert 0.05 <= time.monotonic() - t0 < 5
            assert eng.dispatches == [('batch', 4)]
        finally:
            b.stop()


class TestCancellationAndErrors:
    def test_cancelled_future_skips_dispatch(self):
        eng = FakeEngine(fetch_delay=0.5)
        b = DynamicBatcher(eng, max_batch=8, min_fill=2)
        b.ramp_solos = 0
        try:
            with b._cv:
                futs = _submit_locked(b, [_mk(i) for i in range(4)])
                assert futs[2].cancel()
            res = [f.result(timeout=10) for f in futs if not f.cancelled()]
            assert len(res) == 3
            for want, (br, idx, _, _) in zip([0, 1, 3], res):
                np.testing.assert_array_equal(br.get()[idx], _mk(want))
        finally:
            b.stop()

    def test_dispatch_error_reaches_every_waiter(self):
        # no fallback re-runs a failed batch: each caller of the batch gets
        # the error, and the dispatcher serves on
        eng = FakeEngine()

        def broken(*args, **kwargs):
            raise RuntimeError('device program failed')

        eng._batched_program = broken
        b = DynamicBatcher(eng, max_batch=3)
        b.ramp_solos = 0
        try:
            futs = _submit_locked(b, [_mk(i) for i in range(3)])
            for f in futs:
                with pytest.raises(RuntimeError, match='program failed'):
                    f.result(timeout=10)
            fut = b.submit(_mk(7), None, (1.5, 1.5), (0, 0), (16, 12))
            np.testing.assert_array_equal(_row(fut.result(10)), _mk(7))
        finally:
            b.stop()


@pytest.mark.filterwarnings(
    'ignore::pytest.PytestUnhandledThreadExceptionWarning')
class TestElasticRestart:
    """A dispatcher that dies of an internal error restarts on the next
    submit, with a crash-loop cap. (The dying dispatcher re-raises on
    purpose, which pytest reports as an unhandled thread exception.)"""

    @staticmethod
    def _kill_dispatcher(b):
        orig = b._take_batch

        def boom(cap=None):
            b._take_batch = orig
            raise RuntimeError('injected dispatcher fault')

        b._take_batch = boom
        fut = b.submit(_mk(99), None, (1.5, 1.5), (0, 0), (16, 12))
        with pytest.raises(RuntimeError, match='dispatcher died'):
            fut.result(timeout=10)
        b._thread.join(timeout=10)
        assert not b._thread.is_alive()

    def test_restart_after_crash_serves_again(self):
        b = DynamicBatcher(FakeEngine(), max_batch=8)
        try:
            self._kill_dispatcher(b)
            fut = b.submit(_mk(1), None, (1.5, 1.5), (0, 0), (16, 12))
            np.testing.assert_array_equal(_row(fut.result(timeout=10)),
                                          _mk(1))
            assert b._crashes == 0
            assert b.stats()['batch_dispatcher_crashes'] == 1
        finally:
            b.stop()

    def test_crash_loop_gives_up(self):
        b = DynamicBatcher(FakeEngine(), max_batch=8)
        try:
            for _ in range(b.max_restarts):
                self._kill_dispatcher(b)
            with pytest.raises(RuntimeError, match='giving up'):
                b.submit(_mk(0), None, (1.5, 1.5), (0, 0), (16, 12))
        finally:
            b.stop()

    def test_user_stop_never_restarts(self):
        b = DynamicBatcher(FakeEngine(), max_batch=8)
        assert b.stop()
        with pytest.raises(RuntimeError, match='stopped'):
            b.submit(_mk(0), None, (1.5, 1.5), (0, 0), (16, 12))

    def test_crash_with_inflight_watcher_keeps_counter_balanced(self):
        b = DynamicBatcher(FakeEngine(fetch_delay=0.6), max_batch=8)
        try:
            b.submit(_mk(0), None, (1.5, 1.5), (0, 0), (16, 12)).result(10)
            self._kill_dispatcher(b)
            b.submit(_mk(1), None, (1.5, 1.5), (0, 0), (16, 12)).result(10)
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline and b._inflight != 0:
                time.sleep(0.05)
            assert b._inflight == 0, b._inflight
        finally:
            b.stop()


class TestBatchResult:
    @pytest.mark.parametrize('streams', [1, 4])
    def test_large_result_fetches_bit_identically_and_once(self, streams,
                                                           monkeypatch):
        monkeypatch.setattr(_BatchResult, '_SPLIT_STREAMS', streams)
        arr = np.random.default_rng(3).integers(0, 255, (8, 600_001),
                                                dtype=np.uint8)
        br = _BatchResult(torch.from_numpy(arr))
        out = br.get()
        assert out.dtype == np.uint8 and np.array_equal(out, arr)
        assert br.get() is out

    def test_one_download_stream_by_default(self):
        assert _BatchResult._SPLIT_STREAMS == 1

    def test_solo_tall_result_splits_into_bounded_slabs(self, monkeypatch):
        monkeypatch.setattr(_BatchResult, '_SPLIT_STREAMS', 4)

        class Counting(SlowArray):
            ndim, slices = 2, 0
            nbytes = 5_000_000  # over the split threshold

            @property
            def shape(self):
                return self.arr.shape

            def __getitem__(self, key):
                type(self).slices += 1
                return super().__getitem__(key)

        arr = np.arange(600 * 40, dtype=np.uint8).reshape(600, 40)
        assert np.array_equal(_BatchResult(Counting(arr, 0.0)).get(), arr)
        assert 2 <= Counting.slices <= _BatchResult._SPLIT_STREAMS

    def test_small_result_fetches_whole(self):
        class Spy(SlowArray):
            ndim, sliced = 2, False
            nbytes = 128

            @property
            def shape(self):
                return self.arr.shape

            def __getitem__(self, key):
                type(self).sliced = True
                return super().__getitem__(key)

        small = Spy(np.ones((8, 16), np.uint8), 0.0)
        assert np.array_equal(_BatchResult(small).get(), small.arr)
        assert not Spy.sliced

    def test_split_streams_run_concurrently(self, monkeypatch):
        monkeypatch.setattr(_BatchResult, '_SPLIT_STREAMS', 4)

        class BigSlow(SlowArray):
            ndim = 2
            nbytes = 4_000_000

            @property
            def shape(self):
                return self.arr.shape

        delay = 0.08
        arr = np.arange(8 * 32, dtype=np.uint8).reshape(8, 32)
        t0 = time.perf_counter()
        out = _BatchResult(BigSlow(arr, delay)).get()
        assert np.array_equal(out, arr)
        assert time.perf_counter() - t0 < 8 * delay * 0.7


class TestAsyncRunner:
    def test_submit_and_result(self):
        with AsyncRunner(num_workers=2) as r:
            futs = [r.submit(lambda i=i: i * i) for i in range(10)]
            assert [f.result(timeout=5) for f in futs] == \
                [i * i for i in range(10)]

    def test_warmup_runs_before_tasks(self):
        order = []
        r = AsyncRunner(num_workers=1)
        r.start(warmup=lambda: order.append('warm'))
        r.submit(lambda: order.append('task')).result(timeout=5)
        r.stop()
        assert order == ['warm', 'task']

    def test_task_exception_propagates(self):
        with AsyncRunner() as r:
            with pytest.raises(ZeroDivisionError):
                r.submit(lambda: 1 / 0).result(timeout=5)

    def test_wait_blocks_until_done(self):
        with AsyncRunner(num_workers=2) as r:
            done = []
            for i in range(4):
                r.submit(lambda i=i: (time.sleep(0.05), done.append(i)))
            r.wait(timeout=5)
            assert len(done) == 4

    def test_timestamps_recorded(self):
        with AsyncRunner() as r:
            r.submit(lambda: time.sleep(0.01), task_id='t1').result(timeout=5)
            assert set(r.timestamps('t1')) >= {'start', 'get', 'done'}

    def test_stop_cancels_pending(self):
        r = AsyncRunner(num_workers=1)
        r.start()
        r.submit(lambda: time.sleep(0.3))
        fut = r.submit(lambda: 42)
        r.stop(timeout=2)
        assert fut.cancelled() or fut.done()
        assert not r.alive()

    def test_stop_with_many_pending_does_not_raise(self):
        r = AsyncRunner(num_workers=1)
        r.start()
        release = threading.Event()
        r.submit(release.wait)
        futs = [r.submit(lambda i=i: i) for i in range(8)]
        try:
            r.stop(timeout=0.3)
        finally:
            release.set()
        assert all(f.cancelled() or f.done() for f in futs)

    def test_cancel_inflight_does_not_kill_worker(self):
        r = AsyncRunner(num_workers=1)
        r.start()
        started, release = threading.Event(), threading.Event()

        def slow():
            started.set()
            release.wait(5.0)
            return 'done'

        fut = r.submit(slow)
        assert started.wait(5.0)
        assert fut.cancel() is False
        release.set()
        assert fut.result(timeout=5) == 'done'
        assert r.submit(lambda: 7).result(timeout=5) == 7
        r.stop()

    def test_restart_after_timed_out_stop(self):
        r = AsyncRunner(num_workers=1)
        r.start()
        release = threading.Event()
        r.submit(release.wait)
        r.stop(timeout=0.2)   # expires; the pill stays queued
        release.set()
        time.sleep(0.3)
        r.start()
        assert r.submit(lambda: 11).result(timeout=5) == 11
        r.stop()

    def test_worker_outliving_stop_exits_on_restart(self):
        r = AsyncRunner(num_workers=1, name='ts2d-zombie-port')
        r.start()
        release = threading.Event()
        r.submit(release.wait)
        r.stop(timeout=0.2)
        r.start()
        release.set()
        deadline = time.monotonic() + 5
        stale = True
        while time.monotonic() < deadline:
            stale = [t for t in threading.enumerate()
                     if t.name.startswith('ts2d-zombie-port-worker')
                     and t not in r._threads]
            if not stale:
                break
            time.sleep(0.05)
        assert not stale
        assert r.submit(lambda: 7).result(timeout=5) == 7
        r.stop()


class TestStageTimerAndTrace:
    def test_deltas_and_report(self):
        t = StageTimer('x')
        time.sleep(0.01)
        t.mark('read')
        time.sleep(0.01)
        t.mark('predict')
        assert list(t.deltas()) == ['read', 'predict']
        assert all(v > 0 for v in t.deltas().values())
        assert 'total' in t.report()

    def test_device_trace_noop_and_writes(self, tmp_path):
        with device_trace(None):
            pass
        with device_trace(str(tmp_path)):
            torch.ones(8).sum()
        traces = list(tmp_path.glob('*.pt.trace.json'))
        assert len(traces) == 1 and traces[0].stat().st_size > 0


class FakeResult:
    def __init__(self, value, saved):
        self.value, self._saved = value, saved

    def save(self, name, dest):
        self._saved.append((name, dest, self.value))


class FakeTool:
    """A tool with predict_async / finish_predict whose handles count how
    many predictions are in flight at once."""

    supports_async = True

    def __init__(self, fail=()):
        self.saved, self.fail = [], set(fail)
        self.inflight = self.max_inflight = 0
        self._lock = threading.Lock()

    def predict(self, img, collapse=False):
        return self.finish_predict(self.predict_async(img, collapse))

    def predict_async(self, img, collapse=False):
        if int(img) in self.fail:
            raise RuntimeError('bad case')
        with self._lock:
            self.inflight += 1
            self.max_inflight = max(self.max_inflight, self.inflight)
        return int(img)

    def finish_predict(self, handle):
        with self._lock:
            self.inflight -= 1
        return FakeResult(handle * 10, self.saved)


class TestScanPipeline:
    @staticmethod
    def _patch_reader(monkeypatch, missing=()):
        import totalsegmentator2d_tpu_torch.inference.pipeline as pipeline

        def read(path):
            if path in missing:
                raise FileNotFoundError(path)
            return path
        monkeypatch.setattr(pipeline, 'read_image', read)

    def test_window_saves_and_timers(self, monkeypatch):
        self._patch_reader(monkeypatch)
        tool = FakeTool()
        results = []
        cases = [(f'c{i}', str(i)) for i in range(12)]
        timers = ScanPipeline(tool, in_flight=4).run(
            cases, on_result=lambda n, r: results.append((n, r.value)),
            save_kwargs={'dest': 'out'}, progress=False)
        assert results == [(f'c{i}', 10 * i) for i in range(12)]
        assert sorted(tool.saved) == sorted(
            (f'c{i}', 'out', 10 * i) for i in range(12))
        # the window keeps in_flight + 1 dispatched before the oldest drains
        assert tool.max_inflight == 5
        assert len(timers) == 12
        assert all({'dispatch', 'predict', 'saved'} <= set(t.marks)
                   for t in timers)

    def test_skips_bad_cases(self, monkeypatch):
        self._patch_reader(monkeypatch, missing=('1',))
        tool = FakeTool(fail=(2,))
        results = []
        timers = ScanPipeline(tool).run(
            [(f'c{i}', str(i)) for i in range(4)],
            on_result=lambda n, r: results.append(n), progress=False)
        assert results == ['c0', 'c3']
        assert len(timers) == 4

    def test_blocking_tool_runs_one_at_a_time(self, monkeypatch):
        self._patch_reader(monkeypatch)
        tool = FakeTool()
        tool.supports_async = False
        ScanPipeline(tool, in_flight=8).run(
            [(f'c{i}', str(i)) for i in range(5)], progress=False)
        assert tool.max_inflight == 2  # window 1: one queued, one finishing


class TestSharedStateUnderThreads:
    """The state this slice shares between request threads, the dispatcher
    and the watchers, stressed with more threads than cores and a short
    switch interval: a lost update would break the invariants."""

    @staticmethod
    def _hammer(work, threads=32):
        import sys
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            ts = [threading.Thread(target=work) for _ in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(60)
            assert not any(t.is_alive() for t in ts)
        finally:
            sys.setswitchinterval(interval)

    def test_launch_counts_lose_no_update(self):
        from totalsegmentator2d_tpu_torch.ops.cuda import count_launch

        def wrapper():
            pass

        wrapper.launches = 0
        self._hammer(lambda: [count_launch(wrapper) for _ in range(2000)])
        assert wrapper.launches == 32 * 2000

    def test_exact_numerics_hold_while_any_thread_is_inside(self):
        from totalsegmentator2d_tpu_torch.utils import device as D
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        broken = []

        def work():
            for _ in range(300):
                with D.exact_numerics():
                    if torch.backends.cuda.matmul.allow_tf32:
                        broken.append(True)

        try:
            self._hammer(work)
            assert not broken
            assert torch.backends.cuda.matmul.allow_tf32 is True
            assert D._exact_holders == 0
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
