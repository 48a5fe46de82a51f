"""The per-layer metrics that read the port's spans: each reader on a
hand-made span tree, None where its spans are absent (no slice, no such
span, a port that records none), and a traced CPU run of every cell that
lists each of them reading a value."""

import json
import os
import time
from types import SimpleNamespace

import pytest

from benchmark import manifest, spans
from totalsegmentator2d_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MS = 1_000_000
NEW = {'api.project_ms', 'api.finish_host_ms', 'batcher.queue_wait_ms',
       'program.enqueue_ms', 'engine.fetch_host_ms'}


def _metrics():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return {m['name']: m for m in json.load(f)['per_layer']}


def _run(window_s=1.0):
    return SimpleNamespace(slice=SimpleNamespace(window_s=window_s,
                                                 scans=[0, 1]))


@pytest.fixture
def recorded():
    """Two scans by hand in the port's recorder: scan 1 alone, and a
    program that carried scans 1 and 2. Offsets in ms."""
    trace.enable()
    trace.disable()
    t0 = time.perf_counter_ns()
    ids = iter(range(1, 100))

    def add(name, start, end, parent=None, scans=(1,)):
        sid = next(ids)
        trace.RECORDER.add(sid, name, parent, scans, t0 + start * MS,
                           t0 + end * MS)
        return sid

    root = add('api.predict_async', 0, 70)
    add('api.project', 1, 61, root)
    add('api.project', 200, 250, add('api.predict_async', 200, 260,
                                     scans=(2,)), scans=(2,))
    add('batcher.queue', 70, 71)
    add('batcher.queue', 260, 263, scans=(2,))
    enq = add('program.enqueue', 72, 130, add('batcher.dispatch', 71, 131))
    add('program.sync', 121, 124, add('program.decide', 120, 125, enq))
    add('program.enqueue', 263, 283, scans=(1, 2))
    add('engine.device_wait', 130, 132, add('engine.fetch', 130, 140))
    add('engine.fetch', 283, 287, scans=(1, 2))
    fin = add('api.finish_predict', 100, 200)
    add('engine.wait', 100, 170, fin)
    add('api.finish_predict', 300, 310, scans=(2,))
    yield
    trace.enable()
    trace.disable()


@pytest.mark.parametrize('metric,want', [
    ('api.project_ms', (60 + 50) / 2),
    ('api.finish_host_ms', (30 + 10) / 2),
    ('batcher.queue_wait_ms', (1 + 3) / 2),
    # (58 less a 3 ms sync) + 20, over the 1 + 2 scans the programs carried
    ('program.enqueue_ms', (55 + 20) / 3),
    ('engine.fetch_host_ms', (8 + 4) / 3),
])
def test_reader_on_hand_made_spans(recorded, metric, want):
    assert manifest.reader(ROOT, metric)(_run()) == pytest.approx(want)


@pytest.mark.parametrize('metric', sorted(NEW))
def test_reader_without_its_spans(recorded, monkeypatch, metric):
    read = manifest.reader(ROOT, metric)
    assert read(SimpleNamespace(slice=None)) is None
    monkeypatch.delattr(trace, 'collect')   # a port that records no spans
    assert read(_run()) is None


def test_reader_reads_the_slice_alone(recorded):
    # a slice of 60 ms ends with the last finish at 310 ms: the spans that
    # opened from 200 ms (less the 50 ms margin before the slice) are its own
    read = manifest.reader(ROOT, 'api.project_ms')
    assert read(_run(window_s=0.06)) == pytest.approx(50)
    # a program still running when the slice ends is left out
    end = max(s.end_ns for s in trace.collect())
    trace.RECORDER.add(999, 'program.enqueue', None, (3,), end - MS,
                       end + MS)
    assert manifest.reader(ROOT, 'program.enqueue_ms')(_run()) \
        == pytest.approx((55 + 20) / 3)


def test_reader_on_an_empty_recorder():
    trace.enable()
    trace.disable()
    for metric in NEW:
        assert manifest.reader(ROOT, metric)(_run()) is None
    assert spans.ms_per_scan([], 'api.project') is None


@pytest.fixture(scope='module')
def traced_root(tmp_path_factory):
    """The miniature checkout with 8 traced scans a run: the cohorts' slice
    then holds programs that start and end inside it (2 scans, with 4 in
    flight, finish only programs sent before the slice)."""
    from benchmark.conftest import make_small_root
    root = make_small_root(str(tmp_path_factory.mktemp('spans') / 'root'))
    folder = os.path.join(root, 'benchmark', 'traffic')
    for name in os.listdir(folder):
        with open(os.path.join(folder, name)) as f:
            mix = json.load(f)
        mix['traced_scans'] = 8
        with open(os.path.join(folder, name), 'w') as f:
            json.dump(mix, f)
    return root


@pytest.mark.parametrize('cell', ['ct-exact.solo', 'ct-fast.cohort8',
                                  'ct-fast.cohort8-mixed'])
def test_traced_run_reads_every_span_metric(run_small, traced_root, cell):
    code, line, err = run_small(cell, seed=2 ** 31 + 3, trace=1,
                                root=traced_root)
    assert code == 0, err
    want = {n for n, m in _metrics().items()
            if n in NEW and cell in m['workloads']}
    assert want and want <= set(line['metrics']), line['metrics']
    for name in want:
        assert line['metrics'][name]['value'] > 0, name
        assert line['metrics'][name]['unit'] == 'ms/scan'
