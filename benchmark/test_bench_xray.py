"""The native X-ray cell ``xr-fast.solo``: its committed files against the
benchmark's contract, a run of it at a small size on the CPU at both trace
settings, the three metrics that read the radiograph path's spans and byte
count on hand-made spans, and one short run of it on the card (skipped
without one)."""

import json
import os
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from benchmark import manifest
from totalsegmentator2d_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = 'xr-fast.solo'
MS = 1_000_000
NEW = ('api.split_ms', 'engine.unpack_ms', 'engine.wire_mb')
# what a solo native 2D scan reports (test_bench_manifest.SOLO_2D, and the
# fused kernel's roofline at the fast precision), and the new metrics
SOLO_2D = {'api.dispatch_ms', 'api.project_ms', 'api.finish_host_ms',
           'program.launches_per_scan', 'step_mfu_pct', 'prefilter_roofline',
           'device.idle_pct', 'program.enqueue_ms', 'engine.fetch_host_ms',
           'fused_block_roofline'}
# of those, what a CPU run can read (the rest read the card's kernels)
ON_THE_CPU = {'api.dispatch_ms', 'api.project_ms', 'api.finish_host_ms',
              'program.enqueue_ms', 'engine.fetch_host_ms', *NEW}
# the small radiographs of the CPU run at the mix's 0.148 mm: a crop of
# several 64^2 tiles at the 1.5 mm plan and one of a single tile
SMALL_2D = [[900, 1040], [420, 480]]


@pytest.fixture(scope='module')
def bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def test_the_committed_cell(bench):
    cell = manifest.cell(ROOT, CELL)
    (w,) = [w for w in bench['workloads'] if w['name'] == CELL]
    assert w['chips'] == 1 and w['traffic'] == 'xr-solo'
    (c,) = [c for c in bench['configs'] if c['name'] == w['config']]
    assert c['reduced'] == [] and cell.config['name'] == c['name']
    assert c['source'] == cell.config['source'] \
        == 'https://zenodo.org/records/17052912'
    assert cell.config['model_key'] == 'tsxr-v2-ep1000b2'
    assert cell.config['channels'] == ['xray']
    assert cell.config['precision'] == 'fast'
    assert sum(cell.config['groups'].values()) == 117
    with open(os.path.join(ROOT, 'benchmark', 'configs',
                           'ts2d-v2-fast.json')) as f:
        ct = json.load(f)
    same = set(ct) - {'name', 'source', 'model_key', 'channels',
                      'weight_seed', 'assumed'}
    assert {k: cell.config[k] for k in same} == {k: ct[k] for k in same}
    assert set(cell.config['assumed']) >= {'groups', 'spacing', 'weights',
                                           'head_bias_shift'}
    assert cell.traffic['entry'] == 'predict'
    assert cell.traffic['in_flight'] == 1
    assert all(len(v) == 2 for v in cell.traffic['volumes'])
    assert manifest.spacing(cell.traffic) == [0.148, 0.148]
    assert set(cell.limits) == {'worst_flip_logit', 'flip_share'}
    assert {m['name'] for m in cell.end_to_end} == {
        'scans_per_s', 'scan_p50_s', 'setup_s'}
    assert {m['name'] for m in cell.per_layer} == SOLO_2D | set(NEW) | {
        'engine.pages_wait_ms'}
    for m in bench['per_layer']:
        if m['name'] in NEW:
            assert m['workloads'] == ['ct-exact.solo', CELL]


@pytest.fixture(scope='module')
def xr_root(tmp_path_factory, small_root):
    """The miniature checkout with the mix's radiographs at a small size."""
    root = str(tmp_path_factory.mktemp('xray') / 'root')
    shutil.copytree(small_root, root, ignore=shutil.ignore_patterns('build'))
    path = os.path.join(root, 'benchmark', 'traffic', 'xr-solo.json')
    with open(path) as f:
        mix = json.load(f)
    mix['volumes'] = SMALL_2D
    with open(path, 'w') as f:
        json.dump(mix, f)
    return root


@pytest.mark.parametrize('trace_', [0, 1])
def test_the_cell_runs_at_a_small_size(run_small, xr_root, trace_):
    code, line, err = run_small(CELL, seed=2 ** 31 + 17, trace=trace_,
                                root=xr_root)
    assert code == 0, err
    assert line['correct'], line['check']
    assert line['check']['volumes_unchecked']['value'] == 0
    want = ON_THE_CPU if trace_ else {'scans_per_s', 'scan_p50_s', 'setup_s'}
    assert want <= set(line['metrics']), line['metrics']
    for name in want:
        assert line['metrics'][name]['value'] > 0, name


def _run(window_s=1.0):
    return SimpleNamespace(slice=SimpleNamespace(window_s=window_s,
                                                 scans=[0, 1]))


@pytest.fixture
def recorded():
    """Two scans by hand in the port's recorder, as the radiograph path
    records them: scan 1 fetched alone, scan 2 by a program that carried
    scans 2 and 3. Offsets in ms."""
    trace.enable()
    trace.disable()
    t0 = time.perf_counter_ns()
    ids = iter(range(1, 100))

    def add(name, start, end, parent=None, scans=(1,), nbytes=0):
        sid = next(ids)
        trace.RECORDER.add(sid, name, parent, scans, t0 + start * MS,
                           t0 + end * MS, nbytes)
        return sid

    add('engine.fetch', 0, 20, nbytes=30_000_000)
    add('engine.fetch', 100, 130, scans=(2, 3), nbytes=50_000_000)
    for scan, at in ((1, 30), (2, 140)):
        fin = add('api.finish_predict', at, at + 90, scans=(scan,))
        add('engine.wait', at, at + 5, fin, scans=(scan,))
        add('engine.unpack', at + 5, at + 45, fin, scans=(scan,))
        add('engine.place', at + 45, at + 60, fin, scans=(scan,))
        asm = add('api.assemble', at + 60, at + 90, fin, scans=(scan,))
        add('api.split', at + 62, at + 82 + scan, asm, scans=(scan,))
    yield
    trace.enable()
    trace.disable()


@pytest.mark.parametrize('metric,want', [
    ('api.split_ms', (21 + 22) / 2),
    ('engine.unpack_ms', 40 + 15),
    # 80 MB over the 1 + 2 scans the fetches carried
    ('engine.wire_mb', 80 / 3),
])
def test_reader_on_hand_made_spans(recorded, metric, want):
    assert manifest.reader(ROOT, metric)(_run()) == pytest.approx(want)


@pytest.mark.parametrize('metric', NEW)
def test_reader_without_its_spans(recorded, monkeypatch, metric):
    read = manifest.reader(ROOT, metric)
    assert read(SimpleNamespace(slice=None)) is None
    assert read(SimpleNamespace(slice=SimpleNamespace(window_s=1.0,
                                                      scans=[]))) is None
    monkeypatch.delattr(trace, 'collect')   # a port that records no spans
    assert read(_run()) is None


@pytest.mark.parametrize('metric,span', [
    ('api.split_ms', 'api.split'), ('engine.unpack_ms', 'engine.unpack'),
    ('engine.wire_mb', 'engine.fetch')])
def test_reader_without_its_span_or_count(metric, span):
    """A slice whose port records every other span, or fetch spans without
    a byte count (the spans of a port from before the count), reads None."""
    trace.enable()
    trace.disable()
    t0 = time.perf_counter_ns()
    for i, name in enumerate(('engine.fetch', 'engine.unpack',
                              'engine.place', 'api.split',
                              'api.finish_predict')):
        if name != span:
            trace.RECORDER.add(i + 1, name, None, (1,), t0 + i * MS,
                               t0 + (i + 1) * MS)
    try:
        assert manifest.reader(ROOT, metric)(_run()) is None
    finally:
        trace.enable()
        trace.disable()


def test_wire_reader_on_spans_of_a_port_without_the_count(monkeypatch):
    """Spans without the ``nbytes`` field read None."""
    from collections import namedtuple
    old = namedtuple('Span', 'id name parent scans start_ns end_ns')
    got = [old(1, 'engine.fetch', None, (1,), 0, 10 * MS),
           old(2, 'api.finish_predict', None, (1,), 10 * MS, 20 * MS)]
    monkeypatch.setattr(trace, 'collect', lambda: got)
    assert manifest.reader(ROOT, 'engine.wire_mb')(_run()) is None
    assert manifest.reader(ROOT, 'engine.unpack_ms')(_run()) is None


@pytest.mark.requires_cuda
@pytest.mark.parametrize('trace_', [0, 1])
def test_the_cell_runs_on_the_card(cuda, trace_):
    out = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', CELL,
         '--seed', str(2 ** 31 + 77), '--seconds', '2', '--trace',
         str(trace_)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line['correct'] and line['failed'] == 0, line['check']
    assert line['device']['platform'] == 'gpu'
    if trace_:
        assert 0 < line['metrics']['fused_block_roofline']['value'] <= 100
        for name in NEW:
            assert line['metrics'][name]['value'] > 0, name
    else:
        assert line['metrics']['scan_p50_s']['value'] > 0
