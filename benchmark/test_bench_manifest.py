"""BENCHMARK.json against the benchmark's contract, every cell resolving its
files by name, and a cell added as files only."""

import json
import os
import re
import shutil

import pytest

from benchmark import manifest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}


@pytest.fixture(scope='module')
def bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def test_keys_and_names(bench):
    assert set(bench) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert bench['paths'] == ['benchmark']
    assert bench['command'][1] == 'benchmark/run.py'
    assert 1 <= bench['run_seconds'] <= 51
    # a full check of 24 cells fits its 43,200 s
    assert ((2 + 14 * 24) * (bench['run_seconds'] + 60) + 24 * 2 * 90
            + 1200) <= 43200
    names = set()
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        for entry in bench[group]:
            assert NAME.match(entry['name']), entry['name']
            assert entry['name'] not in names
            names.add(entry['name'])
    for m in bench['end_to_end'] + bench['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
        assert m['source'] in SOURCES
    for m in bench['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    assert 'setup_s' in {m['name'] for m in bench['end_to_end']}


def test_every_cell_reports_what_its_metrics_move(bench):
    cells = {w['name'] for w in bench['workloads']}
    e2e = {m['name']: m for m in bench['end_to_end']}
    for w in bench['workloads']:
        assert w['chips'] == 1 and len(w['why']) <= 200
        reported = {n for n, m in e2e.items() if manifest.applies(m, w['name'])}
        assert 'setup_s' in reported and len(reported) >= 2
        assert any(manifest.applies(p, w['name']) for p in bench['per_layer'])
    for p in bench['per_layer']:
        assert set(p['workloads']) <= cells
        for cell in p['workloads']:
            assert manifest.applies(e2e[p['moves']], cell), (p['name'], cell)
        if p['name'].endswith('_roofline') or 'mfu' in p['name'].split('_'):
            assert p['unit'] == '%'


def test_every_cell_resolves_its_files_by_name(bench):
    for w in bench['workloads']:
        cell = manifest.cell(ROOT, w['name'])
        assert cell.config['name'] == w['config']
        assert set(cell.limits) == {'worst_flip_logit', 'flip_share'}
        assert cell.traffic['entry'] in ('predict', 'async')
        for m in cell.per_layer:
            assert callable(manifest.reader(ROOT, m['name']))
    for c in bench['configs']:
        assert os.path.isfile(os.path.join(ROOT, c['file']))
        assert c['reduced'] == []


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        manifest.cell(ROOT, 'no-such-cell')


def test_a_cell_added_as_files_only(tmp_path, bench, run_small, small_root):
    """A new configuration, mix, cell and metric: new files and new
    BENCHMARK.json entries, no existing file edited; the harness finds
    them by name and reports the new metric."""
    root = str(tmp_path / 'root')
    shutil.copytree(small_root, root,
                    ignore=shutil.ignore_patterns('build'))
    b = os.path.join(root, 'benchmark')
    before = {os.path.join(dp, f): open(os.path.join(dp, f), 'rb').read()
              for dp, _, fs in os.walk(b) for f in fs}
    cfg = json.load(open(os.path.join(b, 'configs', 'ts2d-v2-exact.json')))
    cfg['name'] = 'ts2d-v2-exact-2fold'
    cfg['folds'] = [0, 1]
    json.dump(cfg, open(os.path.join(b, 'configs', f"{cfg['name']}.json"),
                        'w'))
    json.dump({'entry': 'async', 'in_flight': 2, 'spacing_xyz': [1, 1, 2],
               'volumes': [[30, 40, 50]], 'traced_scans': 2},
              open(os.path.join(b, 'traffic', 'pair.json'), 'w'))
    json.dump({'limits': {'worst_flip_logit': 1e-3, 'flip_share': 1e-5}},
              open(os.path.join(b, 'workloads', 'ct-exact2.pair.json'), 'w'))
    with open(os.path.join(b, 'metrics', 'window.scans.py'), 'w') as f:
        f.write('def read(run):\n    return float(run.scans)\n')
    m = json.load(open(os.path.join(root, 'BENCHMARK.json')))
    m['configs'].append({'name': cfg['name'], 'source': 's',
                         'file': f"benchmark/configs/{cfg['name']}.json",
                         'reduced': [], 'why': 'two folds'})
    m['workloads'].append({'name': 'ct-exact2.pair', 'config': cfg['name'],
                           'traffic': 'pair', 'chips': 1, 'why': 'w'})
    m['per_layer'].append({'name': 'window.scans', 'unit': 'scans',
                           'better': 'higher', 'source': 'host_clock',
                           'layer': 'benchmark', 'moves': 'scans_per_s',
                           'workloads': ['ct-exact2.pair']})
    json.dump(m, open(os.path.join(root, 'BENCHMARK.json'), 'w'))

    code, line, err = run_small('ct-exact2.pair', trace=1, root=root)
    assert code == 0, err
    assert line['correct'], line['check']
    assert line['metrics']['window.scans']['value'] >= 2
    for path, data in before.items():
        assert open(path, 'rb').read() == data
