"""BENCHMARK.json against the benchmark's contract, every cell resolving its
files by name, a CT cell and a native 2D cell added as files only, and a
mix of two kinds refused."""

import json
import math
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


# every per-layer metric a solo 2D cell reports (the batcher's metrics are
# the cohorts', fused_block_roofline the fast precision's)
SOLO_2D = ['api.dispatch_ms', 'api.project_ms', 'api.finish_host_ms',
           'program.launches_per_scan', 'step_mfu_pct', 'prefilter_roofline',
           'device.idle_pct', 'program.enqueue_ms', 'engine.fetch_host_ms']
# of those, what a CPU run can read (the rest read the card's kernels)
ON_THE_CPU = {'api.dispatch_ms', 'api.project_ms', 'api.finish_host_ms',
              'program.enqueue_ms', 'engine.fetch_host_ms'}


def test_a_2d_cell_added_as_files_only(tmp_path, run_small, small_root,
                                       capsys):
    """A native 2D X-ray configuration (one channel), a mix of two chest
    radiographs at 0.4 mm (a multi-tile one, both cropped to their
    collimation), its limits and its cell: new files and BENCHMARK.json
    entries only. The harness runs it at both trace settings and the
    calibration reads it and its control, every check beside its limit."""
    from benchmark import calibrate
    root = str(tmp_path / 'root')
    shutil.copytree(small_root, root,
                    ignore=shutil.ignore_patterns('build'))
    b = os.path.join(root, 'benchmark')
    before = {os.path.join(dp, f): open(os.path.join(dp, f), 'rb').read()
              for dp, _, fs in os.walk(b) for f in fs}
    cfg = json.load(open(os.path.join(b, 'configs', 'ts2d-v2-exact.json')))
    # heads shifted so that a label covers about a per cent of a radiograph
    # at this small architecture, as -2.2 makes it of a CT's projection
    cfg.update(name='tsxr-exact', channels=['xray'], head_bias_shift=-1.0)
    json.dump(cfg, open(os.path.join(b, 'configs', 'tsxr-exact.json'), 'w'))
    json.dump({'entry': 'predict', 'in_flight': 1, 'spacing_xy': [0.4, 0.4],
               'volumes': [[480, 560], [200, 240]], 'traced_scans': 2},
              open(os.path.join(b, 'traffic', 'xr-pair.json'), 'w'))
    limits = {'worst_flip_logit': 2e-4, 'flip_share': 2e-6}
    json.dump({'limits': limits},
              open(os.path.join(b, 'workloads', 'xr-exact.pair.json'), 'w'))
    m = json.load(open(os.path.join(root, 'BENCHMARK.json')))
    m['configs'].append({'name': 'tsxr-exact', 'source': 's',
                         'file': 'benchmark/configs/tsxr-exact.json',
                         'reduced': [], 'why': 'one channel, native 2D'})
    m['workloads'].append({'name': 'xr-exact.pair', 'config': 'tsxr-exact',
                           'traffic': 'xr-pair', 'chips': 1, 'why': 'w'})
    for p in m['per_layer']:
        if p['name'] in SOLO_2D:
            p['workloads'].append('xr-exact.pair')
    json.dump(m, open(os.path.join(root, 'BENCHMARK.json'), 'w'))

    for trace in (0, 1):
        code, line, err = run_small('xr-exact.pair', trace=trace, root=root)
        assert code == 0, err
        assert line['correct'], line['check']
        assert list(line['check']) == list(limits) + [
            'failed_scans', 'volumes_unchecked']
        assert list(line)[-1] == 'check'
        for name, c in line['check'].items():
            assert math.isfinite(c['value']), name
            assert f"check {name}: {c['value']} (limit {c['limit']})" in err
        assert line['check']['volumes_unchecked']['value'] == 0
        assert 0.005 < line['reference_foreground'] < 0.05
        want = ON_THE_CPU if trace else {'scans_per_s', 'setup_s'}
        assert want <= set(line['metrics']), line['metrics']
        assert all(v['value'] > 0 for v in line['metrics'].values())

    assert calibrate.main(['--workload', 'xr-exact.pair', '--seeds', '1',
                           '--first-seed', str(2 ** 31 + 40),
                           '--seconds', '0.5', '--controls', '1'],
                          root, device='cpu') == 0
    program, control = [json.loads(x) for x in
                        capsys.readouterr().out.strip().splitlines()[-2:]]
    assert program['side'] == 'program' and program['failed'] == 0
    assert control['side'] == 'control-tf32'
    assert all(program[k] <= v for k, v in limits.items()), program
    assert any(control[k] > v for k, v in limits.items()), control
    for path, data in before.items():
        assert open(path, 'rb').read() == data


@pytest.mark.parametrize('mix,key', [
    ({'spacing_xy': [1, 1], 'volumes': [[30, 40], [20, 30, 40]]},
     'volumes'),
    ({'spacing_xyz': [1, 1, 2], 'volumes': [[30, 40]]}, 'spacing_xy'),
    ({'spacing_xy': [1, 1], 'volumes': [[20, 30, 40]]}, 'spacing_xyz'),
    ({'spacing_xy': [1, 1], 'volumes': []}, 'volumes'),
])
def test_a_mix_of_two_kinds_or_without_its_spacing_is_refused(
        tmp_path, small_root, mix, key):
    root = str(tmp_path / 'root')
    shutil.copytree(small_root, root,
                    ignore=shutil.ignore_patterns('build'))
    with open(os.path.join(root, 'benchmark', 'traffic', 'solo.json'),
              'w') as f:
        json.dump(dict(mix, entry='predict', in_flight=1, traced_scans=1), f)
    with pytest.raises(ValueError, match=repr(key)):
        manifest.cell(root, 'ct-exact.solo')


@pytest.mark.parametrize('change,key', [
    ({'network': 'UNetPlusPlus'}, 'network'),
    ({'network': 'ResidualEncoderUNet', 'n_conv_per_stage_decoder': 1},
     'n_blocks_per_stage'),
    ({'network': 'ResidualEncoderUNet', 'n_blocks_per_stage': [1, 3],
      'n_conv_per_stage_decoder': 1}, 'n_blocks_per_stage'),
    ({'network': 'ResidualEncoderUNet', 'n_blocks_per_stage': [1, 3, 4, 6]},
     'n_conv_per_stage_decoder'),
    ({'network': 'ResidualEncoderUNet', 'n_blocks_per_stage': [1, 3, 0, 6],
      'n_conv_per_stage_decoder': 1}, 'n_blocks_per_stage'),
    ({'network': 'ResidualEncoderUNet', 'n_blocks_per_stage': [1, 3, 4, 6],
      'n_conv_per_stage_decoder': 1.5}, 'n_conv_per_stage_decoder'),
    ({'network': 'ResidualEncoderUNet', 'n_blocks_per_stage': [1, 3, 4, 6],
      'n_conv_per_stage_decoder': [1, 1, 1]}, 'n_conv_per_stage_decoder'),
    ({'n_conv_per_stage': 0}, 'n_conv_per_stage'),
])
def test_a_configuration_with_a_fault_in_its_network_is_refused(
        tmp_path, small_root, change, key):
    """An unknown network, a residual one without its blocks a stage, with
    the wrong number of them, without its decoder's convs, or with a count
    that is not one whole number from 1 (the small root's 4 stages)."""
    root = str(tmp_path / 'root')
    shutil.copytree(small_root, root,
                    ignore=shutil.ignore_patterns('build'))
    path = os.path.join(root, 'benchmark', 'configs', 'ts2d-v2-fast.json')
    with open(path) as f:
        cfg = json.load(f)
    with open(path, 'w') as f:
        json.dump(dict(cfg, **change), f)
    with pytest.raises(ValueError, match=repr(key)):
        manifest.cell(root, 'ct-fast.cohort8')

