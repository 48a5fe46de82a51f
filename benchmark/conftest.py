"""Fixtures of the benchmark's CPU tests: a miniature checkout of the
benchmark (the real BENCHMARK.json's cells, metrics and limits over a small
architecture and small volumes) that the harness runs on the CPU."""

import json
import os
import shutil
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the volumes of the miniature mixes: two sizes, one scan tile each
SMALL_VOLUMES = [[40, 48, 56], [52, 48, 60]]


def _dump(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w') as f:
        json.dump(obj, f)


def make_small_root(dst: str) -> str:
    """A benchmark root whose cells are the real ones at a small size."""
    real = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
    shutil.copytree(os.path.join(ROOT, 'benchmark', 'metrics'),
                    os.path.join(dst, 'benchmark', 'metrics'))
    shutil.copytree(os.path.join(ROOT, 'benchmark', 'workloads'),
                    os.path.join(dst, 'benchmark', 'workloads'))
    for c in real['configs']:
        cfg = json.load(open(os.path.join(ROOT, c['file'])))
        cfg.update(groups={'cardiac': 3, 'ribs': 4},
                   features_per_stage=[8, 16, 32, 32], patch_size=[64, 64])
        _dump(os.path.join(dst, c['file']), cfg)
    for name in {w['traffic'] for w in real['workloads']}:
        mix = json.load(open(os.path.join(ROOT, 'benchmark', 'traffic',
                                          f'{name}.json')))
        one_shape = len({tuple(v) for v in mix['volumes']}) == 1
        volumes = [SMALL_VOLUMES[0]] * 4 if one_shape else SMALL_VOLUMES * (
            2 if mix['in_flight'] > 1 else 1)
        mix.update(volumes=volumes, in_flight=min(mix['in_flight'], 4),
                   traced_scans=2)
        _dump(os.path.join(dst, 'benchmark', 'traffic', f'{name}.json'), mix)
    _dump(os.path.join(dst, 'BENCHMARK.json'), real)
    return dst


@pytest.fixture(scope='session')
def small_root(tmp_path_factory):
    return make_small_root(str(tmp_path_factory.mktemp('bench') / 'root'))


@pytest.fixture
def run_small(small_root, capsys):
    """Run the harness on the CPU; returns (exit code, the result's line
    or None, stderr)."""
    from benchmark import harness

    def run(workload, seed=7, seconds=0.5, trace=0, root=None):
        torch.set_num_threads(2)
        code = harness.main(['--workload', workload, '--seed', str(seed),
                             '--seconds', str(seconds), '--trace', str(trace)],
                            time.perf_counter(), root or small_root,
                            device='cpu')
        out = capsys.readouterr()
        lines = out.out.strip().splitlines()
        return code, json.loads(lines[-1]) if code == 0 else None, out.err
    return run


@pytest.fixture
def cuda():
    """Skips the test without a CUDA card; decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    return torch.device('cuda')
