"""The harness on the card: one short run of a cell, and its traced run.
Skips without a CUDA card (run on the chip: ``python -m pytest
benchmark/test_bench_card.py -q``)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.requires_cuda


@pytest.mark.parametrize('trace', [0, 1])
def test_a_cell_runs_on_the_card(cuda, trace):
    out = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', 'ct-fast.solo',
         '--seed', str(2 ** 31 + 99), '--seconds', '2', '--trace', str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line['correct'] and line['failed'] == 0, line['check']
    assert line['device']['platform'] == 'gpu'
    if trace:
        assert 0 < line['device']['busy_s'] < line['device']['window_s']
        assert 0 < line['metrics']['fused_block_roofline']['value'] <= 100
    else:
        assert line['metrics']['scans_per_s']['value'] > 0
