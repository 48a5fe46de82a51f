"""Nothing the benchmark runs holds the JAX stack or the JAX package,
compared by whole top-level names; the reference holds nothing of the
port; a checkout without the port fails."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from benchmark import harness

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ('jax', 'jaxlib', 'flax', 'totalsegmentator2d_tpu')


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in list(sys.modules):
        if name.split('.', 1)[0] in BLOCKED:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, 'totalsegmentator2d_tpu_torch_x', sys)
    monkeypatch.setitem(sys.modules, 'jaxtyping', sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, 'totalsegmentator2d_tpu.ops', sys)
    monkeypatch.setitem(sys.modules, 'jaxlib', sys)
    assert harness.forbidden_modules() == ['jaxlib',
                                           'totalsegmentator2d_tpu.ops']


def _python(code: str, cwd=ROOT) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, '-c', textwrap.dedent(code)],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_the_reference_holds_nothing_of_the_port():
    out = _python("""
        import sys
        sys.path.insert(0, '.')
        from benchmark import arith, check, database, phantom, reference
        print([m for m in sys.modules if m.split('.')[0] in (
            'jax', 'jaxlib', 'flax', 'totalsegmentator2d_tpu',
            'totalsegmentator2d_tpu_torch')])
    """)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'


def test_a_run_holds_no_jax(small_root):
    """A whole run in a fresh process: the harness itself refuses to print
    a result when the process holds a blocked module."""
    out = _python(f"""
        import sys, time
        sys.path.insert(0, '.')
        import torch
        torch.set_num_threads(2)
        from benchmark import harness
        code = harness.main(['--workload', 'ct-fast.cohort8', '--seed', '5',
                             '--seconds', '0.5'], time.perf_counter(),
                            {small_root!r}, device='cpu')
        print('blocked', harness.forbidden_modules())
        sys.exit(code)
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == 'blocked []'
    assert json.loads(lines[-2])['correct']


def test_a_checkout_without_the_port_fails(tmp_path, small_root, monkeypatch):
    bare = tmp_path / 'bare'
    os.makedirs(bare)
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), bare)
    shutil.copytree(os.path.join(ROOT, 'benchmark'), bare / 'benchmark',
                    ignore=shutil.ignore_patterns('build', '__pycache__'))
    out = subprocess.run([sys.executable, 'benchmark/run.py', '--workload',
                          'ct-exact.solo', '--seed', '1', '--seconds', '1',
                          '--trace', '0'], cwd=bare, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
    # the harness takes only the checkout's own port
    monkeypatch.setattr(harness, 'CHECKOUT', str(bare))
    cell = harness.manifest.cell(small_root, 'ct-exact.solo')
    with pytest.raises(ImportError):
        harness.open_tool(cell, small_root, harness.torch.device('cpu'))
