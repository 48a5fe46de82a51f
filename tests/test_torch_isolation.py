"""The PyTorch port stands alone: no module of it, and not chip_smoke.py,
imports jax, the reference package ``totalsegmentator2d_tpu``, Pillow,
optax or orbax (the card's machine has none of them).

Checked twice: statically (every import statement in the sources), and at
run time in a fresh interpreter whose import system refuses ``jax``,
``jaxlib``, ``totalsegmentator2d_tpu[.*]`` (but not the port, whose name
starts with the same letters), ``requests`` (the port downloads with
urllib), ``PIL``, ``optax`` and ``orbax``: every port module imports (the
training package, eval, models.export and parallel/ among them),
chip_smoke.py
imports, a small predict runs on the CPU, a JPEG Lossless DICOM series and
a zipped series read through the native codecs, and a PNG reads through the
port's own decoder. The native host library the port loads is its
own, built into ``totalsegmentator2d_tpu_torch/build/``, never the
reference package's ``_native/libts2dio.so``: the child records every file
it opens and every library it loads (audit hooks), and none lies under the
reference package's ``_native/``. The rank processes of
tests/test_torch_parallel*.py install the same refusals. The port's parity
tool, tools/torch_parity.py, is held to the same: statically, and by its
offline mode run under the refusals; so are the ingest fuzzer,
tools/torch_fuzz_ingest.py, and the serving soak, tools/torch_soak_serve.py,
each run small under them."""

import ast
import os
import subprocess
import sys

import pytest

from tests.model_fixtures import build_group_set
from tests.synth_assets import asset_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, 'totalsegmentator2d_tpu_torch')


#: the port's tools: the parity harness, the ingest fuzzer, the soak
HARNESSES = ('torch_parity.py', 'torch_fuzz_ingest.py', 'torch_soak_serve.py')

_REFUSED = ('jax', 'jaxlib', 'totalsegmentator2d_tpu', 'PIL', 'optax',
            'orbax')


def _blocked(name: str) -> bool:
    return name.split('.')[0] in _REFUSED


def _sources():
    for dirpath, _, files in os.walk(PORT):
        for fn in files:
            if fn.endswith('.py'):
                yield os.path.join(dirpath, fn)
    yield os.path.join(REPO, 'chip_smoke.py')
    for tool in HARNESSES:
        yield os.path.join(REPO, 'tools', tool)


@pytest.mark.parametrize('name,blocked', [
    ('jax', True), ('jax.numpy', True), ('jaxlib', True),
    ('totalsegmentator2d_tpu', True), ('totalsegmentator2d_tpu.io', True),
    ('totalsegmentator2d_tpu_torch', False),
    ('totalsegmentator2d_tpu_torch.api', False), ('numpy', False),
    ('PIL.Image', True), ('optax', True), ('orbax.checkpoint', True),
    ('totalsegmentator2d_tpu_torch.training.train', False)])
def test_blocker_matches_exact_names(name, blocked):
    assert _blocked(name) is blocked


def test_no_import_statement_reaches_jax():
    scanned = {os.path.relpath(p, PORT) for p in _sources()}
    assert {'parallel/__init__.py', 'parallel/distributed.py',
            'parallel/mesh.py', 'parallel/sharding.py', 'parallel/ensemble.py',
            'parallel/collectives.py', 'parallel/dryrun.py',
            'training/sharded.py',
            *(os.path.join('..', 'tools', t) for t in HARNESSES)} <= scanned
    found = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            found += [(os.path.relpath(path, REPO), n) for n in names
                      if _blocked(n)]
    assert not found, found


_CHILD = r'''
import importlib, pkgutil, sys

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'totalsegmentator2d_tpu',
                                  'requests', 'PIL', 'optax', 'orbax'):
            raise ImportError(f'blocked import: {name}')
        return None

sys.meta_path.insert(0, Blocker())
touched = []

def audit(event, args):
    if event in ('open', 'ctypes.dlopen') and args and args[0]:
        touched.append(str(args[0]))

sys.addaudithook(audit)
import torch
import totalsegmentator2d_tpu_torch as port
mods = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + '.')]
for m in mods:
    importlib.import_module(m)
assert port.__name__ + '.parallel.distributed' in mods, mods
available = torch.cuda.is_available
torch.cuda.is_available = lambda: True   # lets chip_smoke import its modules
import chip_smoke  # noqa: F401
torch.cuda.is_available = available
from totalsegmentator2d_tpu_torch.api import TS2D
with TS2D(key='ts2d-v9-iso', use_remote=False, local=sys.argv[1],
          device='cpu') as tool:
    seg = tool.predict(sys.argv[2]).get_segmentation()
assert seg.ncomponents == 5, seg
import numpy as np
from totalsegmentator2d_tpu_torch.io import read_image
assert np.array_equal(read_image(sys.argv[3]).array,
                      read_image(sys.argv[4]).array)
import totalsegmentator2d_tpu_torch.eval  # noqa: F401
import totalsegmentator2d_tpu_torch.models.export  # noqa: F401
import totalsegmentator2d_tpu_torch.training  # noqa: F401
png = read_image(sys.argv[5])
assert png.array.shape == (3, 4, 3) and png.array.dtype == np.uint8, png
leaked = [m for m in sys.modules if m.split('.')[0] in (
    'jax', 'jaxlib', 'totalsegmentator2d_tpu', 'requests', 'PIL', 'optax',
    'orbax')]
assert not leaked, leaked
import os
from totalsegmentator2d_tpu_torch.io import native
from totalsegmentator2d_tpu_torch.ops.cuda.build import BUILD_DIR
assert native.native_available()
with open('/proc/self/maps') as f:
    libs = {line.split()[-1] for line in f if '.so' in line}
assert not [p for p in libs if 'libts2dio' in p and not p.startswith(
    os.path.join(BUILD_DIR, 'libts2dio-'))], libs
assert [p for p in libs if p.startswith(os.path.join(BUILD_DIR, 'libts2dio-'))], libs
assert any('libts2dio-' in p for p in touched), touched
reference = os.path.join(os.path.dirname(BUILD_DIR), '..',
                         'totalsegmentator2d_tpu', '_native')
assert not [p for p in touched if os.path.realpath(p).startswith(
    os.path.realpath(reference))], touched
print('OK', len(mods))
'''


def test_port_runs_with_jax_blocked(tmp_path):
    import zipfile

    import numpy as np

    from tests.test_017_dicom import _JPLL_SV1, write_slice
    root = str(tmp_path / 'zoo')
    build_group_set(root, model='ts2d-v9-iso', spacing=(1.2, 2.0))
    series = tmp_path / 'series'
    series.mkdir()
    vol = np.random.default_rng(0).integers(-900, 1500, (4, 10, 12)).astype(
        np.int16)
    for i in range(4):
        write_slice(str(series / f's{i}.dcm'), vol[i], position=(0, 0, 2.5 * i),
                    instance=i + 1, transfer_syntax=_JPLL_SV1)
    zp = tmp_path / 'series.zip'
    with zipfile.ZipFile(zp, 'w') as zf:
        for f in sorted(series.iterdir()):
            zf.write(f, f'series/{f.name}')
    from totalsegmentator2d_tpu_torch.io import encode_png
    png = tmp_path / 'x.png'
    png.write_bytes(encode_png(np.arange(36, dtype=np.uint8).reshape(3, 4, 3)))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, '-c', _CHILD, root, asset_path('sample_s0521.nrrd'),
         str(series), str(zp), str(png)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1].startswith('OK')


_PARITY_CHILD = r'''
import importlib.util, json, sys

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'totalsegmentator2d_tpu',
                                  'requests', 'PIL', 'optax', 'orbax'):
            raise ImportError(f'blocked import: {name}')
        return None

sys.meta_path.insert(0, Blocker())
import torch
torch.set_num_threads(2)   # it runs beside the other test workers
spec = importlib.util.spec_from_file_location('torch_parity', sys.argv[1])
tool = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tool)
rc = tool.main(['--configs', 'multilabel', '--assets', 'sample_s0521',
                '--out', sys.argv[2],
                '--checks', ','.join(c for c in tool.OFFLINE
                                     if c != 'full-chain-bench-arch')])
leaked = [m for m in sys.modules if m.split('.')[0] in (
    'jax', 'jaxlib', 'totalsegmentator2d_tpu', 'requests', 'PIL', 'optax',
    'orbax')]
assert not leaked, leaked
sys.exit(rc)
'''


def test_parity_tool_runs_with_jax_blocked(tmp_path):
    """tools/torch_parity.py's offline mode at its smallest configuration
    (the multilabel one and the smallest bundled asset, the 3D CT; every
    check but the 6-stage architecture's) in a fresh interpreter that
    refuses the reference package and jax: every check holds, and nothing
    of theirs was imported."""
    import json
    out = tmp_path / 'report.json'
    proc = subprocess.run(
        [sys.executable, '-c', _PARITY_CHILD,
         os.path.join(REPO, 'tools', 'torch_parity.py'), str(out)],
        cwd=str(tmp_path), env=dict(os.environ), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(out.read_text())
    assert report['ok'] and report['mode'] == 'offline'
    assert set(report['checks']) == {
        'gaussian-window', 'crop-roundtrip', 'volume-crop', 'resample-order',
        'fused-vs-permodel', 'full-chain', 'full-chain-batched',
        'full-chain-quantized'}
    chain = report['checks']['full-chain']
    assert set(chain['configs']) == {'multilabel', 'multi-tile',
                                     'no-mirroring'}
    assert all(e['max_abs_logit_err'] < 5e-3 for e in chain['configs'].values())
    assert set(chain['assets']) == {'sample_s0521'}
    assert set(report['checks']['fused-vs-permodel']['agreement']) == {
        'sample_s0521'}


_HARNESS_CHILD = r'''
import importlib.util, sys

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'totalsegmentator2d_tpu',
                                  'requests', 'PIL', 'optax', 'orbax'):
            raise ImportError(f'blocked import: {name}')
        return None

sys.meta_path.insert(0, Blocker())
import torch
torch.set_num_threads(2)   # it runs beside the other test workers

def tool(name):
    spec = importlib.util.spec_from_file_location(name, sys.argv[1] + name
                                                  + '.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

fuzz = tool('torch_fuzz_ingest')
report = fuzz.run_leg('on', trials=2, step=10 ** 6,
                      names={'x.png', 'strip-lzw.tif', 'jll', 'slice-rle.dcm'})
assert not report['leaks'] and not report['bases'], report
assert len(report['targets']) == 4, report['targets']
rc = tool('torch_soak_serve').main(['--device', 'cpu', '--minutes', '0.03'])
leaked = [m for m in sys.modules if m.split('.')[0] in (
    'jax', 'jaxlib', 'totalsegmentator2d_tpu', 'requests', 'PIL', 'optax',
    'orbax')]
assert not leaked, leaked
sys.exit(rc)
'''


def test_harness_tools_run_with_jax_blocked(tmp_path):
    """tools/torch_fuzz_ingest.py (4 targets, native on, in the process)
    and tools/torch_soak_serve.py (1.8 s on the CPU) in a fresh interpreter
    that refuses the reference package, jax and Pillow: both run, and
    nothing of theirs was imported."""
    proc = subprocess.run(
        [sys.executable, '-c', _HARNESS_CHILD,
         os.path.join(REPO, 'tools', '')],
        cwd=str(tmp_path), env=dict(os.environ), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == 'SOAK PASS'


def test_rank_processes_refuse_the_same_imports():
    from tests.test_torch_parallel import _REFUSED as rank_refused
    assert set(_REFUSED) <= set(rank_refused)


def test_native_library_is_the_ports_own():
    """The bindings build and load ``csrc/ts2dio.cc`` of the port; no
    source of the port names the reference package's library."""
    from totalsegmentator2d_tpu_torch.io import native
    from totalsegmentator2d_tpu_torch.ops.cuda.build import BUILD_DIR
    assert native.native_available()
    assert native._load()._name.startswith(os.path.join(BUILD_DIR, 'libts2dio-'))
    assert BUILD_DIR == os.path.join(PORT, 'build')
    for path in _sources():
        with open(path) as f:
            text = f.read()
        assert 'libts2dio.so' not in text and "'_native'" not in text, path


def _inference_imports(module: str):
    """The modules of ``inference/`` that ``inference/<module>.py`` imports
    (relative imports, anywhere in the file)."""
    path = os.path.join(PORT, 'inference', module + '.py')
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    got = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            got |= ({node.module} if node.module
                    else {a.name for a in node.names})
        elif isinstance(node, ast.ImportFrom) and (node.module or '') \
                .startswith('totalsegmentator2d_tpu_torch.inference'):
            got.add(node.module)
    return got


def test_the_wire_and_the_batcher_import_one_way():
    """``inference/wire.py`` imports nothing of ``inference/``, and the
    batcher does not import the engine that builds it."""
    assert _inference_imports('wire') == set()
    batching = _inference_imports('batching')
    assert 'wire' in batching
    assert not any('ensemble_engine' in m for m in batching), batching
