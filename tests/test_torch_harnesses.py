"""The port's containment harnesses on the CPU: ``tools/torch_fuzz_ingest.py``
(every parser of untrusted input, native library on and off) and
``tools/torch_soak_serve.py`` (the HTTP server under randomized load with
dispatcher crashes), each at a small size.

The fuzzer's base files are also held against the reference package's
readers (Pillow for the rasters): what the tool writes is what the JAX
package reads, so a base the port refuses is the port's fault."""

import importlib.util
import json
import os
import tempfile

import numpy as np
import pytest
import torch

from totalsegmentator2d_tpu import io as jax_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f'ts2d_{name}', os.path.join(REPO, 'tools', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FUZZ = _tool('torch_fuzz_ingest')
SOAK = _tool('torch_soak_serve')
#: the off leg decodes one JPEG 2000 codestream only: the Python path takes
#: over a second a slice
SLOW_OFF = {'j2k-53.dcm', 'j2k-97.dcm', 'j2k-97'}


@pytest.fixture(scope='module', autouse=True)
def _two_threads():
    """The soak runs torch on several threads at once beside the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_fuzz_on_leg_in_process():
    """Every target with the native library, 10 mutations each and a
    truncation every 400 bytes: no leak, every base decodes to what was
    written."""
    report = FUZZ.run_leg('on', trials=10, step=400)
    with tempfile.TemporaryDirectory() as tmp:
        names = [t.name for t in FUZZ.targets(tmp)]
    assert len(names) == 35 and set(report['targets']) == set(names)
    assert not report['leaks'] and not report['bases'], (report['leaks'],
                                                         report['bases'])
    assert all(c['trials'] == 10 for c in report['targets'].values())
    assert sum(c['decoded'] for c in report['targets'].values()) > 100


def test_fuzz_off_leg_in_a_child(capsys):
    """The Python paths (``TS2D_NO_NATIVE=1`` in the tool's child process)
    at 2 mutations a target, one truncation."""
    with tempfile.TemporaryDirectory() as tmp:
        names = [t.name for t in FUZZ.targets(tmp) if t.name not in SLOW_OFF]
    rc = FUZZ.main(['--native', 'off', '--trials', '2', '--truncation-step',
                    '1000000', '--targets', ','.join(names)])
    out = capsys.readouterr().out
    assert rc == 0, out[-3000:]
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary['ok'] and summary['targets'] == len(names)
    assert summary['legs'] == ['off'] and summary['leaked'] == 0
    assert 'j2k-53 [off]: 2 mutations + 1 truncations' in out


def test_fuzz_reports_a_leak_and_a_refused_base(monkeypatch):
    """A TIFF decoder that leaks KeyError (as the port's did for a tiled
    file without TileWidth) is reported on every trial, and its base as
    refused."""
    from totalsegmentator2d_tpu_torch.io import raster

    def leaky(data):
        raise KeyError(322)

    monkeypatch.setattr(raster, '_tiff', leaky)
    report = FUZZ.run_leg('on', trials=5, step=300, names={'tile-lzw.tif'})
    counts = report['targets']['tile-lzw.tif']
    assert counts['leaked'] == counts['trials'] + counts['truncations'] - \
        counts['refused'] > 5
    assert 'KeyError' in report['leaks'][0]
    assert report['bases'] and 'raised KeyError' in report['bases'][0]


def test_fuzz_leg_mismatch_is_found(monkeypatch):
    """Two legs that decode one input differently fail the run."""
    def fake(leg, args, names):
        return {'targets': {'x.png': {'trials': 1, 'truncations': 0,
                                      'decoded': 1, 'refused': 0,
                                      'leaked': 0, 'seconds': 0.0}},
                'leaks': [], 'bases': [],
                'digests': {'x.png': {'m0': leg}}}

    monkeypatch.setattr(FUZZ, '_child_leg', fake)
    assert FUZZ.main(['--trials', '1']) == 1


@pytest.mark.parametrize('name', [
    'a.nrrd', 'b.nrrd', 'c.nii', 'd.nii.gz', 'e.mha', 'f.mha',
    'slice-explicit.dcm', 'slice-implicit.dcm', 'slice-rle.dcm', 'x.png', 'x8.bmp', 'x24.bmp', 'strip-raw.tif',
    'tile-raw.tif', 'strip-lzw.tif', 'tile-lzw.tif', 'strip-deflate.tif',
    'tile-deflate.tif', 'strip-packbits.tif', 'tile-packbits.tif'])
def test_fuzz_bases_read_equal_in_the_reference(tmp_path, name):
    """The tool's own writers (PackBits, LZW and the rest) against the
    reference package's readers: the JAX package reads each base file to
    the array it was written from, as the port does."""
    from totalsegmentator2d_tpu_torch import io as port_io
    (t,) = [t for t in FUZZ.targets(str(tmp_path)) if t.name == name]
    p = tmp_path / ('base' + name[name.index('.'):])
    p.write_bytes(t.base)
    ref = jax_io.read_image(str(p)).array
    ours = port_io.read_image(str(p)).array
    np.testing.assert_array_equal(ref, t.expect)
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)


def test_soak_with_chaos_on_the_cpu(tmp_path):
    """Ten seconds of the soak on the CPU around a 2-group, 4-stage, 64^2
    set, dispatcher crashes in the middle third (half the dispatches there):
    every request answered as expected, the crashes counted as injected,
    the server serving again after them."""
    arch = SOAK.ARCHS['cpu']
    SOAK.write_database(str(tmp_path), 'ts2d-v9-soak', arch, seed=100,
                        precision='exact')
    from totalsegmentator2d_tpu_torch.io import write_image
    payload = str(tmp_path / 'phantom.nrrd')
    shape, spacing = SOAK.PHANTOMS['cpu']
    write_image(SOAK.torso_ct(shape, spacing, seed=7), payload, compress=False)
    res = SOAK.soak(str(tmp_path), 'ts2d-v9-soak', payload, 10 / 60, 0.5,
                    'cpu', 'exact',
                    SOAK.fused_per_forward(arch) * len(arch['groups']))
    assert res['ok'], res['errors']
    assert res['injected'] >= 1 and res['crashes_counted'] == res['injected']
    st = res['statuses']
    assert st.get('predict:500-chaos', 0) >= 1
    assert res['predict_200_by_third'][2] >= 1
    for kind in ('corrupt:400', 'oversized:413', 'unauthorized:401'):
        assert st.get(kind, 0) >= 1, st
    assert res['launches'] == {'bspline_prefilter': 0,
                               'fused_norm_act_conv': 0}   # plain on the CPU
    assert res['programs'] >= 2   # the warm-up's solo program and more


def test_soak_refuses_a_missing_card(monkeypatch):
    """The soak's device is the card: without one it stops and names the
    CPU flag, and never falls back."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit, match='--device cpu'):
        SOAK.main(['--minutes', '0.01'])


def test_fused_launch_count_matches_the_kernel_route():
    """One fast flagship forward runs the fused block 16 times (80 per
    program over 5 groups, chip_smoke phases 3 and 6)."""
    assert SOAK.fused_per_forward(SOAK.ARCHS['cuda']) == 16
    assert SOAK.fused_per_forward(SOAK.ARCHS['cpu']) == 10
