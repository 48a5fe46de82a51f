"""The PyTorch port's serving engines against the reference package's and
against each other, on the CPU: the synthetic two-group database at plan
spacing (1.2, 2.0) (so the prefilter runs), the same seeded inputs.

- the micro-batched ensemble (``auto_batch=4``, four concurrent requests
  in one program) against the reference's micro-batched ensemble: masks
  agree >= 99.9% exact, >= 99% fast (the bars of tests/test_torch_engine.py);
- the port's batched program against its own solo program: >= 99.9%
  (other conv batch sizes and one-pass norm statistics flip only
  borderline pixels);
- the int16 wire and the compact wire give the solo program's masks bit
  for bit; requests of other shapes or wires never share a program;
- ``TS2D.predict_async`` / ``finish_predict``, the CLI's pipelined
  directory mode, and the thread-safety of the exact-numerics settings.

Measured agreements are written beside the assertions."""

import os
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import asset_path
from tests.model_fixtures import build_group_set
from totalsegmentator2d_tpu.inference import EnsembleEngine as JaxEngine
from totalsegmentator2d_tpu.inference import Zoo as JaxZoo
from totalsegmentator2d_tpu_torch.api import TS2D
from totalsegmentator2d_tpu_torch.cli import ts2d_entry_point
from totalsegmentator2d_tpu_torch.inference import EnsembleEngine, Zoo
from totalsegmentator2d_tpu_torch.inference.wire import (DeviceResult,
                                                         _wire_pack,
                                                         wire_detect)
from totalsegmentator2d_tpu_torch.io import read_image
from totalsegmentator2d_tpu_torch.utils import device as D

KEY = 'ts2d-v9-test'
SPACING = (1.0, 2.6)
LINGER_MS = 60_000.0  # long enough that the four requests ride one program


@pytest.fixture(scope='module', autouse=True)
def _two_threads():
    """Two intra-op threads for this module: its tests run torch on several
    threads at once (request threads, the dispatcher) beside the other
    test workers, and a full-width thread pool per thread oversubscribes
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('zoo'))
    build_group_set(root, model=KEY, spacing=(1.2, 2.0))
    return root


@pytest.fixture(scope='module')
def models(root):
    """(specs, params) of the port and of the reference package."""
    zoo, jzoo = Zoo(local=root), JaxZoo(remote=False, local=root)
    port = [zoo.load(i) for i in zoo.resolve(KEY, unique_model=True)]
    ref = [jzoo.load(i) for i in jzoo.resolve(KEY, unique_model=True)]
    return (([m.spec for m in port], [m.load_fold_params() for m in port]),
            ([m.spec for m in ref], [m.load_fold_params() for m in ref]))


def _inputs(n, shape=(90, 60), seed=0, integral=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        arr = np.zeros(shape + (2,), np.float32)
        arr[3:-3, 3:-3] = rng.standard_normal(
            (shape[0] - 6, shape[1] - 6, 2)) * 50 + 100
        out.append(np.round(arr) if integral else arr)
    return out


def _port(models, fast=False, **kw):
    specs, params = models[0]
    return EnsembleEngine(specs, params, device='cpu',
                          compute_dtype=torch.bfloat16 if fast else None, **kw)


def _batched(engine, arrs):
    """arrs through the engine's micro-batcher, each key's requests in one
    program (a long linger), then back to dispatching at once."""
    engine.set_batch_linger(LINGER_MS)
    try:
        handles = [engine.predict_array_async(a, SPACING) for a in arrs]
        return [engine.finish_array(h) for h in handles]
    finally:
        engine.set_batch_linger(0.0)


def _solo(engine, program, meta, payload, arr):
    """finish_array of one solo program run on a whole (uncropped) input."""
    result = DeviceResult(program(payload, None), meta.get('compact'))
    return engine.finish_array((result, None, ((0, arr.shape[0]),
                                               (0, arr.shape[1])),
                                arr.shape[:2]))


@pytest.mark.parametrize('precision', ['exact', 'fast'])
def test_batched_engine_matches_reference(models, precision):
    """Four concurrent requests through the port's and the reference's
    micro-batched ensembles (one 4-scan program each). Measured agreement
    on the CPU: 1.0 exact; fast 0.998333-0.998852 per scan."""
    fast = precision == 'fast'
    specs, params = models[1]
    ref_engine = JaxEngine(specs, params, auto_batch=4,
                           compute_dtype=jnp.bfloat16 if fast else None)
    port = _port(models, fast, auto_batch=4)
    try:
        arrs = _inputs(4)
        ref = _batched(ref_engine, arrs)
        out = _batched(port, arrs)
        for eng in (ref_engine, port):
            assert eng._batcher.stats()['batch_occupancy'] == [0, 0, 0, 1]
    finally:
        ref_engine.close()
        port.close()
    for a, b in zip(out, ref):
        assert a.shape == b.shape == (90, 60, 5) and a.dtype == np.uint8
        agree = float((a == b).mean())
        assert agree >= (0.99 if fast else 0.999), f'mask agreement {agree}'
        assert 0.0 < a.mean() < 1.0


@pytest.mark.parametrize('precision', ['exact', 'fast'])
def test_batched_program_matches_solo(models, precision):
    """The port's batched program against its own solo program. Measured
    agreement on the CPU: 1.0 exact; fast 0.999296-1.0 per scan."""
    fast = precision == 'fast'
    solo = _port(models, fast)
    batched = _port(models, fast, auto_batch=4)
    try:
        arrs = _inputs(4, seed=1)
        out = _batched(batched, arrs)
        for a, b in zip(out, (solo.predict_array(x, SPACING) for x in arrs)):
            agree = float((a == b).mean())
            assert agree >= 0.999, f'mask agreement {agree}'
    finally:
        batched.close()
        solo.close()


def test_batched_program_takes_one_pass_statistics(models, monkeypatch):
    """The solo program keeps two-pass InstanceNorm statistics, the batched
    program runs under stats_override('1pass') (on the dispatcher's
    thread); TS2D_STATS forces one form everywhere."""
    import totalsegmentator2d_tpu_torch.models.unet as unet
    monkeypatch.delenv('TS2D_STATS', raising=False)
    calls, orig = [], unet._one_pass_stats

    def spy():
        calls.append(orig())
        return calls[-1]

    monkeypatch.setattr(unet, '_one_pass_stats', spy)
    engine = _port(models, auto_batch=2)
    try:
        arrs = _inputs(2, seed=2)
        engine.predict_array(arrs[0], SPACING)
        assert calls and not any(calls)
        calls.clear()
        _batched(engine, arrs)
        assert calls and all(calls)
        calls.clear()
        monkeypatch.setenv('TS2D_STATS', '1pass')
        engine.predict_array(arrs[0], SPACING)
        assert calls and all(calls)
        monkeypatch.setenv('TS2D_STATS', 'onepass')
        with pytest.raises(ValueError, match='TS2D_STATS'):
            orig()
    finally:
        engine.close()
    with pytest.raises(ValueError, match='stats_override'):
        with unet.stats_override('fast'):
            pass


@pytest.mark.parametrize('precision', ['exact', 'fast'])
def test_int16_wire_gives_the_float_wire_masks(models, precision):
    engine = _port(models, precision == 'fast')
    try:
        arr = _inputs(1, integral=True)[0][3:-3, 3:-3]
        arr[..., 1] += 0.25  # a fractional second channel, as the CT's AIP
        wire = wire_detect(arr)
        assert wire == (True, False)
        plain, meta_p = engine._program(arr.shape[:2], SPACING)
        wired, meta_w = engine._program(arr.shape[:2], SPACING, wire)
        assert wired is not plain
        ref = _solo(engine, plain, meta_p, arr, arr)
        np.testing.assert_array_equal(
            _solo(engine, wired, meta_w, _wire_pack(arr, wire), arr), ref)
        # predict_array detects the wire itself
        np.testing.assert_array_equal(engine.predict_array(arr, SPACING),
                                      ref)
        assert 0.0 < ref.mean() < 1.0
    finally:
        engine.close()


def test_compact_wire_is_bit_identical_to_plain_wire(models, monkeypatch):
    compact = _port(models, compact_wire=True)
    plain = _port(models, compact_wire=False)
    try:
        for arr in _inputs(3, seed=3) + [np.zeros((40, 30, 2), np.float32)]:
            np.testing.assert_array_equal(compact.predict_array(arr, SPACING),
                                          plain.predict_array(arr, SPACING))
        monkeypatch.setenv('TS2D_COMPACT', '0')
        assert _port(models).compact_wire is False
        monkeypatch.delenv('TS2D_COMPACT')
        assert _port(models).compact_wire is True
    finally:
        compact.close()
        plain.close()


def test_mixed_shapes_and_wires_never_co_batch(models):
    """Two requests of each of two shapes, then two of each of two wires:
    each key rides a program of its own (four 2-scan programs), and every
    result is that scan's solo result."""
    solo = _port(models)
    engine = _port(models, auto_batch=2)
    try:
        a = _inputs(2, (90, 60), seed=4)
        b = _inputs(2, (70, 64), seed=5)
        c = _inputs(2, (90, 60), seed=6, integral=True)
        arrs = [a[0], b[0], c[0], a[1], b[1], c[1]]
        assert len({wire_detect(x[3:-3, 3:-3]) for x in arrs}) == 2
        out = _batched(engine, arrs)
        assert engine._batcher.stats()['batch_occupancy'] == [0, 3]
        for x, y in zip(arrs, out):
            assert float((y == solo.predict_array(x, SPACING)).mean()) >= 0.999
    finally:
        engine.close()
        solo.close()


def test_warmup_builds_the_serving_and_batched_programs(models):
    engine = _port(models, auto_batch=2)
    try:
        engine.warmup((90, 60), SPACING, wire=(True, False))
        keys = set(engine._cache)
        assert ((90, 60), SPACING, (True, False)) in keys
        # the last flag: no pad_quantum (the bucket programs' own key)
        assert ('batch', 2, (90, 60), SPACING, False, (True, False),
                False) in keys
        with pytest.raises(ValueError, match='channel flags'):
            engine.warmup((90, 60), SPACING, wire=(True,))
    finally:
        engine.close()
    with pytest.raises(RuntimeError, match='auto_batch'):
        _port(models).set_batch_linger(5.0)


@pytest.mark.parametrize('option', ['pad_quantum', 'tile_mesh'])
def test_later_slices_raise(models, option):
    """The options of later slices check what they are given: tile_mesh
    and the cohort programs' mesh take a DeviceMesh (the sharded programs:
    tests/test_torch_parallel*.py), pad_quantum a quantum of 1 or more."""
    if option == 'tile_mesh':
        with pytest.raises(TypeError, match='DeviceMesh'):
            _port(models, tile_mesh=32)
        return
    engine = _port(models, pad_quantum=32)
    assert engine.pad_quantum == 32
    with pytest.raises(TypeError, match='DeviceMesh'):
        engine.predict_cohort(np.zeros((1, 8, 4, 8), np.float32), SPACING,
                              ('max', 'mean'), mesh=object())
    with pytest.raises(ValueError, match='pad_quantum'):
        _port(models, pad_quantum=0)


def test_exact_numerics_hold_across_threads():
    """The settings are process-wide: a thread leaving exact_numerics must
    not restore TF32 while another thread, or an engine, still holds it."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        inside, leave = threading.Event(), threading.Event()
        seen = []

        def worker():
            with D.exact_numerics():
                inside.set()
                leave.wait(10)
                seen.append(torch.backends.cuda.matmul.allow_tf32)

        t = threading.Thread(target=worker)
        t.start()
        assert inside.wait(10)
        with D.exact_numerics():
            assert torch.backends.cudnn.deterministic
        # this thread left first: the other still runs exact
        assert torch.backends.cuda.matmul.allow_tf32 is False
        leave.set()
        t.join(10)
        assert seen == [False]
        assert torch.backends.cuda.matmul.allow_tf32 is True
        release = D.hold_exact_numerics()
        with D.exact_numerics():
            pass
        assert torch.backends.cuda.matmul.allow_tf32 is False
        release()
        release()  # idempotent
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.fixture(scope='module')
def tool(root):
    with TS2D(key=KEY, use_remote=False, local=root, device='cpu') as t:
        yield t


def test_predict_async_equals_predict(root):
    path = asset_path('sample_s0521.nrrd')
    with TS2D(key=KEY, use_remote=False, local=root, device='cpu',
              batching=False) as t:
        assert t.supports_async and t._fused._batcher is None
        ref = t.predict(path)
        handles = [t.predict_async(path) for _ in range(3)]
        for h in handles:
            res = t.finish_predict(h)
            np.testing.assert_array_equal(res.get_segmentation().array,
                                          ref.get_segmentation().array)
            assert res.models == ref.models
            assert sorted(res.get_projection()) == ['max', 'mean']
    assert t._fused is None


def test_predict_async_batched_agrees(tool):
    """With batching on (the default) four scans in flight may share one
    program: each agrees with the solo predict. Measured: 1.0."""
    path = asset_path('sample_s0521.nrrd')
    ref = tool.predict(path).get_segmentation().array
    handles = [tool.predict_async(path) for _ in range(4)]
    for h in handles:
        seg = tool.finish_predict(h).get_segmentation().array
        assert seg.shape == ref.shape
        assert float((seg == ref).mean()) >= 0.999
    assert tool._fused._batcher.stats()['batch_scans'] >= 5


def test_close_stops_the_dispatcher(root):
    t = TS2D(key=KEY, use_remote=False, local=root, device='cpu')
    thread = t._fused._batcher._thread
    assert thread.is_alive()
    t.close()
    thread.join(10)
    assert not thread.is_alive() and t._fused is None


def _run_cli(argv, monkeypatch):
    # --no-fetch: the packaged registry, so no test reaches the network
    monkeypatch.setattr(sys, 'argv', ['ts2d-torch', '--no-fetch'] + argv)
    ts2d_entry_point()


def test_cli_directory_mode_matches_sequential(root, tmp_path, monkeypatch):
    import shutil
    src = tmp_path / 'src'
    src.mkdir()
    names = ('sample_s0332', 'sample_s0521', 'sample_s0616')
    for n in names:
        shutil.copy(asset_path(f'{n}.nrrd'), src / f'{n}.nrrd')
    common = ['--model', KEY, '--local', root, '--device', 'cpu', '--silent']
    _run_cli(['-i', str(src), '-o', str(tmp_path / 'dir')] + common,
             monkeypatch)
    for n in names:
        _run_cli(['-i', str(src / f'{n}.nrrd'), '-o', str(tmp_path / 'seq'),
                  '--no-batching'] + common, monkeypatch)
    files = sorted(os.listdir(tmp_path / 'seq'))
    assert files == sorted(os.listdir(tmp_path / 'dir'))
    assert len(files) == 3 * len(names)
    for f in files:
        a = read_image(str(tmp_path / 'dir' / f))
        b = read_image(str(tmp_path / 'seq' / f))
        np.testing.assert_array_equal(a.array, b.array)
        assert a.meta == b.meta and a.spacing == b.spacing


def test_cli_trace_writes_a_profile(root, tmp_path, monkeypatch):
    _run_cli(['-i', asset_path('sample_s0332.nrrd'), '-o',
              str(tmp_path / 'out'), '--model', KEY, '--local', root,
              '--device', 'cpu', '--silent', '--trace',
              str(tmp_path / 'trace')], monkeypatch)
    assert list((tmp_path / 'trace').glob('*.pt.trace.json'))
    assert (tmp_path / 'out' / 'sample_s0332.seg.nrrd').exists()
