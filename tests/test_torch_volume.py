"""The PyTorch port's device projection and volume program against the
reference package's, on the CPU (the two-group synthetic database, patch
64, plan spacing 1.5 mm).

- ``project_array`` on tensors against the reference's ``project_array``
  for every mode, on float32 and int16 volumes (rtol 1e-5 / atol 1e-4, the
  tests/test_008_ensemble_engine.py:153 bar); the int16 mean is exact, bit
  for bit the port's host projection;
- ``predict_volume`` against the host projection + ``predict_array``
  (> 0.9999, test_008:152) and against the reference's ``predict_volume``
  (>= 0.999 exact, >= 0.99 fast); async equals sync; a masked-norm plan
  takes the host path; the compact wire is bit-identical;
- every program cache of the fused engine builds a program once, in one
  ``program.build`` span, and every program's masks are fetched in one
  ``engine.fetch`` span that counts the bytes the copies moved.

Measured agreements are written beside the assertions."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.model_fixtures import build_group_set
from totalsegmentator2d_tpu.inference import EnsembleEngine as JaxEngine
from totalsegmentator2d_tpu.inference import Zoo as JaxZoo
from totalsegmentator2d_tpu.ops.projection import \
    project_array as jax_project_array
from totalsegmentator2d_tpu_torch.inference import EnsembleEngine, Zoo, wire
from totalsegmentator2d_tpu_torch.io import MedicalImage
from totalsegmentator2d_tpu_torch.ops.projection import (make_projected_image,
                                                         project,
                                                         project_array,
                                                         project_array_np)
from totalsegmentator2d_tpu_torch.utils import trace

KEY = 'ts2d-v9-test'
SPACING = (1.0, 2.0)  # both projection axes resample
MODES = ('max', 'mean')
ALL_MODES = ('max', 'mip', 'min', 'avg', 'mean', 'median', 'std', 'first',
             'depth')


def _volume(dtype):
    rng = np.random.default_rng(0)
    vol = (rng.standard_normal((9, 12, 7)) * 300 + 20).astype(dtype)
    vol[:, :4] = 0  # leading zeros along every axis for first/depth
    vol[2] = 0
    return vol


@pytest.mark.parametrize('dtype', [np.float32, np.int16])
@pytest.mark.parametrize('mode', ALL_MODES)
def test_project_array_matches_reference(mode, dtype):
    vol = _volume(dtype)
    for axis in range(3):
        out = project_array(torch.from_numpy(vol), mode, axis).numpy()
        ref = np.asarray(jax_project_array(jnp.asarray(vol), mode, axis))
        host = project_array_np(vol, mode, axis)
        assert out.shape == ref.shape == host.shape
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-4)
        if mode in ('max', 'mip', 'min', 'first', 'depth'):
            assert out.dtype == vol.dtype
            np.testing.assert_array_equal(out, host)
        if mode in ('avg', 'mean'):
            assert out.dtype == np.float32
            if dtype == np.int16:  # the exact integer mean
                np.testing.assert_array_equal(out, host)


def test_project_rejects_unknown_modes():
    t = torch.zeros((2, 3, 4))
    with pytest.raises(NotImplementedError):
        project_array(t, 'xr', 1)
    with pytest.raises(ValueError, match='Unsupported'):
        project_array(t, 'sum', 1)


@pytest.mark.parametrize('mode', ['max', 'mean', 'median'])
def test_project_backends_agree(mode):
    vol = _volume(np.int16)
    img = MedicalImage(array=vol, spacing=(0.8, 0.7, 1.5))
    host = project(img, mode, 'coronal')
    dev = project(img, mode, 'coronal', backend='device', device='cpu')
    np.testing.assert_array_equal(dev.array, host.array)
    assert dev.spacing == host.spacing and dev.origin == host.origin
    wrapped = make_projected_image(img, host.array, 1)
    assert wrapped.spacing == host.spacing
    np.testing.assert_array_equal(wrapped.array, host.array)
    with pytest.raises(ValueError, match='backend'):
        project(img, mode, 'coronal', backend='gpu')


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    """(port specs, params), (reference specs, params)."""
    root = str(tmp_path_factory.mktemp('zoo'))
    build_group_set(root, model=KEY, spacing=(1.5, 1.5))
    zoo, jzoo = Zoo(local=root), JaxZoo(remote=False, local=root)
    port = [zoo.load(i) for i in zoo.resolve(KEY, unique_model=True)]
    ref = [jzoo.load(i) for i in jzoo.resolve(KEY, unique_model=True)]
    return (([m.spec for m in port], [m.load_fold_params() for m in port]),
            ([m.spec for m in ref], [m.load_fold_params() for m in ref]))


def _port(models, fast=False, masked=False, **kw):
    specs, params = models[0]
    if masked:
        specs = [dataclasses.replace(s, preprocess=dataclasses.replace(
            s.preprocess, use_mask_for_norm=(True, True))) for s in specs]
    return EnsembleEngine(specs, params, device='cpu',
                          compute_dtype=torch.bfloat16 if fast else None, **kw)


def _ct(dtype=np.float32):
    """A zero-background volume: the (z, x) crop is not the whole volume."""
    rng = np.random.default_rng(1)
    vol = np.zeros((60, 30, 50), dtype)
    vol[10:50, 5:25, 8:40] = rng.standard_normal((40, 20, 32)) * 100 + 50
    return vol


@pytest.mark.parametrize('dtype', [np.float32, np.int16])
def test_volume_matches_host_path(models, dtype):
    """The volume program (crop, upload, projection and 2D program in one)
    against the host projection through predict_array: equal projections,
    masks > 0.9999. Measured on the CPU: 1.0 for both dtypes."""
    engine = _port(models)
    vol = _ct(dtype)
    seg, proj = engine.predict_volume(vol, SPACING, MODES)
    host = np.concatenate([project_array_np(vol, m, 1) for m in MODES],
                          axis=1).transpose(0, 2, 1).astype(np.float32)
    ref = engine.predict_array(host, SPACING)
    assert seg.shape == ref.shape == (60, 50, 5) and proj.shape == (60, 50, 2)
    np.testing.assert_array_equal(proj, host)
    assert float((seg == ref).mean()) > 0.9999
    assert 0.0 < seg.mean() < 1.0


@pytest.mark.parametrize('precision', ['exact', 'fast'])
def test_volume_matches_reference(models, precision):
    """Against the reference's predict_volume. Measured on the CPU: 1.0
    exact; fast 0.999-1.0."""
    fast = precision == 'fast'
    specs, params = models[1]
    ref_engine = JaxEngine(specs, params,
                           compute_dtype=jnp.bfloat16 if fast else None)
    vol = _ct()
    ref_seg, ref_proj = ref_engine.predict_volume(vol, SPACING, MODES)
    seg, proj = _port(models, fast).predict_volume(vol, SPACING, MODES)
    assert seg.shape == ref_seg.shape
    np.testing.assert_allclose(proj, ref_proj, rtol=1e-5, atol=1e-4)
    agree = float((seg == ref_seg).mean())
    assert agree >= (0.99 if fast else 0.999), f'mask agreement {agree}'


def test_predict_volume_async_matches_sync(models):
    engine = _port(models)
    rng = np.random.default_rng(2)
    vol = (rng.standard_normal((40, 20, 30)) * 100).astype(np.float32)
    seg, proj = engine.predict_volume(vol, SPACING, MODES)
    handles = [engine.predict_volume_async(vol, SPACING, MODES)
               for _ in range(2)]
    for h in handles:
        seg_a, proj_a = engine.finish_volume(h)
        np.testing.assert_array_equal(seg_a, seg)
        np.testing.assert_array_equal(proj_a, proj)
    assert len([k for k in engine._cache if k[0] == 'vol']) == 1


def test_masked_norm_plan_takes_host_path(models):
    """A plan with use_mask_for_norm projects on the host (the exact
    hole-filled mask) and runs predict_array; no volume program is built."""
    engine = _port(models, masked=True)
    vol = _ct()
    handle = engine.predict_volume_async(vol, SPACING, MODES)
    assert handle[0] == 'hostproj'
    seg, proj = engine.finish_volume(handle)
    np.testing.assert_array_equal(
        seg, engine.predict_array(engine._host_projection(vol, MODES),
                                  SPACING))
    assert not [k for k in engine._cache if k[0] == 'vol']


def test_volume_compact_wire_is_bit_identical(models):
    vol = _ct()
    a = _port(models, compact_wire=True).predict_volume(vol, SPACING, MODES)
    b = _port(models, compact_wire=False).predict_volume(vol, SPACING, MODES)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_nonzero_range_is_the_bounding_box():
    """The volume's (z, x) crop, found from both ends inward, equals the
    bounding box of the nonzero (z, x) columns."""
    from totalsegmentator2d_tpu_torch.inference.ensemble_engine import \
        _nonzero_range
    rng = np.random.default_rng(5)
    for _ in range(200):
        vol = np.zeros(tuple(rng.integers(1, 12, 3)), np.int16)
        for _ in range(rng.integers(0, 5)):
            vol[tuple(rng.integers(0, n) for n in vol.shape)] = \
                rng.integers(1, 5)
        zs, xs = np.nonzero(np.any(vol != 0, axis=1))
        got = (_nonzero_range(vol, 0), _nonzero_range(vol, 2))
        if zs.size == 0:
            assert got == (None, None)
        else:
            assert got == ((zs.min(), zs.max() + 1), (xs.min(), xs.max() + 1))


@pytest.fixture
def one_thread():
    """One intra-op thread: these programs are small, and beside the other
    test workers a thread pool per process oversubscribes the cores (a
    predict on the caller's thread took a minute so, 0.1 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small_ct(seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((24, 12, 20)) * 100 + 40).astype(np.float32)


#: each program kind of the fused engine's cache: the call that builds it
PROGRAM_KINDS = {
    'solo': lambda e, v: e._program((24, 20), SPACING),
    'bucket': lambda e, v: e._program_bucket((32, 32), SPACING),
    '2d-masked': lambda e, v: e._program_padded((24, 20), SPACING),
    'batch': lambda e, v: e._batched_program(2, (24, 20), SPACING, False),
    'vol': lambda e, v: e.predict_volume(v, SPACING, MODES),
    'cohort': lambda e, v: e.predict_cohort(v[None], SPACING, MODES),
    'cohortpad': lambda e, v: e.predict_cohort_mixed(
        [v], SPACING, MODES, bucket='pad', pad_quantum=16),
}


@pytest.mark.parametrize('kind', list(PROGRAM_KINDS))
def test_each_program_builds_once_in_one_span(models, one_thread, kind):
    """The first call builds the kind's program (and the solo or masked
    program it extends), each build in one ``program.build`` span; the
    second call builds nothing."""
    engine = _port(models)
    vol = _small_ct()

    def call():
        before = set(engine._cache)
        trace.enable()
        try:
            PROGRAM_KINDS[kind](engine, vol)
            spans = [s for s in trace.collect() if s.name == 'program.build']
        finally:
            trace.disable()
        return [k for k in engine._cache if k not in before], spans

    built, spans = call()
    kinds = [k[0] if isinstance(k[0], str) else 'solo' for k in built]
    assert kind in kinds and len(set(kinds)) == len(kinds), kinds
    assert len(spans) == len(built), (kinds, spans)
    assert call() == ([], [])


def _fetch_case(engine, case, vol):
    """Run ``case`` on the engine; returns the number of program results
    it fetched."""
    proj = engine._host_projection(vol, MODES)
    if case in ('solo', 'solo-batcher'):
        for _ in range(2):
            engine.predict_array(proj, SPACING)
        return 2
    if case == 'batched':
        engine.set_batch_linger(60_000.0)
        try:
            handles = [engine.predict_array_async(proj + i, SPACING)
                       for i in range(2)]
            for h in handles:
                engine.finish_array(h)
        finally:
            engine.set_batch_linger(0.0)
        return 1
    if case == 'volume':
        for _ in range(2):
            engine.predict_volume(vol, SPACING, MODES)
        return 2
    if case == 'cohort':
        engine.predict_cohort(np.stack([vol, vol + 1]), SPACING, MODES)
        return 1
    engine.predict_cohort_mixed([vol, vol[:20]], SPACING, MODES,
                                bucket='pad', pad_quantum=16)
    return 1


@pytest.mark.parametrize('compact', [True, False])
@pytest.mark.parametrize('case', ['solo', 'solo-batcher', 'batched',
                                  'volume', 'cohort', 'cohortpad'])
def test_each_fetch_is_one_span_with_its_bytes(models, one_thread,
                                               monkeypatch, case, compact):
    """Each program result is fetched in one ``engine.fetch`` span, whose
    byte count is what ``wire.to_host`` copied of the masks wire (uint8;
    the volume program's float projection is not masks)."""
    batcher = {'solo-batcher': 1, 'batched': 2}.get(case)
    engine = _port(models, compact_wire=compact, auto_batch=batcher)
    moved, to_host = [], wire.to_host

    def spy(dev, *args, **kw):
        host = to_host(dev, *args, **kw)
        if host.dtype == np.uint8:
            moved.append(host.nbytes)
        return host

    try:
        vol = _small_ct()
        _fetch_case(engine, case, vol)  # builds the programs
        monkeypatch.setattr(wire, 'to_host', spy)
        trace.enable()
        try:
            n = _fetch_case(engine, case, vol)
            spans = [s for s in trace.collect() if s.name == 'engine.fetch']
        finally:
            trace.disable()
        if batcher:
            occupancy = engine._batcher.stats()['batch_occupancy']
            assert occupancy[-1] == (2 if case == 'batched' else 4)
    finally:
        engine.close()
    assert len(spans) == n
    assert all(s.nbytes > 0 for s in spans)
    assert sum(s.nbytes for s in spans) == sum(moved)
