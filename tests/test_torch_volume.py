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
  takes the host path; the compact wire is bit-identical.

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
from totalsegmentator2d_tpu_torch.inference import EnsembleEngine, Zoo
from totalsegmentator2d_tpu_torch.io import MedicalImage
from totalsegmentator2d_tpu_torch.ops.projection import (make_projected_image,
                                                         project,
                                                         project_array,
                                                         project_array_np)

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
