"""The PyTorch port's visuals on the CPU against the reference package's:
the image-level resample (prefilter plain version + matmuls) within
rtol 1e-5 / atol 1e-4, create_visual's label visuals bit for bit and its
intensity visuals within one gray level on every pixel and equal on
>= 99.9% of them, and the pieces beneath them (intensity window, auto
window, palette, label colours, orientation code). The visuals run on the
card unless the caller names the CPU."""

import importlib

import numpy as np
import pytest
import torch

from totalsegmentator2d_tpu.io import MedicalImage as JaxImage
from totalsegmentator2d_tpu.ops import geometry as jax_geometry
from totalsegmentator2d_tpu.ops import normalize as jax_normalize
from totalsegmentator2d_tpu.ops.resample import resample as jax_resample_image
from totalsegmentator2d_tpu.ops.resample import resample_uniform as jax_resample_uniform
from totalsegmentator2d_tpu.ops import visual as jax_visual
from totalsegmentator2d_tpu.utils import colors as jax_colors
from totalsegmentator2d_tpu_torch.io import MedicalImage
from totalsegmentator2d_tpu_torch.ops import geometry, normalize, visual
from totalsegmentator2d_tpu_torch.ops.annotations import set_annotation_meta
from totalsegmentator2d_tpu_torch.ops.cuda.prefilter import bspline_prefilter_cuda
from totalsegmentator2d_tpu_torch.utils import colors

# the package exports the function ``resample``, which hides the module
resample = importlib.import_module('totalsegmentator2d_tpu_torch.ops.resample')


def _pair(arr, spacing, origin=None, direction=None, is_vector=False, meta=None):
    kw = dict(array=arr, spacing=spacing, origin=origin, direction=direction,
              is_vector=is_vector, meta=dict(meta or {}))
    return MedicalImage(**kw), JaxImage(**kw)


def _ct(rng, shape=(24, 30, 28)):
    """A smooth int16 CT-like volume (body, bone, air) with noise."""
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, n) for n in shape], indexing='ij')
    body = np.where(y ** 2 + x ** 2 < 0.7, 40.0, -1000.0)
    bone = np.where((y - 0.4) ** 2 + x ** 2 < 0.05, 900.0, 0.0)
    return (body + bone + 30 * rng.standard_normal(shape)).astype(np.int16)


def _same_geometry(a, b):
    np.testing.assert_allclose(a.spacing, b.spacing, rtol=1e-12)
    np.testing.assert_allclose(a.origin, b.origin, rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(a.direction, b.direction)


@pytest.mark.parametrize('case', ['float2d', 'int16_3d', 'labels2d', 'order1',
                                  'vector2d', 'sized', 'direction'])
def test_resample_matches_reference(rng, case):
    arr, sp, kw, direction, vec = rng.normal(size=(20, 27)).astype(np.float32), \
        (0.7, 1.9), {}, None, False
    if case == 'int16_3d':
        arr, sp = _ct(rng, (9, 12, 10)), (0.8, 1.1, 2.0)
    elif case == 'labels2d':
        arr = rng.integers(0, 5, (20, 27)).astype(np.uint8)
    elif case == 'order1':
        kw = dict(order=1)
    elif case == 'vector2d':
        arr, vec = rng.normal(size=(20, 27, 2)).astype(np.float32), True
    elif case == 'sized':
        kw = dict(size=(None, 11))
    elif case == 'direction':
        direction = np.array([[0.0, 1.0], [-1.0, 0.0]])
    a, b = _pair(arr, sp, origin=(3.0, -2.0) if len(sp) == 2 else None,
                 direction=direction, is_vector=vec)
    target = 0.9 if case != 'int16_3d' else (1.0, 0.9, 1.3)
    out = resample.resample(a, target, device='cpu', **kw)
    ref = jax_resample_image(b, target, **kw)
    assert out.array.shape == ref.array.shape and out.array.dtype == ref.array.dtype
    _same_geometry(out, ref)
    if np.issubdtype(out.array.dtype, np.integer):  # rounded: equal
        np.testing.assert_array_equal(out.array, ref.array)
    else:
        np.testing.assert_allclose(out.array, ref.array, rtol=1e-5, atol=1e-4)


def test_resample_uniform_and_unchanged(rng):
    a, b = _pair(rng.normal(size=(8, 6)).astype(np.float32), (0.5, 1.5))
    out, ref = resample.resample_uniform(a, device='cpu'), jax_resample_uniform(b)
    assert out.spacing == ref.spacing == (0.5, 0.5)
    np.testing.assert_allclose(out.array, ref.array, rtol=1e-5, atol=1e-4)
    same = resample.resample(out, 0.5, device='cpu')
    assert same is out


def test_entry_points_need_the_card_unless_cpu_is_named(rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    img = MedicalImage(array=rng.normal(size=(8, 6)).astype(np.float32),
                       spacing=(0.5, 1.5))
    for fn in (lambda: resample.resample(img, 0.5),
               lambda: visual.create_visual(img),
               lambda: visual.label_to_rgb(np.zeros((2, 2), np.uint8), [])):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            fn()


def test_label_visual_bitwise(rng):
    """A 3D multilabel segmentation (vector, Segment colours in its
    metadata), rendered coronally: bit for bit the reference's."""
    seg = (rng.random((20, 1, 18, 4)) > 0.7).astype(np.uint8)
    a, b = _pair(seg, (0.8, 300.0, 1.6), is_vector=True)
    set_annotation_meta(a, names={1: 'heart', 2: 'aorta', 3: 'liver', 4: 'spleen'},
                        colors={'heart': (255, 0, 0), 'liver': (0, 0, 200)})
    b.meta = dict(a.meta)
    before = bspline_prefilter_cuda.launches
    out = visual.create_visual(a, labels=True, axis='coronal', device='cpu')
    ref = jax_visual.create_visual(b, labels=True, axis='coronal')
    assert bspline_prefilter_cuda.launches == before
    assert out.array.dtype == np.uint8 and out.is_vector
    np.testing.assert_array_equal(out.array, ref.array)
    _same_geometry(out, ref)


@pytest.mark.parametrize('case', ['plain', 'no-palette', 'wrap'])
def test_label_to_rgb_matches_reference(rng, case):
    arr = rng.integers(0, 9, (7, 8)).astype(np.uint8)
    pal = {'plain': colors.to_palette({1: 'red', 3: (0, 1.0, 0), 8: 'blue'}),
           'no-palette': [],
           'wrap': colors.to_palette(['white', 'red', 'green'])}[case]
    np.testing.assert_array_equal(visual.label_to_rgb(arr, pal, device='cpu'),
                                  jax_visual.label_to_rgb(arr, pal))


@pytest.mark.parametrize('case', ['ct3d', 'projection3d', 'float2d', 'vector2d',
                                  'window', 'pc'])
def test_intensity_visual_matches_reference(rng, case):
    """Intensity visuals: within one gray level on every pixel, equal on
    >= 99.9% of them (a float32 window truncated to uint8: an ulp of the
    resample or an XLA-fused multiply-add can move a pixel by one)."""
    kw = {}
    if case == 'ct3d':
        arr, sp, vec = _ct(rng, (40, 30, 48)), (0.78, 0.9, 1.5), False
    elif case == 'projection3d':
        arr, sp, vec = (_ct(rng, (40, 1, 48)).astype(np.float32) / 3.0,
                        (0.78, 400.0, 1.5), False)
    elif case == 'vector2d':
        arr, sp, vec = rng.normal(size=(30, 36, 2)).astype(np.float32), (0.7, 1.2), True
    else:
        arr, sp, vec = rng.normal(size=(30, 36)).astype(np.float32) * 100, (0.7, 1.2), False
        kw = {'window': dict(window=(-120.0, 90.0)),
              'pc': dict(window='pc2')}.get(case, {})
    a, b = _pair(arr, sp, is_vector=vec)
    out = visual.create_visual(a, axis='coronal', device='cpu', **kw)
    ref = jax_visual.create_visual(b, axis='coronal', **kw)
    assert out.array.shape == ref.array.shape and out.array.dtype == np.uint8
    _same_geometry(out, ref)
    diff = np.abs(out.array.astype(int) - ref.array)
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999


def test_intensity_window_matches_reference(rng):
    x = (rng.normal(size=(50, 60)) * 400).astype(np.float32)
    for lower, upper in ((-1000.0, 1500.0), (-0.3, 0.7), (5.0, 5.0), (-160.0, 240.0)):
        out = normalize.intensity_window(torch.from_numpy(x), lower, upper).numpy()
        ref = np.asarray(jax_normalize.intensity_window(x, lower, upper))
        assert out.dtype == np.float32
        ulp = np.spacing(np.abs(ref).astype(np.float32))
        assert np.all(np.abs(out - ref) <= ulp)
        # the order of the operations: sub, mul, add, each rounded
        f32 = np.float32
        scale = f32(255.0) / f32(max(upper - lower, 1e-12))
        expect = np.clip((x - f32(lower)) * scale + f32(0.0), 0, 255)
        np.testing.assert_array_equal(out, expect)


@pytest.mark.parametrize('method', [None, 'minmax', 'pc5', 'pc1-99.5'])
def test_auto_window_matches_reference(rng, method):
    x = rng.normal(size=(40, 50)).astype(np.float32)
    assert normalize.auto_window(torch.from_numpy(x), method) == \
        jax_normalize.auto_window(x, method)
    with pytest.raises(ValueError):
        normalize.auto_window(torch.from_numpy(x), 'bogus')


def test_palette_and_orientation_match_reference(rng):
    for pal in ({1: 'red', 4: '#00ff00'}, {}, ['white', (0.5, 0.5, 0.5), 3]):
        assert colors.to_palette(pal) == jax_colors.to_palette(pal)
    with pytest.raises(ValueError):
        colors.to_palette({'a': 'red'})
    for _ in range(5):
        q, _r = np.linalg.qr(rng.normal(size=(3, 3)))
        assert geometry.orientation_code(q) == jax_geometry.orientation_code(q)
    assert geometry.orientation_code(np.eye(3)) == 'RAI'
    assert geometry.orientation_code(np.diag([-1.0, -1.0, 1.0])) == 'LPI'
