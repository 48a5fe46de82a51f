"""Augmentation of the port (training/augment.py) against the reference
package's (training/augment.py) and scipy.

The two draw their random numbers from different generators, so each
transform is held at fixed parameters (p = 1 and degenerate ranges) on the
same numpy inputs from a seed: samplers, warps, blur, grid and one
low-resolution level at rtol 1e-5 (atol 1e-5 where values are O(1) sums of
products; the warps' one-hot matmuls sum in another order than the
gather), the one-hot warp bit for bit. The draws themselves are checked
for what they promise: the partition warps exactly round(B * p_any)
samples, and p = 0 is the identity."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from totalsegmentator2d_tpu.ops.resample import _resize_jit
from totalsegmentator2d_tpu.training import augment as JA
from totalsegmentator2d_tpu_torch.ops.cuda import prefilter as PF
from totalsegmentator2d_tpu_torch.training import augment as A

RTOL, ATOL = 1e-5, 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(a)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


@pytest.fixture
def gen():
    return torch.Generator().manual_seed(0)


# -- the samplers -----------------------------------------------------------------

@pytest.mark.parametrize('order', [0, 1, 3])
@pytest.mark.parametrize('mode', ['mirror', 'constant'])
@pytest.mark.parametrize('channels', [None, 2])
def test_map_coordinates_matches_reference(rng, order, mode, channels):
    shape = (40, 36) if channels is None else (40, 36, channels)
    img = rng.standard_normal(shape).astype(np.float32)
    coords = np.stack([rng.uniform(-6, 45, (25, 31)),
                       rng.uniform(-6, 41, (25, 31))]).astype(np.float32)
    ref = np.asarray(JA.map_coordinates(_j(img), _j(coords), order=order,
                                        mode=mode, cval=0.5))
    ours = A.map_coordinates(_t(img), _t(coords), order=order, mode=mode,
                             cval=0.5).numpy()
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('order', [0, 1, 3])
def test_map_coordinates_matches_scipy_mirror(rng, order):
    from scipy.ndimage import map_coordinates as scipy_mc
    img = rng.standard_normal((40, 36)).astype(np.float32)
    coords = np.stack([rng.uniform(-6, 45, (25, 31)),
                       rng.uniform(-6, 41, (25, 31))]).astype(np.float32)
    ours = A.map_coordinates(_t(img), _t(coords), order=order).numpy()
    ref = scipy_mc(img, coords, order=order, mode='mirror')
    np.testing.assert_allclose(ours, ref, atol=2e-4)


def test_affine_grid_vs_scipy_rotation(rng):
    """The port's grid and sampler against scipy on the same grid."""
    from scipy.ndimage import map_coordinates as scipy_mc
    img = rng.standard_normal((40, 36)).astype(np.float32)
    coords = A.affine_grid((40, 36), 0.4, 1.2)
    ours = A.map_coordinates(_t(img), coords, order=3).numpy()
    ref = scipy_mc(img, coords.numpy(), order=3, mode='mirror')
    np.testing.assert_allclose(ours, ref, atol=2e-4)
    sq = rng.standard_normal((33, 33)).astype(np.float32)
    out = A.map_coordinates(_t(sq), A.affine_grid((33, 33), math.pi / 2, 1.0),
                            order=1).numpy()
    np.testing.assert_allclose(out, np.rot90(sq, -1), atol=1e-4)


def test_warp_image_vs_scipy_interior(rng):
    from scipy.ndimage import map_coordinates as scipy_mc
    img = rng.standard_normal((40, 36)).astype(np.float32)
    coords = np.stack([rng.uniform(2, 37, (15, 17)),
                       rng.uniform(2, 33, (15, 17))]).astype(np.float32)
    fast = A.warp_image(_t(img[..., None]), _t(coords), order=3).numpy()[..., 0]
    ref = scipy_mc(img, coords, order=3, mode='constant', cval=0.0)
    np.testing.assert_allclose(fast, ref, atol=2e-4)


@pytest.fixture
def coords(rng):
    return np.stack([rng.uniform(-8, 47, (21, 19)),
                     rng.uniform(-8, 43, (21, 19))]).astype(np.float32)


@pytest.mark.parametrize('order', [1, 3])
def test_warp_image_matches_reference_and_gather(rng, coords, order):
    img = rng.standard_normal((40, 36, 2)).astype(np.float32)
    ref = np.asarray(JA.warp_image(_j(img), _j(coords), order=order))
    ours = A.warp_image(_t(img), _t(coords), order=order).numpy()
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    gather = A.map_coordinates(_t(img), _t(coords), order=order,
                               mode='constant').numpy()
    np.testing.assert_allclose(ours, gather, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('angle,scale', [
    (0.0, 1.0), (0.7, 1.4), (-2.4, 0.7), (math.pi / 4, 1.17)])
@pytest.mark.parametrize('order', [1, 3])
def test_warp_image_affine_matches_reference(rng, angle, scale, order):
    img = rng.standard_normal((48, 44, 2)).astype(np.float32)
    jc = JA.affine_grid((48, 44), angle, scale)
    ref = np.asarray(JA.warp_image_affine(_j(img), jc, order=order, smax=1.4,
                                          tile=16))
    np.testing.assert_allclose(A.affine_grid((48, 44), angle, scale).numpy(),
                               np.asarray(jc), rtol=RTOL, atol=ATOL)
    c = _t(np.asarray(jc))   # one grid for both: a 1-ulp coordinate moves
    ours = A.warp_image_affine(_t(img), c, order=order, smax=1.4,
                               tile=16).numpy()
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    full = A.warp_image(_t(img), c, order=order).numpy()
    np.testing.assert_allclose(ours, full, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('shape,tile', [((96, 88), 32), ((120, 104), 8),
                                        ((24, 24), 16)])
def test_warp_image_affine_windows_chunks_fallback(rng, shape, tile):
    """The shipped tile 32 where the window engages, more tiles than one
    chunk (tile 8), and an image smaller than its window (the fallback)."""
    img = rng.standard_normal(shape + (2,)).astype(np.float32)
    c = A.affine_grid(shape, 0.9, 1.31)
    ours = A.warp_image_affine(_t(img), c, order=3, smax=1.4, tile=tile)
    full = A.warp_image(_t(img), c, order=3)
    np.testing.assert_allclose(ours.numpy(), full.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize('L', [1, 3, 24, 33])
def test_warp_onehot_bit_identical(rng, coords, L):
    target = (rng.random((40, 36, L)) > 0.85).astype(np.uint8)
    ref = np.asarray(JA.warp_onehot(_j(target), _j(coords)))
    ours = A.warp_onehot(_t(target), _t(coords)).numpy()
    np.testing.assert_array_equal(ours, ref)
    gather = A.map_coordinates(_t(target.astype(np.float32)), _t(coords),
                               order=1, mode='constant').numpy() > 0.5
    np.testing.assert_array_equal(ours, gather)


def test_stack_equals_per_sample(rng):
    """A (K, H, W, C) stack warps as its samples one by one, and its
    prefilter runs once per axis for the whole stack."""
    img = rng.standard_normal((3, 40, 36, 2)).astype(np.float32)
    tgt = (rng.random((3, 40, 36, 4)) > 0.7).astype(np.uint8)
    c = A.affine_grid((40, 36), torch.tensor([0.3, -1.0, 2.0]),
                      torch.tensor([1.1, 0.8, 1.3]))
    calls = []
    real = PF.bspline_prefilter_plain

    def spy(x, axis):
        calls.append(tuple(x.shape))
        return real(x, axis)

    PF.bspline_prefilter_plain = spy
    try:
        stack = A.warp_image_affine(_t(img), c, order=3, tile=16)
    finally:
        PF.bspline_prefilter_plain = real
    assert calls == [(3, 40, 36, 2)] * 2
    onehot = A.warp_onehot(_t(tgt), c)
    for k in range(3):
        one = A.warp_image_affine(_t(img[k]), c[k], order=3, tile=16)
        np.testing.assert_allclose(stack[k].numpy(), one.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(onehot[k].numpy(),
                                      A.warp_onehot(_t(tgt[k]), c[k]).numpy())


def test_gaussian_blur_matches_reference_and_scipy(rng):
    from scipy.ndimage import gaussian_filter1d
    img = rng.standard_normal((40, 36)).astype(np.float32)
    for sigma in (0.5, 0.8, 1.0):
        ours = A.gaussian_blur(_t(img), sigma, radius=5).numpy()
        ref = np.asarray(JA.gaussian_blur(_j(img), sigma, radius=5))
        np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
        sp = gaussian_filter1d(img, sigma, axis=0, mode='reflect', radius=5)
        sp = gaussian_filter1d(sp, sigma, axis=1, mode='reflect', radius=5)
        np.testing.assert_allclose(ours, sp, atol=1e-5)


def test_lowres_level_matches_reference(rng):
    image = rng.standard_normal((30, 26)).astype(np.float32)
    for z in A.LOWRES_ZOOMS:
        low = (max(1, int(round(30 * z))), max(1, int(round(26 * z))))
        ref = _resize_jit(_resize_jit(_j(image), low, 0, 'edge', (0, 1)),
                          (30, 26), 3, 'edge', (0, 1))
        ours = A.lowres_level(_t(image), z).numpy()
        np.testing.assert_allclose(ours, np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)


# -- transforms at fixed parameters -------------------------------------------------

@pytest.mark.parametrize('warp', ['matmul', 'gather'])
def test_spatial_transform_matches_reference(rng, gen, monkeypatch, warp):
    """p = 1 with one angle and one zoom: the same resample in both."""
    monkeypatch.setenv('TS2D_WARP', warp)
    image = rng.standard_normal((48, 44, 2)).astype(np.float32)
    target = (rng.random((48, 44, 5)) > 0.8).astype(np.uint8)
    kw = dict(rotation=(0.6, 0.6), p_rot=1.0, scale=(1.2, 1.2), p_scale=1.0)
    ri, rt = JA.spatial_transform(jax.random.PRNGKey(0), _j(image),
                                  _j(target), **kw)
    oi, ot = A.spatial_transform(gen, _t(image), _t(target), **kw)
    np.testing.assert_allclose(oi.numpy(), np.asarray(ri), rtol=RTOL,
                               atol=1e-4)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(rt))
    assert ot.dtype == torch.uint8


def test_intensity_transforms_match_reference(rng, gen):
    image = rng.standard_normal((2, 24, 20, 2)).astype(np.float32) * 2 + 1
    target = (rng.random((2, 24, 20, 3)) > 0.7).astype(np.uint8)
    key = jax.random.PRNGKey(0)
    x, jx = _t(image), _j(image)
    # brightness and contrast: one multiplier / factor for every channel
    for name, kw in (('brightness_transform', {'rng': (1.1, 1.1)}),
                     ('contrast_transform', {'rng': (0.8, 0.8)})):
        ours = getattr(A, name)(gen, x, p=1.0, **kw).numpy()
        for n in range(2):
            ref = np.asarray(getattr(JA, name)(key, jx[n], p=1.0, **kw))
            np.testing.assert_allclose(ours[n], ref, rtol=RTOL, atol=ATOL)
    # gamma, plain and inverted, with and without retained statistics
    for invert in (False, True):
        for retain in (False, True):
            kw = dict(p=1.0, rng=(1.3, 1.3), invert=invert,
                      retain_stats=retain)
            ours = A.gamma_transform(gen, x, **kw).numpy()
            for n in range(2):
                ref = np.asarray(JA.gamma_transform(key, jx[n], **kw))
                np.testing.assert_allclose(ours[n], ref, rtol=RTOL,
                                           atol=ATOL)
    # both flips
    oi, ot = A.mirror_transform(gen, x, _t(target), p_flip=1.0)
    for n in range(2):
        ri, rt = JA.mirror_transform(key, jx[n], _j(target[n]), p_flip=1.0)
        np.testing.assert_array_equal(oi[n].numpy(), np.asarray(ri))
        np.testing.assert_array_equal(ot[n].numpy(), np.asarray(rt))


def test_blur_noise_lowres_draws(rng, gen):
    """p = 1 and per-channel p = 1: every channel blurs with a sigma in
    range; noise of a fixed variance has that spread; every plane lowres'
    to one of the levels."""
    image = rng.standard_normal((3, 32, 30, 2)).astype(np.float32)
    x = _t(image)
    blurred = A.blur_transform(gen, x, p=1.0, p_per_channel=1.0,
                               sigma=(0.7, 0.7)).numpy()
    ref = A.gaussian_blur(x, 0.7, axes=(1, 2)).numpy()
    np.testing.assert_allclose(blurred, ref, rtol=RTOL, atol=ATOL)
    zero = torch.zeros((4, 64, 64, 1))
    noisy = A.add_gaussian_noise(gen, zero, p=1.0, variance=(0.1, 0.1))
    assert 0.28 < float(noisy.std()) < 0.36
    low = A.lowres_transform(gen, x, p=1.0, p_per_channel=1.0).numpy()
    for n in range(3):
        for c in range(2):
            plane = _t(image[n, :, :, c])
            assert any(np.allclose(low[n, :, :, c],
                                   A.lowres_level(plane, z).numpy())
                       for z in A.LOWRES_ZOOMS)


def test_partition_count_and_passthrough(rng, gen):
    B = 16
    image = rng.standard_normal((B, 48, 44, 2)).astype(np.float32)
    target = (rng.random((B, 48, 44, 5)) > 0.8).astype(np.uint8)
    oi, ot = A.spatial_transform_batch(gen, _t(image), _t(target))
    oi, ot = oi.numpy(), ot.numpy()
    changed = [i for i in range(B) if not np.array_equal(oi[i], image[i])]
    assert len(changed) == round(B * (1 - 0.8 * 0.8))
    for i in set(range(B)) - set(changed):
        np.testing.assert_array_equal(ot[i], target[i])
    assert set(np.unique(ot)) <= {0, 1}


def test_env_switches_validated(monkeypatch):
    monkeypatch.delenv('TS2D_WARP', raising=False)
    monkeypatch.delenv('TS2D_SPATIAL', raising=False)
    assert A._use_fast_warp() is True and A._spatial_mode() == 'partition'
    monkeypatch.setenv('TS2D_WARP', 'gahter')
    with pytest.raises(ValueError, match='TS2D_WARP'):
        A._use_fast_warp()
    monkeypatch.setenv('TS2D_SPATIAL', 'partiton')
    with pytest.raises(ValueError, match='TS2D_SPATIAL'):
        A._spatial_mode()


@pytest.mark.parametrize('n', [2, 8])
def test_probability_zero_is_identity(rng, gen, n):
    image = rng.standard_normal((n, 32, 32, 1)).astype(np.float32)
    target = (rng.random((n, 32, 32, 2)) > 0.8).astype(np.uint8)
    out = A.augment_batch(
        gen, {'image': _t(image), 'target': _t(target)},
        p_rot=0.0, p_scale=0.0, p_noise=0.0, p_blur=0.0, p_brightness=0.0,
        p_contrast=0.0, p_lowres=0.0, p_gamma_invert=0.0, p_gamma=0.0,
        p_flip=0.0)
    np.testing.assert_array_equal(out['image'].numpy(), image)
    np.testing.assert_array_equal(out['target'].numpy(), target)


@pytest.mark.parametrize('spatial', ['partition', 'persample'])
def test_full_recipe_shapes_and_reproducible(rng, monkeypatch, spatial):
    monkeypatch.setenv('TS2D_SPATIAL', spatial)
    image = rng.standard_normal((8, 40, 40, 2)).astype(np.float32)
    target = (rng.random((8, 40, 40, 3)) > 0.8).astype(np.uint8)
    batch = {'image': _t(image), 'target': _t(target)}
    a = A.augment_batch(torch.Generator().manual_seed(5), batch,
                        p_elastic=0.2 if spatial == 'persample' else 0.0)
    b = A.augment_batch(torch.Generator().manual_seed(5), batch,
                        p_elastic=0.2 if spatial == 'persample' else 0.0)
    c = A.augment_batch(torch.Generator().manual_seed(6), batch)
    assert a['image'].shape == image.shape and a['target'].dtype == torch.uint8
    assert set(np.unique(a['target'].numpy())) <= {0, 1}
    np.testing.assert_array_equal(a['image'].numpy(), b['image'].numpy())
    assert not np.allclose(a['image'].numpy(), c['image'].numpy())


def test_spatial_alignment_kept(rng, gen):
    """Warped samples keep image / target registration."""
    image = rng.standard_normal((8, 64, 60, 1)).astype(np.float32)
    image[:, 20:40, 20:40] += 4.0
    target = (image > 2.0).astype(np.uint8)
    oi, ot = A.spatial_transform_batch(gen, _t(image), _t(target),
                                       p_rot=1.0, p_scale=0.0)
    for i in range(8):
        agree = ((oi[i, ..., 0] > 2.0) == ot[i, ..., 0].bool()).float().mean()
        assert float(agree) > 0.97
