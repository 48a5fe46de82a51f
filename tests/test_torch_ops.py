"""The PyTorch port's ops against the reference package's: normalization,
resample weights and matmuls, the Gaussian window, tile grids and the
bit-packed mask wire. Same numpy inputs into both; float results at
rtol 1e-5 / atol 1e-6 (float32 with other reduction orders), host-built
arrays exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from totalsegmentator2d_tpu.inference import ensemble_engine as JE
from totalsegmentator2d_tpu.inference import engine as JEng
from totalsegmentator2d_tpu.inference import tiling as JT
from totalsegmentator2d_tpu.models.plans import PreprocessSpec
from totalsegmentator2d_tpu.ops import gaussian as JG
from totalsegmentator2d_tpu.ops import normalize as JN
from totalsegmentator2d_tpu.ops.resample import apply_separable, axis_weights
from totalsegmentator2d_tpu_torch.inference import ensemble_engine as PE
from totalsegmentator2d_tpu_torch.inference import program as PP
from totalsegmentator2d_tpu_torch.inference import tiling as PT
from totalsegmentator2d_tpu_torch.ops import gaussian as PG
from totalsegmentator2d_tpu_torch.ops import normalize as PN
from totalsegmentator2d_tpu_torch.ops import resample as PR

TOL = dict(rtol=1e-5, atol=1e-6)

SCHEMES = {
    'zscore': ('ZScoreNormalization', False, None),
    'masked-zscore': ('ZScoreNormalization', True, None),
    'ct': ('CTNormalization', False,
           {'mean': 40.0, 'std': 300.0, 'percentile_00_5': -900.0,
            'percentile_99_5': 1500.0}),
    'rescale': ('Rescale01Normalization', False, None),
    'nonorm': ('NoNormalization', False, None),
}


@pytest.mark.parametrize('name', sorted(SCHEMES))
def test_normalize_channels(rng, name):
    scheme, masked, props = SCHEMES[name]
    pre = PreprocessSpec(spacing=(1.5, 1.5), patch_size=(64, 64),
                         normalization_schemes=(scheme, 'ZScoreNormalization'),
                         use_mask_for_norm=(masked, False),
                         intensity_properties=(props, None))
    arr = (rng.standard_normal((40, 30, 2)) * 400 + 50).astype(np.float32)
    arr[:5] = 0
    mask = PN.nonzero_norm_mask(arr)
    np.testing.assert_array_equal(mask, JN.nonzero_norm_mask(arr))
    ref = JN.normalize_channels(jnp.asarray(arr), pre, jnp.asarray(mask))
    out = PN.normalize_channels(torch.from_numpy(arr), pre,
                                torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize('order,outside', [(0, 'zero'), (1, 'edge'),
                                           (3, 'edge'), (3, 'zero')])
def test_axis_weights_and_apply_separable(rng, order, outside):
    coords = np.linspace(-1.0, 23.4, 17)
    W = PR.axis_weights(21, coords, order, outside)
    np.testing.assert_array_equal(W, axis_weights(21, coords, order, outside))
    W2 = PR.axis_weights(13, np.linspace(0, 12, 30), order, outside)
    arr = rng.standard_normal((3, 21, 13, 2)).astype(np.float32)
    ws = [W.astype(np.float32), W2.astype(np.float32)]
    ref = apply_separable(jnp.asarray(arr), [jnp.asarray(w) for w in ws],
                          axes=(1, 2))
    out = PR.apply_separable(torch.from_numpy(arr),
                             [torch.from_numpy(w) for w in ws], axes=(1, 2))
    assert out.shape == (3, 17, 30, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize('patch', [(64, 64), (256, 256), (48, 80)])
def test_gaussian_map(patch):
    np.testing.assert_array_equal(PG.gaussian_map(patch), JG.gaussian_map(patch))


@pytest.mark.parametrize('shape,patch,step', [((64, 64), (64, 64), 0.5),
                                              ((333, 266), (256, 256), 0.5),
                                              ((150, 70), (64, 64), 0.3)])
def test_tile_grid(shape, patch, step):
    pad = PT.padded_shape(shape, patch)
    assert pad == JT.padded_shape(shape, patch)
    assert PT.pad_amounts(shape, pad) == JT.pad_amounts(shape, pad)
    np.testing.assert_array_equal(PT.tile_positions(pad, patch, step),
                                  JT.tile_positions(pad, patch, step))


def test_engine_host_helpers(rng):
    assert PP._mirror_combos((0, 1)) == JEng._mirror_combos((0, 1))
    assert (PP.compute_new_shape((400, 512), (1.25, 0.78), (1.5, 1.5))
            == JEng.compute_new_shape((400, 512), (1.25, 0.78), (1.5, 1.5))
            == (333, 266))
    arr = np.zeros((30, 20, 2), np.float32)
    arr[4:17, 3:9, 1] = rng.standard_normal((13, 6))
    assert PP._nonzero_bbox(arr) == JEng._nonzero_bbox(arr) == ((4, 17), (3, 9))


@pytest.mark.parametrize('n_labels', [5, 8, 117])
def test_pack_bits_wire(rng, n_labels):
    bits = (rng.random((7, 9, n_labels)) > 0.5).astype(np.uint8)
    packed = PE._pack_bits(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(packed, np.asarray(JE._pack_bits(jnp.asarray(bits))))
    np.testing.assert_array_equal(PE.unpack_bits(packed, n_labels), bits)
    np.testing.assert_array_equal(JE.unpack_bits(packed, n_labels), bits)


@pytest.mark.parametrize('mode', ['max', 'min', 'mean', 'median', 'std',
                                  'first', 'slice:0.5', 'multiclass:3'])
def test_projection_modes(rng, mode):
    from totalsegmentator2d_tpu.io import MedicalImage as JaxImage
    from totalsegmentator2d_tpu.ops.projection import project as jax_project
    from totalsegmentator2d_tpu_torch.io import MedicalImage
    from totalsegmentator2d_tpu_torch.ops.projection import project
    arr = rng.integers(0, 4, (9, 7, 5)).astype(np.int16)
    geo = dict(spacing=(0.8, 1.1, 2.0), origin=(1.0, -2.0, 3.0))
    ref = jax_project(JaxImage(array=arr, **geo), mode=mode, axis='coronal')
    out = project(MedicalImage(array=arr, **geo), mode=mode, axis='coronal')
    np.testing.assert_allclose(out.array, ref.array, rtol=1e-6, atol=1e-6)
    assert (out.spacing, out.origin, out.is_vector) == \
        (ref.spacing, ref.origin, ref.is_vector)
