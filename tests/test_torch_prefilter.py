"""The PyTorch port's B-spline prefilter (ops/cuda/prefilter.py).

Its plain version is held against the reference package's Pallas kernel (in
interpret mode), its associative-scan version and scipy (from n = 10 on,
where the reference's capped init series meets scipy's tolerance); the
CUDA kernel is held against the plain version on the card in
tests/test_torch_cuda.py. Tolerance
rtol 1e-4 / atol 1e-5: the tests/test_013_pallas.py bar (float32 against
float64 scipy and against other summation orders)."""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax.numpy as jnp

from totalsegmentator2d_tpu.ops.pallas.prefilter import bspline_prefilter_pallas
from totalsegmentator2d_tpu.ops.resample import (
    bspline_prefilter as jax_bspline_prefilter, bspline_prefilter_1d)
from totalsegmentator2d_tpu_torch.ops.cuda import prefilter as PF
from totalsegmentator2d_tpu_torch.ops.resample import bspline_prefilter

TOL = dict(rtol=1e-4, atol=1e-5)


def _scipy(x, axis):
    return ndi.spline_filter1d(x.astype(np.float64), order=3, axis=axis,
                               mode='mirror')


class TestPlainVersion:
    @pytest.mark.parametrize('shape,axis', [((31, 140), 0), ((25, 64, 3), 0),
                                            ((12, 40, 2), 1), ((6, 7, 33), 2)])
    def test_matches_pallas_interpreted(self, rng, shape, axis):
        x = rng.standard_normal(shape).astype(np.float32)
        ref = bspline_prefilter_pallas(jnp.asarray(x), axis=axis, interpret=True)
        out = PF.bspline_prefilter_plain(torch.from_numpy(x), axis)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)

    @pytest.mark.parametrize('shape,axis', [((64, 10), 1), ((10, 30, 2), 0),
                                            ((40, 11), 0)])
    def test_matches_scan_implementation(self, rng, shape, axis):
        x = rng.standard_normal(shape).astype(np.float32)
        ref = jnp.moveaxis(bspline_prefilter_1d(
            jnp.moveaxis(jnp.asarray(x), axis, -1)), -1, axis)
        out = PF.bspline_prefilter_plain(torch.from_numpy(x), axis)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)

    @pytest.mark.parametrize('n', [2, 3, 4, 5, 9, 10, 57])
    def test_matches_scipy_every_length(self, rng, n):
        # the reference's init series has min(18, 2n-2) taps at every n
        # (the Pallas kernel declines n < 4; bspline_prefilter_1d covers
        # all); below n = 10 that cap is short of scipy's tolerance, so
        # scipy is the reference only from n = 10 on
        x = rng.standard_normal((n, 19)).astype(np.float32)
        out = PF.bspline_prefilter_plain(torch.from_numpy(x), 0)
        ref = bspline_prefilter_1d(jnp.asarray(x.T)).T
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
        if n >= 10:
            np.testing.assert_allclose(out.numpy(), _scipy(x, 0), **TOL)

    def test_length_one_is_identity(self, rng):
        x = torch.from_numpy(rng.standard_normal((1, 5)).astype(np.float32))
        assert PF.bspline_prefilter_plain(x, 0) is x

    def test_two_axes_match_reference_resample_prefilter(self, rng):
        # the main-path call: a (H, W, C) projection along both spatial axes
        x = rng.standard_normal((37, 29, 2)).astype(np.float32)
        ref = jax_bspline_prefilter(jnp.asarray(x), [0, 1])
        out = bspline_prefilter(torch.from_numpy(x), [0, 1])
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
        np.testing.assert_allclose(out.numpy(),
                                   _scipy(_scipy(x, 0), 1), **TOL)


class TestWrapper:
    def test_cpu_tensor_takes_plain_version(self, rng):
        x = torch.from_numpy(rng.standard_normal((20, 9)).astype(np.float32))
        before = PF.bspline_prefilter_cuda.launches
        out = PF.prefilter_axis(x, 0)
        assert PF.bspline_prefilter_cuda.launches == before
        torch.testing.assert_close(out, PF.bspline_prefilter_plain(x, 0),
                                   rtol=0, atol=0)

    def test_rejects_non_float32(self):
        with pytest.raises(TypeError):
            PF.prefilter_axis(torch.zeros((8, 3), dtype=torch.float64), 0)

    def test_kernel_refuses_cpu_tensor(self):
        with pytest.raises(ValueError):
            PF.bspline_prefilter_cuda(torch.zeros((8, 3)), 0)
