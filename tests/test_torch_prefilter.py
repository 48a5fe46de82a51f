"""The PyTorch port's B-spline prefilter (ops/cuda/prefilter.py).

Its plain version is held against the reference package's Pallas kernel (in
interpret mode), its associative-scan version and scipy (from n = 10 on,
where the reference's capped init series meets scipy's tolerance); the
CUDA kernel is held against the plain versions on the card in
tests/test_torch_cuda.py. Tolerance
rtol 1e-4 / atol 1e-5: the tests/test_013_pallas.py bar (float32 against
float64 scipy and against other summation orders).

The chunked plain version (the kernel's decomposition) is held to rtol 1e-5
/ atol 1e-6 against the sequential one, the Pallas kernel and the scan:
float32 rounding apart, with the truncation of its warm-ups below 1.4e-11.
Worst observed on these inputs: 2.4e-7 against the sequential version (at
the (400, 512, 2) projection), 1.4e-6 absolute against the Pallas kernel and
the scan, every element inside the bound. A scalar float32 model of the
kernel's work item (``_kernel_line``) pins the chunked version to the
kernel's order of operations bit for bit."""

import math

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
TIGHT = dict(rtol=1e-5, atol=1e-6)
L, H = PF.CHUNK, PF.HORIZON
# lengths at the chunk arithmetic's edges: the short-line horizon 2n-2 < 18,
# one chunk (n <= L), one off a multiple of L, a warm-up reaching sample 0
# (H + L) and a look-ahead reaching n-1 (2L + H + 3), the main path's axes
CHUNK_NS = [2, 3, 9, L - 1, L, L + 1, H + L, 2 * L + H + 3, 400, 512]


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


def _kernel_line(x, chunk=L, warm=PF.WARM):
    """csrc/prefilter.cu's work items over one line, scalar by scalar in
    float32: a model of the kernel's order of operations."""
    f = np.float32
    n = len(x)
    zd = math.sqrt(3.0) - 2.0
    gd = (1.0 - zd) * (1.0 - 1.0 / zd)
    z, gain, cz = f(zd), f(gd), f(zd / (zd * zd - 1.0))
    y = np.empty(n, f)
    for c0 in range(0, n, chunk):
        e = min(c0 + chunk, n)
        from0, tail = c0 <= warm, e + warm >= n
        a = 0 if from0 else c0 - 1 - warm
        buf = [f(v) for v in x[a:(n if tail else e + warm)]]
        s = f(buf[0] * gain)
        if from0:
            zk = 1.0
            for k in range(1, PF.horizon(n) + 1):
                zk *= zd
                s = f(s + f(buf[PF._mirror_index(k, n)] * f(gd * zk)))
        buf[0] = s
        for k in range(1, len(buf)):
            s = buf[k] = f(f(buf[k] * gain) + f(s * z))
        k, c = len(buf) - 1, f(0.0)
        if tail:
            c = buf[k] = f(f(f(buf[k - 1] * z) + s) * cz)
            k -= 1
        for k in range(k, c0 - a - 1, -1):
            c = buf[k] = f(f(c - buf[k]) * z)
        y[c0:e] = buf[c0 - a:e - a]
    return y


class TestChunkedPlainVersion:
    @pytest.mark.parametrize('inner', [1, 2, 33])
    @pytest.mark.parametrize('n', CHUNK_NS)
    def test_matches_sequential(self, rng, n, inner):
        x = torch.from_numpy(rng.standard_normal((3, n, inner)).astype(np.float32))
        out = PF.bspline_prefilter_chunked_plain(x, 1)
        seq = PF.bspline_prefilter_plain(x, 1)
        torch.testing.assert_close(out, seq, **TIGHT)
        if n <= L:  # one chunk: the sequential arithmetic exactly
            assert torch.equal(out, seq)

    @pytest.mark.parametrize('n,inner', list(zip(CHUNK_NS, [1, 2, 33] * 4)))
    def test_matches_reference(self, rng, n, inner):
        x = rng.standard_normal((2, n, inner)).astype(np.float32)
        out = PF.bspline_prefilter_chunked_plain(torch.from_numpy(x), 1).numpy()
        ref = jnp.moveaxis(bspline_prefilter_1d(
            jnp.moveaxis(jnp.asarray(x), 1, -1)), -1, 1)
        np.testing.assert_allclose(out, np.asarray(ref), **TIGHT)
        if n >= 4:  # the Pallas kernel declines shorter lines
            pallas = bspline_prefilter_pallas(jnp.asarray(x), axis=1,
                                              interpret=True)
            np.testing.assert_allclose(out, np.asarray(pallas), **TIGHT)

    @pytest.mark.parametrize('n', [2, 33, L + H + 1, 2 * L + H + 3, 150])
    def test_follows_kernel_order_of_operations(self, rng, n):
        x = rng.standard_normal((n, 3)).astype(np.float32)
        out = PF.bspline_prefilter_chunked_plain(torch.from_numpy(x), 0)
        model = np.stack([_kernel_line(x[:, i]) for i in range(3)], axis=1)
        np.testing.assert_array_equal(out.numpy(), model)

    @pytest.mark.parametrize('chunk', [4, 7, 16])
    @pytest.mark.parametrize('n', [5, 21, 40, 71])
    def test_other_chunk_widths(self, rng, chunk, n):
        # widths under the warm-up make several chunks start at sample 0
        x = rng.standard_normal((n, 2)).astype(np.float32)
        out = PF.bspline_prefilter_chunked_plain(torch.from_numpy(x), 0, chunk)
        torch.testing.assert_close(
            out, PF.bspline_prefilter_plain(torch.from_numpy(x), 0), **TIGHT)
        model = np.stack([_kernel_line(x[:, i], chunk) for i in range(2)], 1)
        np.testing.assert_array_equal(out.numpy(), model)

    def test_two_axes_main_path(self, rng):
        # the main-path call, a (H, W, C) projection along both spatial
        # axes, at lengths of several chunks
        x = rng.standard_normal((97, 70, 2)).astype(np.float32)
        t = torch.from_numpy(x)
        out = PF.bspline_prefilter_chunked_plain(
            PF.bspline_prefilter_chunked_plain(t, 0), 1)
        ref = jax_bspline_prefilter(jnp.asarray(x), [0, 1])
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TIGHT)
        torch.testing.assert_close(out, bspline_prefilter(t, [0, 1]), **TIGHT)

    def test_length_one_is_identity(self, rng):
        x = torch.from_numpy(rng.standard_normal((1, 5)).astype(np.float32))
        assert PF.bspline_prefilter_chunked_plain(x, 0) is x


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
