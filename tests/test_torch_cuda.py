"""The PyTorch port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and nvcc (``requires_cuda``) and skips
without one. The file imports neither JAX nor the reference package, so it
runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances: the prefilter kernel rounds where its plain version rounds
(rtol 1e-5 / atol 1e-6); the fused block's outputs are bf16 values of two
fp32 summation orders (y rtol/atol 0.05, stats rtol 0.03 / atol 0.5, the
tests/test_013_pallas.py bars)."""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from totalsegmentator2d_tpu_torch.ops.cuda import fused_block as FB
from totalsegmentator2d_tpu_torch.ops.cuda import prefilter as PF

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    return torch.device('cuda')


@pytest.fixture
def rng():
    return np.random.default_rng(0)


class TestPrefilterKernel:
    @pytest.mark.parametrize('shape,axis', [((400, 512, 2), 0),
                                            ((400, 512, 2), 1), ((2, 77), 0),
                                            ((13, 1001), 0), ((9, 10, 11), 2)])
    def test_matches_plain_version(self, cuda, rng, shape, axis):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
        before = PF.bspline_prefilter_cuda.launches
        out = PF.prefilter_axis(x, axis)
        torch.cuda.synchronize()
        assert PF.bspline_prefilter_cuda.launches == before + 1
        torch.testing.assert_close(out, PF.bspline_prefilter_plain(x, axis),
                                   rtol=1e-5, atol=1e-6)
        if x.shape[axis] >= 10:  # the reference's series meets scipy's
            ref = ndi.spline_filter1d(x.double().cpu().numpy(), order=3,
                                      axis=axis, mode='mirror')
            np.testing.assert_allclose(out.cpu().numpy(), ref, rtol=1e-4,
                                       atol=1e-5)


def _operands(rng, device, N, H, W, C, Co):
    x = torch.from_numpy(rng.standard_normal((N, H, W, C)).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 2.0, (N, C)).astype(np.float32))
    shift = torch.from_numpy((rng.standard_normal((N, C)) * 0.3).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, C, Co)) * 0.1).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(Co) * 0.1).astype(np.float32))
    return (x.to(device, torch.bfloat16), scale.to(device), shift.to(device),
            FB.pack_weight(w.to(device)), b.to(device))


# shapes of the flagship U-Net's launches (N cut to 2) and edge shapes:
# C = Cout = 8, W = 8, H not a multiple of the row tile, channel counts
# that are not multiples of 8 (the scalar path)
FUSED_SHAPES = [(2, 64, 64, 32, 32, True), (2, 16, 16, 1024, 512, False),
                (2, 8, 8, 512, 512, True), (2, 9, 8, 8, 8, True),
                (1, 13, 8, 24, 40, True), (2, 7, 5, 3, 5, True),
                (2, 7, 5, 3, 5, False)]


class TestFusedBlockKernel:
    @pytest.mark.parametrize('N,H,W,C,Co,act', FUSED_SHAPES)
    def test_matches_plain_version(self, cuda, rng, N, H, W, C, Co, act):
        args = _operands(rng, cuda, N, H, W, C, Co)
        before = FB.fused_norm_act_conv_cuda.launches
        y, st = FB.fused_norm_act_conv(*args, apply_normact=act)
        torch.cuda.synchronize()
        assert FB.fused_norm_act_conv_cuda.launches == before + 1
        assert y.dtype == torch.bfloat16 and y.shape == (N, H, W, Co)
        ry, rst = FB.fused_norm_act_conv_plain(*args, apply_normact=act)
        torch.testing.assert_close(y.float(), ry.float(), rtol=0.05, atol=0.05)
        torch.testing.assert_close(st, rst, rtol=0.03, atol=0.5)

    def test_bitwise_repeatable(self, cuda, rng):
        args = _operands(rng, cuda, 4, 32, 32, 64, 64)
        y1, s1 = FB.fused_norm_act_conv(*args)
        y2, s2 = FB.fused_norm_act_conv(*args)
        assert torch.equal(y1, y2) and torch.equal(s1, s2)

    def test_refuses_wrong_inputs(self, cuda, rng):
        x, sc, sh, wp, b = _operands(rng, cuda, 1, 8, 8, 8, 8)
        with pytest.raises(TypeError, match='x must be'):
            FB.fused_norm_act_conv(x.float(), sc, sh, wp, b)
        with pytest.raises(TypeError, match='w must be'):
            FB.fused_norm_act_conv(x, sc, sh, wp.float(), b)
        with pytest.raises(ValueError, match='contiguous'):
            FB.fused_norm_act_conv(x.transpose(1, 2), sc, sh, wp, b)
        with pytest.raises(ValueError, match='CUDA'):
            FB.fused_norm_act_conv_cuda(x, sc.cpu(), sh, wp, b)
