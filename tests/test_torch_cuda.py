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


def _misaligned(t):
    """A contiguous copy of t whose data starts 2 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


# shapes of the flagship U-Net's launches (N cut to 2) and edge shapes of
# the tiling: W < the tile width (8 and 16), H and W that are not multiples
# of the tile (also of the 256-pixel tile at 32 output channels), N = 1, the
# small deep shapes (BN 64 on 64-pixel tiles at 8x8, BN 128 at 16x16), and
# channel counts the kernel takes only zero-padded (C = 3, 8, 16, 24;
# Cout = 5, 40, 100)
FUSED_SHAPES = [(2, 64, 64, 32, 32, True), (2, 16, 16, 1024, 512, False),
                (2, 8, 8, 512, 512, True), (2, 16, 16, 512, 512, True),
                (2, 16, 16, 256, 32, True), (2, 9, 8, 8, 8, True),
                (1, 13, 8, 24, 40, True), (2, 7, 5, 3, 5, True),
                (2, 7, 5, 3, 5, False), (2, 20, 5, 32, 32, True),
                (2, 12, 12, 64, 64, True), (2, 37, 45, 64, 128, True),
                (1, 19, 23, 32, 32, False), (1, 64, 64, 32, 32, True),
                (2, 9, 11, 16, 100, True), (2, 9, 11, 16, 100, False),
                (2, 5, 7, 3, 100, True), (2, 8, 8, 128, 64, False),
                (2, 37, 45, 32, 32, True), (1, 40, 5, 64, 32, False)]

# the tile the kernel takes by shape (N, H, W, C, Cout -> BN, tile pixels):
# 256 pixels at 32 resident output channels, 64 pixels and BN 64 at 8x8
TILE_CHOICES = [(16, 256, 256, 32, 32, 32, 256), (16, 128, 128, 64, 64, 64, 128),
                (16, 16, 16, 1024, 512, 128, 128), (16, 8, 8, 512, 512, 64, 64)]


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

    @pytest.mark.parametrize('N,H,W,C,Co,bn,tile', TILE_CHOICES)
    def test_tile_choice(self, cuda, N, H, W, C, Co, bn, tile):
        info = FB.kernel_info(N, H, W, C, Co)
        assert (info['bn'], info['tile_pixels']) == (bn, tile)
        assert 1 <= info['grid'] <= info['units']
        assert info['blocks_per_sm'] >= 1

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
        with pytest.raises(ValueError, match='aligned'):
            FB.fused_norm_act_conv(_misaligned(x), sc, sh, wp, b)
