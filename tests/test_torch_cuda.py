"""The PyTorch port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and nvcc (``requires_cuda``) and skips
without one. The file imports neither JAX nor the reference package, so it
runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances: the prefilter kernel rounds where its chunked plain version
rounds (``torch.equal``), and agrees with the sequential one to float32
rounding (rtol 1e-5 / atol 1e-6); the fused block's outputs are bf16 values of two
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


# the main path's projection, the batch-8 shape, and edges of the chunking
# (n = 2, 3, 9, L-1, L, L+1, H+L, 2L+H+3) at inner = 1, 2, 33 and at line
# counts that are not multiples of a block; (3, 20000, 2) takes the global
# path with a small inner (its (n, inner) slab exceeds shared memory)
PREFILTER_SHAPES = [((400, 512, 2), 0), ((400, 512, 2), 1),
                    ((8, 400, 512, 2), 1), ((8, 400, 512, 2), 2),
                    ((2, 77), 0), ((13, 1001), 0), ((13, 1001), 1),
                    ((9, 10, 11), 2), ((5, 3, 33), 1), ((7, 9, 2), 1),
                    ((31, 45), 0), ((32, 45), 0), ((33, 1), 0),
                    ((50, 33), 0), ((3, 85, 1), 1), ((3, 85, 2), 1),
                    ((85, 33), 0), ((3, 20000, 2), 1), ((20000,), 0)]


class TestPrefilterKernel:
    @pytest.mark.parametrize('shape,axis', PREFILTER_SHAPES)
    def test_matches_plain_version(self, cuda, rng, shape, axis):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
        before = PF.bspline_prefilter_cuda.launches
        out = PF.prefilter_axis(x, axis)
        torch.cuda.synchronize()
        assert PF.bspline_prefilter_cuda.launches == before + 1
        assert torch.equal(out, PF.bspline_prefilter_chunked_plain(x, axis))
        torch.testing.assert_close(out, PF.bspline_prefilter_plain(x, axis),
                                   rtol=1e-5, atol=1e-6)
        if x.shape[axis] >= 10:  # the reference's series meets scipy's
            ref = ndi.spline_filter1d(x.double().cpu().numpy(), order=3,
                                      axis=axis, mode='mirror')
            np.testing.assert_allclose(out.cpu().numpy(), ref, rtol=1e-4,
                                       atol=1e-5)

    def test_bitwise_repeatable(self, cuda, rng):
        x = torch.from_numpy(rng.standard_normal((8, 400, 512, 2)).astype(
            np.float32)).to(cuda)
        for axis in (1, 2):
            assert torch.equal(PF.prefilter_axis(x, axis),
                               PF.prefilter_axis(x, axis))

    @pytest.mark.parametrize('shape,axis', [((40, 64), 0), ((3, 40, 2), 1)])
    def test_misaligned_input(self, cuda, rng, shape, axis):
        # a contiguous view 4 bytes past a 16-byte boundary: the tile path
        # takes its scalar loads, the slab path its unaligned copy
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
        buf = torch.empty(x.numel() + 1, device=cuda)
        xm = buf[1:].view(shape)
        xm.copy_(x)
        assert torch.equal(PF.prefilter_axis(xm, axis),
                           PF.bspline_prefilter_chunked_plain(x, axis))

    def test_cuda_tensor_never_takes_a_plain_version(self, cuda, rng,
                                                     monkeypatch):
        def refuse(*args, **kwargs):
            raise AssertionError('a plain version ran on a CUDA tensor')
        monkeypatch.setattr(PF, 'bspline_prefilter_plain', refuse)
        monkeypatch.setattr(PF, 'bspline_prefilter_chunked_plain', refuse)
        x = torch.from_numpy(rng.standard_normal((40, 3)).astype(np.float32))
        before = PF.bspline_prefilter_cuda.launches
        PF.prefilter_axis(x.to(cuda), 0)
        assert PF.bspline_prefilter_cuda.launches == before + 1


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
