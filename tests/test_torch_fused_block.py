"""The PyTorch port's fused norm-act-conv3x3 block (ops/cuda/fused_block.py).

Its plain version is held against the reference package's plain-XLA
``fused_block.reference`` and its Pallas kernel (interpret mode), its
``fold_stats`` against the reference's, and the port's fused conv stack
against the reference's ``_conv_stack_fused`` (interpret mode). The CUDA
kernel is held against the plain version on the card in
tests/test_torch_cuda.py. Tolerances are the tests/test_013_pallas.py bars: y rtol/atol 0.05
(bf16 outputs of two fp32 summation orders: one bf16 ulp apart at worst),
stats rtol 0.03 / atol 0.5 (fp32 sums over H*W in different orders), the
whole stack rtol 0.1 / atol 0.05, fold_stats 2e-3. Inputs are bf16-exact
numbers drawn with numpy, so both packages start from the same operands;
the worst errors measured on the CPU are written beside each assertion."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from totalsegmentator2d_tpu.models.plans import ArchSpec
from totalsegmentator2d_tpu.models.unet import (_conv_stack_fused,
                                                init_params_np)
from totalsegmentator2d_tpu.ops.pallas import fused_block as JF
from totalsegmentator2d_tpu_torch.models.convert import params_from_jax
from totalsegmentator2d_tpu_torch.models.unet import UNet
from totalsegmentator2d_tpu_torch.ops.cuda import fused_block as FB

Y_TOL = dict(rtol=0.05, atol=0.05)
STATS_TOL = dict(rtol=0.03, atol=0.5)


def _bf16(a):
    """Round a float32 numpy array to the nearest bf16 value."""
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _operands(rng, N, H, W, C, Co):
    x = _bf16(rng.standard_normal((N, H, W, C)).astype(np.float32))
    scale = rng.uniform(0.5, 2.0, (N, C)).astype(np.float32)
    shift = (rng.standard_normal((N, C)) * 0.3).astype(np.float32)
    w = _bf16((rng.standard_normal((3, 3, C, Co)) * 0.1).astype(np.float32))
    b = (rng.standard_normal((Co,)) * 0.1).astype(np.float32)
    return x, scale, shift, w, b


def _port(args, **kw):
    y, st = FB.fused_norm_act_conv(*(torch.from_numpy(a) for a in args), **kw)
    return y.float().numpy(), st.numpy()


class TestPlainVersion:
    # the three tests/test_013_pallas.py shapes and the C = Cout = 8 edge
    @pytest.mark.parametrize('shape', [(2, 32, 32, 32, 32), (1, 16, 64, 8, 16),
                                       (2, 32, 16, 16, 8), (2, 9, 8, 8, 8)])
    def test_matches_reference(self, rng, shape):
        args = _operands(rng, *shape)
        y, st = _port(args)
        ry, rst = JF.reference(*(jnp.asarray(a) for a in args))
        assert y.shape == shape[:3] + (shape[4],) and st.shape == (
            shape[0], 2, shape[4])
        # measured worst on the CPU: dy = 0 (the same bf16 values), dstats
        # 2.9e-3 at 32x32x32->32
        np.testing.assert_allclose(y, np.asarray(ry, np.float32), **Y_TOL)
        np.testing.assert_allclose(st, np.asarray(rst), **STATS_TOL)

    def test_matches_pallas_interpreted(self, rng):
        args = _operands(rng, 1, 16, 8, 16, 8)
        y, st = _port(args)
        ry, rst = JF.fused_norm_act_conv(*(jnp.asarray(a) for a in args),
                                         interpret=True)
        np.testing.assert_allclose(y, np.asarray(ry, np.float32), **Y_TOL)
        np.testing.assert_allclose(st, np.asarray(rst), **STATS_TOL)

    def test_conv_stats_variant(self, rng):
        x, _, _, w, b = _operands(rng, 2, 16, 32, 16, 8)
        y, st = FB.fused_norm_act_conv(
            torch.from_numpy(x), None, None, torch.from_numpy(w),
            torch.from_numpy(b), apply_normact=False)
        dummy = jnp.zeros((2, 16), jnp.float32)
        ry, rst = JF.fused_norm_act_conv(jnp.asarray(x), dummy, dummy,
                                         jnp.asarray(w), jnp.asarray(b),
                                         apply_normact=False, interpret=True)
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(ry, np.float32), **Y_TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(rst), **STATS_TOL)

    def test_padding_is_zero_after_normact(self):
        # a constant image whose normact is non-zero everywhere: the border
        # outputs see fewer taps, as zero padding in the activated domain
        x = torch.ones((1, 4, 4, 1))
        one = torch.ones((1, 1))
        w = torch.ones((3, 3, 1, 1))
        y, _ = FB.fused_norm_act_conv(x, one, one, w, torch.zeros(1))
        corner, edge, inner = 2.0 * 4, 2.0 * 6, 2.0 * 9
        assert y[0, 0, 0, 0] == corner and y[0, 0, 1, 0] == edge
        assert y[0, 1, 1, 0] == inner

    def test_fold_stats_matches_reference(self, rng):
        st = np.stack([rng.standard_normal((3, 6)) * 40,
                       rng.uniform(50, 400, (3, 6))], axis=1).astype(np.float32)
        gamma = rng.uniform(0.5, 2.0, 6).astype(np.float32)
        beta = rng.standard_normal(6).astype(np.float32)
        for g, bt in ((gamma, beta), (None, None)):
            ours = FB.fold_stats(torch.from_numpy(st), 64,
                                 None if g is None else torch.from_numpy(g),
                                 None if bt is None else torch.from_numpy(bt),
                                 1e-5)
            ref = JF.fold_stats(jnp.asarray(st), 64,
                                None if g is None else jnp.asarray(g),
                                None if bt is None else jnp.asarray(bt), 1e-5)
            for a, r in zip(ours, ref):
                np.testing.assert_allclose(a.numpy(), np.asarray(r),
                                           rtol=2e-3, atol=2e-3)


def _stack_case(in_channels, stride, rng):
    spec = ArchSpec(n_stages=2, features_per_stage=(in_channels, 16),
                    kernel_sizes=((3, 3), (3, 3)),
                    strides=((1, 1), stride), n_conv_per_stage=(1, 2),
                    n_conv_per_stage_decoder=(1,), in_channels=in_channels,
                    out_channels=1)
    params = init_params_np(1, spec)
    for blk in params['encoder']['stages'][1]:
        blk['conv']['b'] = rng.uniform(-0.3, 0.3, 16).astype(np.float32)
        blk['norm']['scale'] = rng.uniform(0.5, 1.5, 16).astype(np.float32)
        blk['norm']['bias'] = rng.uniform(-0.5, 0.5, 16).astype(np.float32)
    return spec, params


@pytest.mark.parametrize('in_channels,stride', [(16, (1, 1)), (8, (2, 2))],
                         ids=['kernel-first-block', 'conv-first-block'])
def test_fused_stack_matches_reference(rng, in_channels, stride):
    """The port's fused chain against the reference's _conv_stack_fused
    (interpret mode), for both routes of the stack's first block: the
    kernel with apply_normact=False (stride 1, C >= 16), and a bf16 conv
    with one-pass statistics (stride 2). Measured on the CPU: identical
    bf16 outputs for both routes."""
    spec, params = _stack_case(in_channels, stride, rng)
    x = _bf16(rng.standard_normal((2, 8, 16, in_channels)).astype(np.float32))
    blocks = jax.tree_util.tree_map(jnp.asarray, params['encoder']['stages'][1])
    ref = np.asarray(_conv_stack_fused(jnp.asarray(x), blocks, stride, spec,
                                       interpret=True), np.float32)
    net = UNet(spec).eval()
    net.load_state_dict(params_from_jax(params), strict=True)
    net.prepare_fast()
    stack = net.encoder.stages[1]
    assert stack.fused
    with torch.no_grad():
        out = stack.forward_fast(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert out.dtype == torch.bfloat16
    out = out.permute(0, 2, 3, 1).float().numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0.1, atol=0.05)


class TestWrapper:
    def test_cpu_tensor_takes_plain_version(self, rng):
        args = [torch.from_numpy(a) for a in _operands(rng, 1, 6, 5, 8, 8)]
        before = FB.fused_norm_act_conv_cuda.launches
        y, st = FB.fused_norm_act_conv(*args)
        assert FB.fused_norm_act_conv_cuda.launches == before
        ry, rst = FB.fused_norm_act_conv_plain(*args)
        assert torch.equal(y, ry) and torch.equal(st, rst)

    def test_kernel_refuses_cpu_tensor(self, rng):
        args = [torch.from_numpy(a) for a in _operands(rng, 1, 6, 5, 8, 8)]
        with pytest.raises(ValueError, match='CUDA'):
            FB.fused_norm_act_conv_cuda(*args)

    def test_rejects_bad_shapes(self, rng):
        x, sc, sh, w, b = (torch.from_numpy(a)
                           for a in _operands(rng, 1, 6, 5, 8, 4))
        with pytest.raises(ValueError, match='w must be'):
            FB.fused_norm_act_conv(x, sc, sh, w[:, :, :4], b)
        with pytest.raises(ValueError, match='scale'):
            FB.fused_norm_act_conv(x, None, sh, w, b)
        with pytest.raises(ValueError, match='b must be'):
            FB.fused_norm_act_conv(x, sc, sh, w, b[:2])

    @pytest.mark.parametrize('C,Co,act', [(3, 5, True), (3, 5, False),
                                          (16, 100, True), (24, 40, False)])
    def test_channel_padding_is_exact(self, rng, C, Co, act):
        """The wrapper's zero padding of channel counts the kernel does not
        take, as plain functions: the padded operands give the unpadded
        result, sliced back, bit for bit. The operands are small multiples
        of powers of two, so every product and sum is exact in fp32 and the
        order of the sums (which the channel count may change) cannot
        matter."""
        N, H, W = 2, 5, 7
        x = torch.from_numpy(rng.integers(-2, 3, (N, H, W, C)) / 2).float()
        scale = torch.from_numpy(rng.integers(1, 3, (N, C)) / 1).float()
        shift = torch.from_numpy(rng.integers(-1, 2, (N, C)) / 2).float()
        w = torch.from_numpy(rng.integers(-1, 2, (3, 3, C, Co)) / 4).float()
        b = torch.from_numpy(rng.integers(-2, 3, Co) / 4).float()
        sc, sh = (scale, shift) if act else (None, None)
        ry, rst = FB.fused_norm_act_conv_plain(x, sc, sh, w, b, 0.25, act)
        px, psc, psh, pw, pb = FB.pad_channels(x, sc, sh, w, b)
        assert px.shape[3] % FB.C_MULTIPLE == 0 and px.shape[3] >= C
        assert pw.shape[2:] == (px.shape[3], -(-Co // FB.COUT_MULTIPLE)
                                * FB.COUT_MULTIPLE)
        y, st = FB.fused_norm_act_conv_plain(px, psc, psh, pw, pb, 0.25, act)
        assert torch.equal(y[..., :Co], ry) and torch.equal(st[..., :Co], rst)
        assert not y[..., Co:].float().any() and not st[..., Co:].any()

    def test_pad_channels_leaves_kernel_shapes_alone(self, rng):
        args = [torch.from_numpy(a) for a in _operands(rng, 1, 6, 5, 64, 32)]
        assert all(p is a for p, a in zip(FB.pad_channels(*args), args))

    def test_pack_weight_is_the_kernel_layout(self, rng):
        w = torch.from_numpy(rng.standard_normal((3, 3, 5, 7)).astype(np.float32))
        p = FB.pack_weight(w)
        assert p.dtype == torch.bfloat16 and p.is_contiguous()
        rows = p.view(45, 7)  # (9C, Cout), rows [ky, kx, c]
        assert torch.equal(rows[(2 * 3 + 1) * 5 + 3], p[2, 1, 3])
