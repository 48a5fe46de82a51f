"""The PyTorch port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and nvcc (``requires_cuda``) and skips
without one. The file imports neither JAX nor the reference package, so it
runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances: the prefilter kernel rounds where its chunked plain version
rounds (``torch.equal``), and agrees with the sequential one to float32
rounding (rtol 1e-5 / atol 1e-6); the fused block's outputs are bf16 values of two
fp32 summation orders (y rtol/atol 0.05, stats rtol 0.03 / atol 0.5, the
tests/test_013_pallas.py bars), also at the batched program's forward
batch (N = 128). The batched serving program must launch both kernels at
its shapes, and 8 exact predicts on 8 threads must equal 8 sequential ones
bit for bit (the exact-numerics flags are process-wide). The bucket
program (pad_quantum) runs the prefilter on its bucket canvas, solo and
batched, and repeats bit for bit with scans of different extents in one
batch; the volume program's projection of an int16 volume is the host's
bit for bit, and so is the native host library's one-pass projection. The
visuals run the prefilter kernel in their resample (two launches per
intensity visual) and equal their CPU renders (label visuals bit for bit,
intensity visuals within one gray level on every pixel). Training runs it
at its shapes (the preprocessing case, the augmentation's warp stack, a
low-resolution level), and one augmented ``Trainer.step`` on the card
launches it (the warp stack's two axes at least) with a finite loss."""

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


# the main path's projection, the batch-8 shape, the visuals' resample of a
# (400, 512) image, and edges of the chunking
# (n = 2, 3, 9, L-1, L, L+1, H+L, 2L+H+3) at inner = 1, 2, 33 and at line
# counts that are not multiples of a block; (3, 20000, 2) takes the global
# path with a small inner (its (n, inner) slab exceeds shared memory)
# the bucket program's canvas of the phantom crops at pad_quantum 64, solo
# and as the 8-scan batch
PREFILTER_SHAPES = [((400, 512, 2), 0), ((400, 512, 2), 1),
                    ((400, 512), 1), ((400, 512), 0),
                    ((8, 400, 512, 2), 1), ((8, 400, 512, 2), 2),
                    ((448, 512, 2), 0), ((448, 512, 2), 1),
                    ((8, 448, 512, 2), 1), ((8, 448, 512, 2), 2),
                    ((2, 77), 0), ((13, 1001), 0), ((13, 1001), 1),
                    ((9, 10, 11), 2), ((5, 3, 33), 1), ((7, 9, 2), 1),
                    ((31, 45), 0), ((32, 45), 0), ((33, 1), 0),
                    ((50, 33), 0), ((3, 85, 1), 1), ((3, 85, 2), 1),
                    ((85, 33), 0), ((3, 20000, 2), 1), ((20000,), 0),
                    # training: the preprocessing case, the warp stack of 6
                    # patches, a low-resolution level of 4 planes
                    ((448, 384, 2), 0), ((448, 384, 2), 1),
                    ((6, 256, 256, 2), 1), ((6, 256, 256, 2), 2),
                    ((4, 128, 128), 1), ((4, 128, 128), 2)]


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


# -- the batched serving program on the card ---------------------------------

# the fused block at the batched program's forward batch, N = 8 scans x 4
# tiles x 4 mirrors: the stage-0 shape and the decoder's concat shape of the
# flagship U-Net (256^2, C 32 -> 32 and 64 -> 32)
BATCHED_FUSED_SHAPES = [(128, 256, 256, 32, 32, True),
                        (128, 256, 256, 64, 32, False)]


@pytest.mark.parametrize('N,H,W,C,Co,act', BATCHED_FUSED_SHAPES)
def test_fused_block_at_the_batched_forward_batch(cuda, rng, N, H, W, C, Co,
                                                  act):
    args = _operands(rng, cuda, N, H, W, C, Co)
    y, st = FB.fused_norm_act_conv(*args, apply_normact=act)
    y2, st2 = FB.fused_norm_act_conv(*args, apply_normact=act)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    ry, rst = FB.fused_norm_act_conv_plain(*args, apply_normact=act)
    torch.testing.assert_close(y.float(), ry.float(), rtol=0.05, atol=0.05)
    torch.testing.assert_close(st, rst, rtol=0.03, atol=0.5)


def _ensemble(cuda, fast, **kw):
    """A 2-group ensemble of small random U-Nets (features 32-64-64, patch
    64^2, plan spacing 1.5 mm) on the card."""
    from totalsegmentator2d_tpu_torch.inference import EnsembleEngine
    from totalsegmentator2d_tpu_torch.models.plans import parse_model_spec
    from totalsegmentator2d_tpu_torch.models.unet import UNet
    specs, params = [], []
    for i, n_labels in enumerate((3, 4)):
        plans = {'configurations': {'2d': {
            'patch_size': [64, 64], 'spacing': [1.5, 1.5],
            'normalization_schemes': ['ZScoreNormalization'] * 2,
            'use_mask_for_norm': [False, False],
            'architecture': {'arch_kwargs': {
                'n_stages': 3, 'features_per_stage': [32, 64, 64],
                'kernel_sizes': [[3, 3]] * 3,
                'strides': [[1, 1], [2, 2], [2, 2]],
                'n_conv_per_stage': [2] * 3,
                'n_conv_per_stage_decoder': [2] * 2, 'conv_bias': True,
                'norm_op_kwargs': {'eps': 1e-05, 'affine': True},
                'nonlin_kwargs': {'inplace': True}}}}}}
        dataset = {'channel_names': {'0': 'max', '1': 'mean'},
                   'labels': {'background': 0,
                              **{f'l{i}-{j}': j + 1 for j in range(n_labels)}},
                   'multilabel': True}
        spec = parse_model_spec(plans, dataset)
        torch.manual_seed(10 + i)
        specs.append(spec)
        params.append([UNet(spec.arch).state_dict()])
    return EnsembleEngine(specs, params, device=cuda,
                          compute_dtype=torch.bfloat16 if fast else None, **kw)


def _scans(rng, n, shape=(130, 96)):
    return [(rng.standard_normal(shape + (2,)) * 50 + 100).astype(np.float32)
            for _ in range(n)]


def test_batched_program_launches_both_kernels(cuda, rng, monkeypatch):
    """8 scans through one batched fast program: the prefilter runs twice
    on the (8, H, W, 2) stack, along axes 1 and 2, and the fused block as
    often as in one solo scan, each launch on 8 times the solo batch."""
    seen = []
    pf, fb = PF.bspline_prefilter_cuda, FB.fused_norm_act_conv_cuda

    def spy_pf(x, axis):
        seen.append(('prefilter', tuple(x.shape), axis))
        return pf(x, axis)

    def spy_fb(x, *args, **kwargs):
        seen.append(('fused', x.shape[0]))
        return fb(x, *args, **kwargs)

    # the wrappers count their launches on the module's name, the spy here
    spy_pf.launches = spy_fb.launches = 0
    monkeypatch.setattr(PF, 'bspline_prefilter_cuda', spy_pf)
    monkeypatch.setattr(FB, 'fused_norm_act_conv_cuda', spy_fb)
    scans = _scans(rng, 8)
    solo = _ensemble(cuda, True)
    refs = [solo.predict_array(s, (1.0, 1.2)) for s in scans]
    solo.close()
    per_scan = seen[:len(seen) // 8]
    assert per_scan[:2] == [('prefilter', (130, 96, 2), 0),
                            ('prefilter', (130, 96, 2), 1)]
    fused_solo = [s[1] for s in per_scan if s[0] == 'fused']
    assert fused_solo and set(fused_solo) == {4 * 4}  # 4 tiles x 4 mirrors
    seen.clear()
    engine = _ensemble(cuda, True, auto_batch=8)
    try:
        engine.set_batch_linger(60_000.0)
        handles = [engine.predict_array_async(s, (1.0, 1.2)) for s in scans]
        outs = [engine.finish_array(h) for h in handles]
        assert engine._batcher.stats()['batch_occupancy'][7] == 1
    finally:
        engine.close()
    assert seen[:2] == [('prefilter', (8, 130, 96, 2), 1),
                        ('prefilter', (8, 130, 96, 2), 2)]
    fused = [s[1] for s in seen if s[0] == 'fused']
    assert len(fused) == len(fused_solo) and set(fused) == {8 * 16}
    for out, ref in zip(outs, refs):
        assert float((out == ref).mean()) >= 0.99


def test_concurrent_exact_predicts_equal_sequential(cuda, rng):
    """exact_numerics is process-wide: 8 exact predicts on 8 threads at
    once must give bitwise the masks of 8 sequential ones (a thread that
    restored TF32 under another's program would change them)."""
    import threading
    scans = _scans(rng, 8, (160, 120))
    engine = _ensemble(cuda, False)
    try:
        seq = [engine.predict_array(s, (1.0, 1.2)) for s in scans]
        outs = [None] * 8
        start = threading.Barrier(8)

        def run(i):
            start.wait()
            outs[i] = engine.predict_array(scans[i], (1.0, 1.2))

        threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        for a, b in zip(outs, seq):
            np.testing.assert_array_equal(a, b)
        assert torch.backends.cuda.matmul.allow_tf32 is False  # still held
    finally:
        engine.close()


def test_batched_bucket_program_repeats_bitwise(cuda, rng):
    """pad_quantum=64: 8 scans of different extents in one (192, 128)
    bucket ride one batched bucket program (the prefilter once per axis on
    the (8, 192, 128, 2) mirror-extended canvas); two runs give the same
    masks bit for bit, each scan agrees with its solo bucket program."""
    sizes = [(130, 96), (140, 100), (150, 90), (160, 110), (170, 120),
             (180, 70), (190, 125), (129, 65)]
    scans = [(rng.standard_normal(s + (2,)) * 50 + 100).astype(np.float32)
             for s in sizes]
    solo = _ensemble(cuda, True, pad_quantum=64)
    refs = [solo.predict_array(s, (1.0, 1.2)) for s in scans]
    solo.close()
    engine = _ensemble(cuda, True, pad_quantum=64, auto_batch=8)
    try:
        engine.set_batch_linger(60_000.0)
        runs = []
        for _ in range(2):
            before = PF.bspline_prefilter_cuda.launches
            handles = [engine.predict_array_async(s, (1.0, 1.2))
                       for s in scans]
            runs.append([engine.finish_array(h) for h in handles])
            assert PF.bspline_prefilter_cuda.launches == before + 2
        assert engine._batcher.stats()['batch_occupancy'][7] == 2
    finally:
        engine.close()
    for a, b, ref, s in zip(runs[0], runs[1], refs, sizes):
        np.testing.assert_array_equal(a, b)
        assert a.shape == s + (7,)
        assert float((a == ref).mean()) >= 0.99


def test_volume_projection_equals_host_projection(cuda, rng):
    """An int16 volume through the volume program: its projections (the max
    and the exact integer mean) equal the host's bit for bit, and so do the
    masks of the two paths."""
    from totalsegmentator2d_tpu_torch.ops.projection import project_array_np
    vol = np.clip(rng.standard_normal((140, 60, 110)) * 400, -1024,
                  3071).astype(np.int16)
    engine = _ensemble(cuda, False)
    try:
        seg, proj = engine.predict_volume(vol, (1.0, 1.2), ('max', 'mean'))
        host = np.concatenate([project_array_np(vol, m, 1)
                               for m in ('max', 'mean')],
                              axis=1).transpose(0, 2, 1).astype(np.float32)
        np.testing.assert_array_equal(proj, host)
        np.testing.assert_array_equal(seg, engine.predict_array(host,
                                                                (1.0, 1.2)))
    finally:
        engine.close()


def test_native_projection_equals_device_projection(cuda, rng):
    """The native host library's one-pass MAX + MEAN of an int16 volume
    equals the device projection bit for bit."""
    from totalsegmentator2d_tpu_torch.io import native
    from totalsegmentator2d_tpu_torch.ops.projection import (
        project_array, project_arrays_np)
    assert native.native_available()
    vol = np.clip(rng.standard_normal((90, 77, 130)) * 400, -1024,
                  3071).astype(np.int16)
    host = project_arrays_np(vol, ('max', 'mean'), 1)
    dev = torch.from_numpy(vol).to(cuda)
    for h, mode in zip(host, ('max', 'mean')):
        d = project_array(dev, mode, 1).float().cpu().numpy()
        np.testing.assert_array_equal(h, d)


def test_visuals_run_the_prefilter_kernel(cuda, rng):
    """create_visual on the card: an intensity visual resamples at order 3
    (the prefilter kernel, one launch per axis) and equals its CPU render
    within one gray level; a label visual (order 0, no prefilter) equals
    it bit for bit."""
    from totalsegmentator2d_tpu_torch.io import MedicalImage
    from totalsegmentator2d_tpu_torch.ops.visual import create_visual
    vol = np.clip(rng.standard_normal((60, 50, 70)) * 300, -1024,
                  3071).astype(np.int16)
    img = MedicalImage(array=vol, spacing=(0.78, 0.78, 1.25))
    before = PF.bspline_prefilter_cuda.launches
    out = create_visual(img, axis='coronal', device='cuda')
    assert PF.bspline_prefilter_cuda.launches == before + 2
    ref = create_visual(img, axis='coronal', device='cpu')
    diff = np.abs(out.array.astype(int) - ref.array)
    assert out.array.shape == ref.array.shape and diff.max() <= 1
    assert (diff == 0).mean() >= 0.999
    seg = MedicalImage(array=(vol > 200).astype(np.uint8)[..., None]
                       .repeat(3, -1), spacing=(0.78, 0.78, 1.25),
                       is_vector=True)
    before = PF.bspline_prefilter_cuda.launches
    lab = create_visual(seg, labels=True, axis='coronal', device='cuda')
    assert PF.bspline_prefilter_cuda.launches == before
    np.testing.assert_array_equal(
        lab.array, create_visual(seg, labels=True, axis='coronal',
                                 device='cpu').array)


def test_trainer_step_on_the_card(cuda, rng):
    """One augmented Trainer.step at batch 8 (the partitioned warp of 3
    samples): the prefilter kernel launches, the loss is finite, and the
    weights stay fp32 on the card."""
    from totalsegmentator2d_tpu_torch.models.plans import ArchSpec
    from totalsegmentator2d_tpu_torch.training import TrainConfig, Trainer
    from totalsegmentator2d_tpu_torch.training.data import pack_target_np
    arch = ArchSpec(n_stages=4, features_per_stage=(8, 16, 32, 32),
                    kernel_sizes=((3, 3),) * 4,
                    strides=((1, 1), (2, 2), (2, 2), (2, 2)),
                    n_conv_per_stage=(2,) * 4, n_conv_per_stage_decoder=(2,) * 3,
                    in_channels=2, out_channels=5)
    batch = {'image': rng.standard_normal((8, 64, 64, 2)).astype(np.float32),
             'target_packed': pack_target_np(rng.random((8, 64, 64, 5)) > 0.7)}
    for dtype in (None, 'bfloat16'):
        tr = Trainer(arch, TrainConfig(total_steps=4, augment=True,
                                       compute_dtype=dtype), seed=0)
        before = PF.bspline_prefilter_cuda.launches
        loss = tr.step(batch)
        torch.cuda.synchronize()
        assert PF.bspline_prefilter_cuda.launches - before >= 2
        assert loss.is_cuda and bool(torch.isfinite(loss))
        assert all(v.is_cuda and v.dtype == torch.float32
                   for v in tr.params.values())
        tr.close()
