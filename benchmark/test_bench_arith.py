"""The benchmark's arithmetic: percentiles, spreads, rates, the busy union
and its gaps, the roofline bounds, the U-Net's operation count against
torch's own counter, and the tiles and prefilter passes of CT and 2D
mixes."""

import json
import os
import statistics
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import arith, harness, manifest, reference
from benchmark.profiling import Slice

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize('n', [1, 2, 7, 100, 101])
def test_quantile_is_numpys_linear(n):
    xs = list(np.random.default_rng(n).random(n))
    for q in (0.5, 0.9):
        assert arith.quantile(xs, q) == pytest.approx(np.quantile(xs, q),
                                                      rel=1e-12)


def test_spread_and_rate():
    xs = [1.0, 2.0, 3.0, 4.0, 10.0]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert arith.spread(xs) == (q3 - q1) / q2
    assert arith.rate(30, 12.0) == 2.5
    with pytest.raises(ValueError):
        arith.rate(1, 0.0)


def test_busy_union_and_gaps():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (6.0, 9.0)]
    assert arith.merged(spans) == [(0.0, 2.0), (3.0, 4.0), (6.0, 9.0)]
    assert arith.busy(spans) == 6.0
    assert arith.gaps(spans, -1.0, 7.0) == [(-1.0, 0.0), (2.0, 3.0),
                                            (4.0, 6.0)]
    assert arith.gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def test_slice_reduction():
    s = Slice(0.0, 10.0, [('fused_conv_sm90<1>', 1.0, 2.0),
                          ('prefilter_kernel', 1.5, 3.0),
                          ('Memcpy HtoD', 5.0, 6.0)],
              host=[('aten::copy_', 3.0, 5.0), ('outer', 0.0, 10.0)],
              scans=[0, 1])
    assert s.busy_s == 3.0 and s.window_s == 10.0 and s.launches() == 2
    assert s.device_s(['fused_conv_sm90']) == 1.0
    b = s.breakdown()
    assert b['device_ops'][0] == ['prefilter_kernel', 1.5]
    assert b['idle_gaps'][0] == ['outer', 4.0]       # 6..10
    assert b['idle_gaps'][1] == ['aten::copy_', 2.0]  # 3..5
    assert b['idle_gaps'][2] == ['outer', 1.0]       # 0..1


def test_fused_bound():
    # one launch at N = 16 of the 512-channel 16x16 block: operations bound
    n, h, w, c, co = 16, 16, 16, 512, 512
    flops = 2 * 9 * c * co * n * h * w
    assert arith.fused_bound_s(n, h, w, c, co) == flops / 989e12
    # the 32-channel 256^2 block at N = 16: bytes bound
    nbytes = (16 * 256 * 256 * 64 * 2 + 9 * 32 * 32 * 2 + 16 * 32 * 8 + 32 * 4
              + 16 * 2 * 32 * 4)
    assert arith.fused_bound_s(16, 256, 256, 32, 32) == nbytes / 3.35e12
    # the flagship's 16 fused blocks a forward (80 a scan over 5 groups)
    flagship = reference.Arch(2, 24, (32, 64, 128, 256, 512, 512))
    blocks = arith.fused_launches(flagship, (256, 256))
    assert len(blocks) == 16 and blocks[0] == (256, 256, 32, 32)


def test_prefilter_bound():
    # the (400, 512, 2) projection: two passes, bytes bound
    t = arith.prefilter_bound_s([(400, 1024), (512, 800)])
    assert t == 2 * 2 * 400 * 512 * 2 * 4 / 3.35e12


@pytest.mark.parametrize('arch,h', [
    (reference.Arch(2, 5, (8, 16, 32, 32)), 64),
    (reference.Arch(2, 5, (4, 8, 16)), 32),
    (reference.Arch(2, 5, (4, 8, 16), n_conv=3), 32),
    (reference.ResArch(2, 5, (4, 8, 16), (1, 2, 2), 1), 32),
    # a strided block that keeps its channels: its skip pools, no 1x1 conv
    (reference.ResArch(1, 5, (8, 16, 16, 32), (2, 1, 3, 2), 2), 64),
])
def test_unet_flops_match_torchs_counter(arch, h):
    net = reference.network(arch).eval()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(torch.zeros(1, arch.in_channels, h, h))
    assert arith.unet_flops(arch, h, h) == counter.get_total_flops()


def test_fused_launches_of_a_residual_net_by_hand():
    """ResEnc (8, 16, 32) with blocks (1, 2, 2) and one decoder conv at
    32^2: every conv2, a stride-1 conv1 of 16 or more channels, and the
    decoder's convs; never the stem (2 channels), a strided conv1, a skip's
    1x1 or the head."""
    arch = reference.ResArch(2, 3, (8, 16, 32), (1, 2, 2), 1)
    assert arith.fused_launches(arch, (32, 32)) == [
        (32, 32, 8, 8),                                # stage 0: conv2
        (16, 16, 16, 16),                              # stage 1, 0: conv2
        (16, 16, 16, 16), (16, 16, 16, 16),            # stage 1, 1
        (8, 8, 32, 32),                                # stage 2, 0: conv2
        (8, 8, 32, 32), (8, 8, 32, 32),                # stage 2, 1
        (16, 16, 32, 16), (32, 32, 16, 8)]             # the decoder


def _cell(config, mix):
    return SimpleNamespace(config=config, traffic=mix)


def test_2d_tiles_by_hand():
    """A detector-size radiograph cropped to its collimation: the crop's
    tiles at its spacing, counted here by hand from the sliding steps."""
    config = json.load(open(os.path.join(ROOT, 'benchmark', 'configs',
                                         'ts2d-v2-fast.json')))
    mix = {'spacing_xy': [0.148, 0.16], 'volumes': [[2544, 3056]]}
    image = np.zeros((2544, 3056), np.int16)
    image[70:2470, 100:3000] = 1
    assert harness.extent(image) == (2400, 2900)
    # rows at 0.16 mm, cols at 0.148 mm, to 1.5 mm: 256 x 286, one tile
    # high, two across
    rs = (round(2400 * 0.16 / 1.5), round(2900 * 0.148 / 1.5))
    assert rs == (256, 286)
    want = (len(reference.sliding_steps(256, 256, 0.5))
            * len(reference.sliding_steps(286, 256, 0.5)))
    assert want == 2
    assert harness.tiles(_cell(config, mix), (2400, 2900)) == want
    # 0.4 mm: 640 x 773, 4 x 6 tiles
    mix['spacing_xy'] = [0.4, 0.4]
    assert harness.tiles(_cell(config, mix), (2400, 2900)) == (
        len(reference.sliding_steps(640, 256, 0.5))
        * len(reference.sliding_steps(773, 256, 0.5))) == 24
    # a CT volume's extent is its coronal projection's, whole
    assert harness.extent(np.zeros((300, 512, 480), np.int16)) == (300, 480)


def _old_prefilter_bound(mix, v, channels):
    """The formula of the CT-only benchmark, kept to compare with."""
    z, _, x = mix['volumes'][v]
    return arith.prefilter_bound_s([(z, x * channels), (x, z * channels)])


@pytest.mark.parametrize('traffic', ['solo', 'cohort8', 'cohort8-mixed'])
@pytest.mark.parametrize('config', ['ts2d-v2-fast', 'ts2d-v2-exact'])
def test_prefilter_roofline_of_a_ct_mix_is_the_old_formulas(traffic, config):
    cfg = json.load(open(os.path.join(ROOT, 'benchmark', 'configs',
                                      f'{config}.json')))
    mix = json.load(open(os.path.join(ROOT, 'benchmark', 'traffic',
                                      f'{traffic}.json')))
    read = manifest.reader(ROOT, 'prefilter_roofline')
    extents = [(z, x) for z, _, x in mix['volumes']]
    sp = reference.spacing_yx(mix['spacing_xyz'])
    for v, e in enumerate(extents):
        got = arith.prefilter_bound_s(read.__globals__['passes'](e, sp, cfg))
        assert got == _old_prefilter_bound(mix, v, len(cfg['channels']))
    scans = list(range(len(extents))) * 2
    run = SimpleNamespace(
        cell=_cell(cfg, mix), extents=extents,
        slice=Slice(0.0, 1.0, [('prefilter_kernel', 0.0, 0.25)], host=[],
                    scans=scans))
    old = 0.0
    for v in scans:
        old += _old_prefilter_bound(mix, v, len(cfg['channels']))
    assert read(run) == 100.0 * old / 0.25


def test_prefilter_roofline_of_a_2d_mix():
    """Two passes over a radiograph's (rows, cols x 1) and (cols, rows x 1)
    crop; none along an axis the down-resample leaves alone."""
    cfg = json.load(open(os.path.join(ROOT, 'benchmark', 'configs',
                                      'ts2d-v2-fast.json')))
    cfg['channels'] = ['xray']
    passes = manifest.reader(ROOT, 'prefilter_roofline').__globals__[
        'passes']
    assert passes((2400, 2900), (0.148, 0.148), cfg) == [(2400, 2900),
                                                         (2900, 2400)]
    assert passes((300, 200), (1.5, 0.5), cfg) == [(200, 300)]
    mix = {'spacing_xy': [0.148, 0.148], 'volumes': [[2544, 3056]]}
    run = SimpleNamespace(
        cell=_cell(cfg, mix), extents=[(2400, 2900)],
        slice=Slice(0.0, 1.0, [('prefilter_kernel', 0.0, 0.001)], host=[],
                    scans=[0]))
    want = 2 * 2 * 2400 * 2900 * 4 / 3.35e12       # bytes bound
    assert manifest.reader(ROOT, 'prefilter_roofline')(run) == \
        pytest.approx(100.0 * want / 0.001, rel=1e-12)


def test_one_channel_network_counts():
    """At one input channel stage 0's first conv is not fused (C < 16) and
    its operations are counted at C = 1, as torch counts them."""
    features = (32, 64, 128, 256, 512, 512)
    blocks = arith.fused_launches(reference.Arch(1, 24, features), (256, 256))
    assert len(blocks) == 16 and blocks[0] == (256, 256, 32, 32)
    assert arith.fused_launches(reference.Arch(16, 24, features),
                                (256, 256))[0] == (256, 256, 16, 32)
    arch = reference.Arch(in_channels=1, out_channels=24,
                          features=(8, 16, 32, 32))
    net = reference.RefUNet(arch).eval()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(torch.zeros(1, 1, 64, 64))
    assert arith.unet_flops(arch, 64, 64) == counter.get_total_flops()
    config = {'mirror_axes': [0, 1], 'folds': [0], 'patch_size': [64, 64],
              'features_per_stage': [8, 16, 32, 32], 'n_conv_per_stage': 2,
              'channels': ['xray'], 'groups': {'a': 24, 'b': 24}}
    mfu = manifest.reader(ROOT, 'step_mfu_pct').__globals__
    assert mfu['flops_per_scan'](config, 3) == 3 * 4 * 2 * \
        counter.get_total_flops()
