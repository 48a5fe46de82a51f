"""The benchmark's arithmetic: percentiles, spreads, rates, the busy union
and its gaps, the roofline bounds, and the U-Net's operation count against
torch's own counter."""

import statistics

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import arith, reference
from benchmark.profiling import Slice


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
    blocks = arith.fused_launches([32, 64, 128, 256, 512, 512], 2, (256, 256))
    assert len(blocks) == 16 and blocks[0] == (256, 256, 32, 32)


def test_prefilter_bound():
    # the (400, 512, 2) projection: two passes, bytes bound
    t = arith.prefilter_bound_s([(400, 1024), (512, 800)])
    assert t == 2 * 2 * 400 * 512 * 2 * 4 / 3.35e12


@pytest.mark.parametrize('features,h', [((8, 16, 32, 32), 64),
                                        ((4, 8, 16), 32)])
def test_unet_flops_match_torchs_counter(features, h):
    arch = reference.Arch(in_channels=2, out_channels=5, features=features)
    net = reference.RefUNet(arch).eval()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(torch.zeros(1, 2, h, h))
    assert arith.unet_flops(features, 2, 5, h, h) == counter.get_total_flops()
