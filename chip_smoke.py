"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; the result lines print only at the end):

1. Device info: the card (nvidia-smi), CUDA, nvcc; builds every kernel from
   the sources in the checkout, all at once.
2. Every kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it and at edge shapes, with bitwise-repeat
   checks; kernel, plain and library-yardstick times with CUDA events, and
   each kernel's bound at those shapes. The prefilter kernel must equal its
   chunked plain version bit for bit and agree with the sequential one
   (rtol 1e-5 / atol 1e-6), the reference formula and scipy; it is timed
   at the main path's pair of launches and at the batch-8 pair, beside two
   empty launches (the launch floor). Times are eager per call (CUDA
   events over back-to-back calls, the host's launch work included), the
   fused block's library yardstick the best of 3 rounds under cuDNN's
   benchmark mode; beside them each kernel's device time (a CUDA graph of
   back-to-back calls, replayed), the fused block's tile and each
   instantiation's registers, shared memory and blocks per SM.
3. The main paths at full width: ``TS2D(...).predict(scan)`` with a random
   5-group / 117-label flagship ensemble (6-stage nnU-Net, features
   32..512, patch 256^2) on a clinical-spacing torso phantom CT
   (400x512x512 at 1.25x0.78x0.78 mm, so both projection axes resample).
   First at precision 'exact' (fp32), then at 'fast' (bf16 U-Nets through
   the fused block kernel); each with the kernels' launch counts set to 0
   just before one scan and read just after, the blocking seconds per scan
   and a breakdown of one scan (host, engine, U-Net forwards eager, best
   of 3 rounds, and in device time by CUDA-graph replay, a profiler
   trace). The exact result is saved and read back; two fast scans must
   give the same masks, and the fast/exact mask agreement is printed.
4. The port on the GPU against the port on the CPU (plain kernel versions)
   at a reduced architecture: mask agreement >= 0.999 exact, >= 0.99 fast.
5. A set whose groups disagree on precision, through the per-model engines
   on the card: both kernels must run.
6. One JSON line with every kernel, then the card line, then the device
   line.

Needs nothing but the repository, PyTorch with CUDA, numpy, scipy and the
CUDA toolkit; imports nothing of the JAX package.
"""

import sys

import torch

if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device available', file=sys.stderr)
    sys.exit(1)

import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import scipy.ndimage as ndi  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from totalsegmentator2d_tpu_torch.api import TS2D  # noqa: E402
from totalsegmentator2d_tpu_torch.io import MedicalImage, read_image  # noqa: E402
from totalsegmentator2d_tpu_torch.models.unet import UNet  # noqa: E402
from totalsegmentator2d_tpu_torch.models.plans import parse_model_spec  # noqa: E402
from totalsegmentator2d_tpu_torch.ops.cuda import build  # noqa: E402
from totalsegmentator2d_tpu_torch.ops.cuda import fused_block as FB  # noqa: E402
from totalsegmentator2d_tpu_torch.ops.cuda import prefilter as PF  # noqa: E402
from totalsegmentator2d_tpu_torch.ops.geometry import reorient  # noqa: E402
from totalsegmentator2d_tpu_torch.ops.projection import project_multi  # noqa: E402
from totalsegmentator2d_tpu_torch.utils.config import get_label_colors  # noqa: E402
from totalsegmentator2d_tpu_torch.utils.device import exact_numerics  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, 'build', 'chip_smoke')   # ignored by git

# published H100 SXM peaks (NVIDIA data sheet): HBM, fp32 outside the
# tensor cores, dense bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
FAST = {'nnu.predict.precision': 'fast'}

# the flagship group architecture (6-stage nnU-Net PlainConvUNet at 256^2,
# the ts2d-v2 group-model shape)
FLAGSHIP = dict(n_stages=6, features=(32, 64, 128, 256, 512, 512),
                patch=(256, 256), spacing=(1.5, 1.5))
GROUPS = {'cardiac': 24, 'muscles': 21, 'organs': 22, 'ribs': 24,
          'vertebrae': 26}
# reduced architecture for the GPU-vs-CPU comparison
SMALL = dict(n_stages=4, features=(8, 16, 32, 32), patch=(64, 64),
             spacing=(1.5, 1.5))


def phase(name):
    print(f'== {name}', flush=True)


def reset_launches():
    PF.bspline_prefilter_cuda.launches = 0
    FB.fused_norm_act_conv_cuda.launches = 0


def read_launches():
    return {'bspline_prefilter': PF.bspline_prefilter_cuda.launches,
            'fused_norm_act_conv': FB.fused_norm_act_conv_cuda.launches}


def cuda_ms(fn, iters):
    """Mean milliseconds of fn() over iters launches, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- 1. device info and build ------------------------------------------------

def device_info():
    phase('device')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([build.nvcc_path(), '--version'], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f'card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; '
          f'{nvcc}')
    t0 = time.perf_counter()
    libs = build.build()
    print(f'built {sorted(libs)} in {time.perf_counter() - t0:.2f} s')
    return smi


# -- 2. kernels against their plain versions ----------------------------------

def prefilter_reference(x, axis):
    """The reference package's prefilter formula in float64 numpy (its
    ``bspline_prefilter_1d``): a causal-init series of min(18, 2n-2) taps
    over the mirrored line, then the causal and anticausal passes."""
    x = np.moveaxis(np.asarray(x, np.float64), axis, 0)
    n = x.shape[0]
    z = np.sqrt(3.0) - 2.0
    gain = (1.0 - z) * (1.0 - 1.0 / z)
    period = 2 * n - 2
    acc = x[0].copy()
    for k in range(1, min(PF.HORIZON, period) + 1):
        m = k % period
        acc += z ** k * x[m if m < n else period - m]
    s = np.empty_like(x)
    s[0] = gain * acc
    for i in range(1, n):
        s[i] = gain * x[i] + z * s[i - 1]
    c = np.empty_like(x)
    c[n - 1] = z / (z * z - 1.0) * (z * s[n - 2] + s[n - 1])
    for i in range(n - 2, -1, -1):
        c[i] = z * (c[i + 1] - s[i])
    return np.moveaxis(c, 0, axis)


def prefilter_bound_ms(passes):
    """The least time of prefilter passes [(n, lines), ...], in ms: each
    pass reads x once and writes y once; its operations (5 per sample and
    the init series) go at the fp32 rate. Returns (bound, 'bytes' or
    'operations')."""
    nbytes = sum(2 * n * lines * 4 for n, lines in passes)
    flops = sum(lines * (5 * n + 2 * PF.HORIZON) for n, lines in passes)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops else 'operations'


# edge shapes of the kernel's chunking (chunk L = 32, warm-up H = 18): n =
# 2, 3, 4, 9, L-1, L, L+1, H+L, 2L+H+3 at inner = 1, 2, 33 and odd line
# counts; a 3-D array along each axis; a line of 20000 samples at inner 2
# (its slab exceeds shared memory: the global path)
PREFILTER_EDGES = [((2, 77), 0), ((3, 41), 0), ((4, 45), 0), ((13, 1001), 0),
                   ((37, 19), 1), ((9, 10, 11), 0), ((9, 10, 11), 1),
                   ((9, 10, 11), 2), ((5, 9, 2), 1), ((31, 33), 0),
                   ((32, 45), 0), ((33, 1), 0), ((3, 33, 2), 1), ((50, 33), 0),
                   ((3, 85, 1), 1), ((3, 85, 2), 1), ((85, 33), 0),
                   ((13, 1001), 1), ((3, 20000, 2), 1)]


def check_prefilter():
    phase('kernel: bspline_prefilter')
    gen = torch.Generator().manual_seed(0)
    worst = 0.0

    def compare(x, axis, reference=True):
        nonlocal worst
        y = PF.bspline_prefilter_cuda(x, axis)
        torch.cuda.synchronize()
        if not torch.equal(y, PF.bspline_prefilter_cuda(x, axis)):
            raise SystemExit('prefilter kernel is not bitwise repeatable')
        if not torch.equal(y, PF.bspline_prefilter_chunked_plain(x, axis)):
            raise SystemExit(f'prefilter kernel differs from its chunked plain '
                             f'version at {tuple(x.shape)} axis {axis}')
        plain = PF.bspline_prefilter_plain(x, axis)
        torch.testing.assert_close(y, plain, rtol=1e-5, atol=1e-6)
        if reference:
            out, xs = y.cpu().numpy(), x.cpu().numpy()
            np.testing.assert_allclose(out, prefilter_reference(xs, axis),
                                       rtol=1e-4, atol=1e-5)
            if x.shape[axis] >= 10:  # the reference's series meets scipy's
                ref = ndi.spline_filter1d(xs.astype(np.float64), order=3,
                                          axis=axis, mode='mirror')
                np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
        worst = max(worst, float((y - plain).abs().max()))
        return y

    # the main path: the (H, W, C=2) projection along axis 0, then axis 1;
    # the batch-8 shape of the micro-batching program along axes 1 and 2
    x = torch.randn((400, 512, 2), generator=gen).cuda()
    compare(compare(x, 0), 1)
    xb = torch.randn((8, 400, 512, 2), generator=gen).cuda()
    compare(compare(xb, 1), 2)
    for shape, axis in PREFILTER_EDGES:
        # the float64 reference loop is slow at 20000 samples: the plain
        # versions hold that one
        compare(torch.randn(shape, generator=gen).cuda(), axis,
                reference=shape[axis] < 20000)
    print(f'kernel == chunked plain bitwise at every shape; max |kernel - '
          f'sequential plain| = {worst:.3g}')

    def pair(t, axes, fn):
        return lambda: fn(fn(t, axes[0]), axes[1])

    # library yardstick: the dense n x n prefilter matrix (the filter of the
    # identity) applied by one batched matmul per axis, fp32 without TF32
    mats = {n: PF.bspline_prefilter_plain(torch.eye(n, device='cuda'), 0)
            for n in (400, 512)}

    def library():
        a = torch.matmul(mats[400], x.view(1, 400, 1024))
        return torch.matmul(mats[512], a.view(400, 512, 2))

    def library_b8():
        a = torch.matmul(mats[400], xb.view(8, 400, 1024))
        return torch.matmul(mats[512], a.view(3200, 512, 2)).view(xb.shape)

    def empty_pair():  # the launch floor: two empty kernels
        torch.cuda._sleep(0)
        torch.cuda._sleep(0)

    res = {}
    with exact_numerics():
        torch.testing.assert_close(library(), pair(x, (0, 1), PF.prefilter_axis)(),
                                   rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(library_b8(),
                                   pair(xb, (1, 2), PF.prefilter_axis)(),
                                   rtol=1e-4, atol=1e-5)
        floor_ms, floor_dev = cuda_ms(empty_pair, 200), device_ms(empty_pair, 50)
        for name, t, axes, lib, passes in (
                ('main', x, (0, 1), library, ((400, 1024), (512, 800))),
                ('batch8', xb, (1, 2), library_b8, ((400, 8192), (512, 6400)))):
            kernel = pair(t, axes, PF.bspline_prefilter_cuda)
            bound, by = prefilter_bound_ms(passes)
            res[name] = {'ms': cuda_ms(kernel, 200),
                         'device_ms': device_ms(kernel, 50),
                         'plain_ms': cuda_ms(pair(t, axes, PF.bspline_prefilter_plain), 3),
                         'library_ms': cuda_ms(lib, 100),
                         'bound_ms': bound, 'bound_by': by}
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for name, r in res.items():
        where = ('(400, 512, 2) axes 0, 1' if name == 'main'
                 else '(8, 400, 512, 2) axes 1, 2')
        print(f'prefilter {name} pair {where}: kernel {r["ms"]:.4f} ms eager, {r["device_ms"]:.4f} ms device '
              f'({r["bound_ms"] / r["device_ms"]:.1%} of bound); plain '
              f'{r["plain_ms"]:.4f} ms, library {r["library_ms"]:.4f} ms, '
              f'bound {r["bound_ms"]:.5f} ms ({r["bound_by"]})')
    print(f'launch floor, two empty kernels (torch.cuda._sleep(0)): '
          f'{floor_ms:.4f} ms eager, {floor_dev:.4f} ms device')
    main = res['main']
    return {'name': 'bspline_prefilter', 'route': 'cuda',
            'source': 'totalsegmentator2d_tpu_torch/csrc/prefilter.cu',
            'replaces': 'totalsegmentator2d_tpu/ops/pallas/prefilter.py:36',
            'max_abs_err': worst, 'ms': main['ms'],
            'device_ms': main['device_ms'], 'launch_floor_ms': floor_dev,
            'launch_floor_eager_ms': floor_ms, 'plain_ms': main['plain_ms'],
            'bound_ms': main['bound_ms'], 'bound_by': main['bound_by'],
            'library_ms': main['library_ms'],
            'batch8': {k: res['batch8'][k] for k in
                       ('ms', 'device_ms', 'plain_ms', 'library_ms', 'bound_ms')}}


def fused_launches(arch, in_channels=2):
    """(H, W, C, Cout, apply_normact) of every fused-kernel launch of one
    fast U-Net forward at the patch size: the route rule of
    ``ConvStack._forward_fused`` (a stack's first block through the kernel
    without normact when its stride is 1 and C >= 16; every later block
    with normact) over the flagship layout (2 blocks per stage)."""
    feats, n = arch['features'], arch['n_stages']
    h, w = arch['patch']
    out, cin = [], in_channels
    for s in range(n):
        hs, ws = h >> s, w >> s
        if s == 0 and cin >= 16:
            out.append((hs, ws, cin, feats[s], False))
        out.append((hs, ws, feats[s], feats[s], True))
        cin = feats[s]
    for e in range(n - 1, 0, -1):
        hs, ws, cs = h >> (e - 1), w >> (e - 1), feats[e - 1]
        out += [(hs, ws, 2 * cs, cs, False), (hs, ws, cs, cs, True)]
    return out


def fused_bounds_ms(N, H, W, C, Co):
    """The two least times of one launch, in ms: its bytes (x, w, scale,
    shift, b read once; y, stats written once) over HBM, and its bf16
    operations over the tensor cores. The bound is the larger."""
    nbytes = (N * H * W * (C + Co) * 2 + 9 * C * Co * 2 + N * C * 8 + Co * 4
              + N * 2 * Co * 4)
    flops = 2 * 9 * C * Co * N * H * W
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3


def device_ms(fn, iters):
    """Device milliseconds of one fn() call, without the host's launch
    overhead: fn() once eagerly (warm-up, and any algorithm search), then a
    CUDA graph of `iters` calls, replayed once untimed and once timed by
    CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


# edge shapes of the kernel's tiling and padding: W below the tile width,
# H and W not multiples of the tile, N = 1, channel counts it takes only
# zero-padded (C = 3, 8, 16, 24; Cout = 5, 40, 100)
FUSED_EDGES = [(2, 9, 8, 8, 8, True), (2, 9, 8, 8, 8, False),
               (1, 13, 8, 24, 40, True), (2, 7, 5, 3, 5, True),
               (3, 11, 9, 16, 100, False), (2, 20, 5, 32, 32, True),
               (2, 12, 12, 64, 64, True), (2, 37, 45, 64, 128, True),
               (1, 19, 23, 32, 32, False), (2, 9, 11, 16, 100, True),
               (2, 5, 7, 3, 100, True), (2, 37, 45, 32, 32, True),
               (1, 40, 5, 64, 32, False)]


def check_fused_block():
    phase('kernel: fused_norm_act_conv')
    gen = torch.Generator().manual_seed(1)
    batch = 16  # the main path's forward batch: 4 tiles x 4 mirrors

    def operands(N, H, W, C, Co):
        x = torch.randn((N, H, W, C), generator=gen).cuda().to(torch.bfloat16)
        sc = (torch.rand((N, C), generator=gen) + 0.5).cuda()
        sh = (torch.randn((N, C), generator=gen) * 0.3).cuda()
        w = (torch.randn((3, 3, C, Co), generator=gen) * (2.0 / (9 * C)) ** 0.5)
        b = (torch.randn((Co,), generator=gen) * 0.1).cuda()
        return x, sc, sh, FB.pack_weight(w.cuda()), b

    def check(args, act):
        """The kernel against its plain version, and two runs bitwise."""
        y, st = FB.fused_norm_act_conv_cuda(*args, apply_normact=act)
        y2, st2 = FB.fused_norm_act_conv_cuda(*args, apply_normact=act)
        torch.cuda.synchronize()
        if not (torch.equal(y, y2) and torch.equal(st, st2)):
            raise SystemExit(f'fused block not bitwise repeatable at '
                             f'{tuple(args[0].shape)}')
        ry, rst = FB.fused_norm_act_conv_plain(*args, apply_normact=act)
        torch.testing.assert_close(y.float(), ry.float(), rtol=0.05, atol=0.05)
        torch.testing.assert_close(st, rst, rtol=0.03, atol=0.5)
        return y, float((y.float() - ry.float()).abs().max())

    per_forward = fused_launches(FLAGSHIP)
    shapes = sorted(set(per_forward), key=lambda t: (-t[0], t[2], t[4]))
    worst, per_shape = 0.0, {}
    for N, H, W, C, Co, act in FUSED_EDGES:
        _, err = check(operands(N, H, W, C, Co), act)
        worst = max(worst, err)
        print(f'edge {(N, H, W, C, Co, act)}: max |y - plain| {err:.4g}')
    for H, W, C, Co, act in shapes:
        N = batch
        args = operands(N, H, W, C, Co)
        y, err = check(args, act)
        worst = max(worst, err)
        w_oihw = args[3].permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        b16 = args[4].to(torch.bfloat16)

        def library():
            # cuDNN's bf16 conv (channels_last) + torch normact + stats sum
            z = args[0].float()
            if act:
                z = z * args[1][:, None, None, :] + args[2][:, None, None, :]
                z = torch.where(z >= 0, z, z * 0.01)
            out = F.conv2d(z.to(torch.bfloat16).permute(0, 3, 1, 2), w_oihw,
                           b16, padding=1)
            o32 = out.float()
            return out, torch.stack([o32.sum(dim=(2, 3)),
                                     o32.square().sum(dim=(2, 3))], dim=1)

        def kernel():
            return FB.fused_norm_act_conv_cuda(*args, apply_normact=act)

        with torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                        deterministic=False, allow_tf32=False):
            ly, _ = library()
            torch.testing.assert_close(ly.permute(0, 2, 3, 1).float(),
                                       y.float(), rtol=0.05, atol=0.05)
            ms = cuda_ms(kernel, 20)
            dev_ms = device_ms(kernel, 20)
            plain_ms = cuda_ms(lambda: FB.fused_norm_act_conv_plain(
                *args, apply_normact=act), 3)
            rounds = [cuda_ms(library, 20) for _ in range(3)]
            library_ms = min(rounds)
        t_bytes, t_ops = fused_bounds_ms(N, H, W, C, Co)
        bound = max(t_bytes, t_ops)
        per_shape[(H, W, C, Co, act)] = (ms, plain_ms, library_ms, t_bytes,
                                         t_ops, dev_ms)
        info = FB.kernel_info(N, H, W, C, Co)
        flop = 2 * 9 * C * Co * N * H * W
        print(f'{(N, H, W, C, Co, "normact" if act else "conv")}: kernel '
              f'{ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s, {bound / ms:.1%} '
              f'of bound; device {dev_ms:.4f} ms, {flop / dev_ms / 1e9:.1f} '
              f'TFLOP/s, {bound / dev_ms:.1%}), plain {plain_ms:.4f}, '
              f'library {library_ms:.4f} (rounds '
              f'{[round(r, 4) for r in rounds]}), bound {bound:.5f} ms '
              f'({"bytes" if t_bytes > t_ops else "operations"}), '
              f'max |y - plain| {err:.4g}')
        print(f'  tile: BN {info["bn"]}, {info["tile_pixels"]} pixels, '
              f'{info["units"]} units on {info["grid"]} blocks, resident '
              f'weights {info["resident_weights"]}; {info["registers"]} '
              f'registers/thread at entry, shared {info["static_smem"]} '
              f'static + {info["dynamic_smem"]} dynamic bytes, '
              f'{info["local_bytes"]} local bytes, {info["blocks_per_sm"]} '
              f'block(s)/SM')

    # give the graphs' memory pools back, so the main paths that follow
    # allocate as they would alone
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # one scan: 5 groups x one forward of the 16-tile batch
    per_scan = [per_shape[sh] for sh in per_forward for _ in GROUPS]
    ms, plain_ms, library_ms = (sum(t[i] for t in per_scan) for i in range(3))
    dev_ms = sum(t[5] for t in per_scan)
    bound = sum(max(t[3], t[4]) for t in per_scan)
    by_ops = sum(t[4] for t in per_scan) > sum(t[3] for t in per_scan)
    print(f'fused block, one scan ({len(per_scan)} launches): kernel '
          f'{ms:.4f} ms ({bound / ms:.1%} of bound; device {dev_ms:.4f} ms, '
          f'{bound / dev_ms:.1%}), plain {plain_ms:.4f} ms, library '
          f'{library_ms:.4f} ms, bound {bound:.4f} ms; max |y - plain| '
          f'{worst:.4g}')
    return {'name': 'fused_norm_act_conv', 'route': 'cuda',
            'source': 'totalsegmentator2d_tpu_torch/csrc/fused_block.cu',
            'replaces': 'totalsegmentator2d_tpu/ops/pallas/fused_block.py:56',
            'max_abs_err': worst, 'ms': ms, 'device_ms': dev_ms,
            'plain_ms': plain_ms,
            'bound_ms': bound, 'bound_by': 'operations' if by_ops else 'bytes',
            'library_ms': library_ms}, len(per_scan)


# -- the synthetic model database -------------------------------------------

def write_database(root, model, groups, arch, seed, precision='exact'):
    """nnU-Net results trees with random UNet weights, written by the port;
    ``precision`` is one for all groups or a {group: precision} map."""
    names = iter(get_label_colors())
    for i, (group, n_labels) in enumerate(groups.items()):
        labels = [next(names) for _ in range(n_labels)]
        n = arch['n_stages']
        plans = {'configurations': {'2d': {
            'patch_size': list(arch['patch']), 'spacing': list(arch['spacing']),
            'normalization_schemes': ['ZScoreNormalization'] * 2,
            'use_mask_for_norm': [False, False],
            'architecture': {'arch_kwargs': {
                'n_stages': n, 'features_per_stage': list(arch['features']),
                'kernel_sizes': [[3, 3]] * n,
                'strides': [[1, 1]] + [[2, 2]] * (n - 1),
                'n_conv_per_stage': [2] * n,
                'n_conv_per_stage_decoder': [2] * (n - 1),
                'conv_bias': True,
                'norm_op_kwargs': {'eps': 1e-05, 'affine': True},
                'nonlin_kwargs': {'inplace': True}}}}}}
        dataset = {'channel_names': {'0': 'max', '1': 'mean'},
                   'labels': {'background': 0,
                              **{nm: j + 1 for j, nm in enumerate(labels)}},
                   'file_ending': '.nrrd', 'multilabel': True}
        base = os.path.join(root, f'{model}_{group}', 'r001')
        data_dir = os.path.join(base, f'Dataset{200 + i}_{group}',
                                'nnUNetTrainer__nnUNetPlans__2d')
        os.makedirs(os.path.join(data_dir, 'fold_0'), exist_ok=True)
        with open(os.path.join(base, 'model.json'), 'w') as f:
            prec = precision if isinstance(precision, str) else precision[group]
            json.dump({'param': {'nnu': {'configuration': '2d', 'folds': [0],
                                         'predict': {'precision': prec}}}},
                      f)
        for fn, obj in (('plans.json', plans), ('dataset.json', dataset)):
            with open(os.path.join(data_dir, fn), 'w') as f:
                json.dump(obj, f)
        spec = parse_model_spec(plans, dataset).arch
        torch.manual_seed(seed + i)
        torch.save({'network_weights': UNet(spec).state_dict(),
                    'inference_allowed_mirroring_axes': [0, 1],
                    'trainer_name': 'nnUNetTrainer'},
                   os.path.join(data_dir, 'fold_0', 'checkpoint_final.pth'))


def torso_ct(shape_zyx, spacing_xyz, seed):
    """int16 torso phantom: air, an elliptic body tapering along z, two
    lungs, a spine column with vertebral banding, rib shell bands, noise."""
    z, y, x = shape_zyx
    rng = np.random.default_rng(seed)
    zc = (np.arange(z, dtype=np.float32) / max(z - 1, 1))[:, None, None]
    yy = np.arange(y, dtype=np.float32)[None, :, None]
    xx = np.arange(x, dtype=np.float32)[None, None, :]
    taper = 0.85 + 0.3 * np.sin(zc * np.pi)
    r2 = (((yy - y * 0.52) / (y * 0.38 * taper)) ** 2
          + ((xx - x * 0.50) / (x * 0.42 * taper)) ** 2)
    body = r2 <= 1.0
    noise = rng.standard_normal(shape_zyx, dtype=np.float32)
    vol = np.where(body, 35 + 25 * np.sin(zc * 7.0) + 12 * noise, -1024.0)
    for side in (-1, 1):
        lung = ((((zc * (z - 1) - z * 0.30) / (z * 0.22)) ** 2
                 + ((yy - y * 0.42) / (y * 0.20)) ** 2
                 + ((xx - x * (0.5 + side * 0.18)) / (x * 0.16)) ** 2)
                <= 1.0) & body
        vol = np.where(lung, -820 + 25 * noise, vol)
    spine = ((((yy - y * 0.78) / (y * 0.07)) ** 2
              + ((xx - x * 0.5) / (x * 0.10)) ** 2) <= 1.0) & body
    vert = 650 + 350 * (np.sin(zc * (z - 1) / 3.4) > 0)
    vol = np.where(spine, vert + 40 * noise, vol)
    shell = (r2 >= 0.82) & body & (np.sin(zc * (z - 1) / 2.1) > 0.3)
    vol = np.where(shell, 420 + 60 * noise, vol)
    arr = np.clip(np.round(vol), -1024, 3071).astype(np.int16)
    return MedicalImage(array=arr, spacing=spacing_xyz)


# -- 3. the main paths at full width ------------------------------------------

def main_path(db, scan, precision, fused_per_scan):
    """One precision's main path: launches around one scan, its result, the
    blocking seconds per scan and a breakdown. Returns (launches, masks)."""
    fast = precision == 'fast'
    phase(f'main path ({precision}): TS2D.predict, 5 groups / 117 labels, '
          f'flagship arch')
    expect = {'bspline_prefilter': 2,
              'fused_norm_act_conv': fused_per_scan if fast else 0}
    with TS2D(key='ts2d-v9-flagship', use_remote=False, local=db,
              param=FAST if fast else None) as tool:
        if tool._fused is None or (tool._fused.compute_dtype is not None) != fast:
            raise SystemExit(f'the {precision} set did not fuse as expected')
        reset_launches()
        res = tool.predict(scan)
        torch.cuda.synchronize()
        launches = read_launches()
        print(f'launches on one scan: {launches}')
        if launches != expect:
            raise SystemExit(f'kernel launches per scan {launches}, expected '
                             f'{expect}')

        seg = res.get_segmentation()
        if seg.ncomponents != 117 or seg.array.shape != (400, 1, 512, 117):
            raise SystemExit(f'unexpected segmentation {seg.array.shape}')
        if not 0 < seg.array.mean() < 1:
            raise SystemExit('segmentation is empty or full')
        if fast:
            again = tool.predict(scan).get_segmentation().array
            if not np.array_equal(again, seg.array):
                raise SystemExit('two fast predicts of one scan differ')
            print('two fast predicts of the scan: identical masks')
        else:
            save_and_read_back(res)

        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(5):
            reset_launches()
            t0 = time.perf_counter()
            tool.predict(scan)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if read_launches() != expect:
                raise SystemExit(f'kernel launches per scan {read_launches()}')
        print(f'blocking s/scan ({precision}): median '
              f'{float(np.median(times)):.4f} (runs '
              f'{[round(t, 4) for t in times]}); peak device memory '
              f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
        breakdown(tool, scan, fast)
    return launches, seg.array


def save_and_read_back(res):
    seg = res.get_segmentation()
    out = os.path.join(WORK, 'out')
    res.save(out, name='scan', targets=['segmentation', 'projection'])
    files = sorted(os.listdir(out))
    if files != ['scan.seg.nrrd', 'scan_max.nrrd', 'scan_mean.nrrd']:
        raise SystemExit(f'unexpected saved files {files}')
    back = read_image(os.path.join(out, 'scan.seg.nrrd'))
    if not (np.array_equal(back.array, seg.array) and back.meta == seg.meta):
        raise SystemExit('saved segmentation does not read back equal')
    for ch in ('max', 'mean'):
        pb = read_image(os.path.join(out, f'scan_{ch}.nrrd'))
        if not np.array_equal(pb.array, res.get_projection(ch).array):
            raise SystemExit(f'saved {ch} projection does not read back equal')
    print(f'saved and read back: {files}')


def conv_flops(arch, h, w):
    """Multiply-add operations x 2 of one UNet forward on an h x w input
    (the convs, transposed convs and the last seg head)."""
    feats, n = arch['features'], arch['n_stages']
    total, cin, res = 0, 2, []
    for s in range(n):
        h, w = (h, w) if s == 0 else (h // 2, w // 2)
        total += 2 * 9 * (cin * feats[s] + feats[s] * feats[s]) * h * w
        cin = feats[s]
        res.append((h, w))
    for s in range(n - 1, 0, -1):
        (h, w), cskip = res[s - 1], feats[s - 1]
        total += 2 * feats[s] * cskip * h * w              # transposed conv
        total += 2 * 9 * (2 * cskip * cskip + cskip * cskip) * h * w
    return total + 2 * feats[0] * max(GROUPS.values()) * h * w


def breakdown(tool, scan, fast):
    """Where one scan's time goes: the host projection, the engine call
    (upload, device program, download, unpack), inside the program the one
    tile batch of U-Net forwards (4 tiles x 4 mirrors, all 5 groups), and a
    torch.profiler trace of one whole predict: device busy time (the union
    of kernel intervals) against wall time, and the kernels by device time."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine = tool._fused
    t0 = time.perf_counter()
    chans = project_multi(reorient(scan, 'RAI'), ['max', 'mean'], 'coronal')
    host_s = time.perf_counter() - t0
    arr = np.stack([c.array[:, 0, :] for c in chans], axis=-1).astype(np.float32)
    engine.predict_array(arr, (1.25, 0.78))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.predict_array(arr, (1.25, 0.78))
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    batch = torch.randn((16, 2) + FLAGSHIP['patch'], device='cuda')
    with torch.no_grad(), exact_numerics():
        # eager (as the engine runs it: the host's launches included), best
        # of 3 rounds; and device time alone, by CUDA-graph replay
        rounds = [cuda_ms(lambda: engine._net(batch), 3) for _ in range(3)]
        fwd_ms = min(rounds)
        dev_ms = device_ms(lambda: engine._net(batch), 3)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    flops = len(GROUPS) * 16 * conv_flops(FLAGSHIP, *FLAGSHIP['patch'])
    peak, kind = ((BF16_FLOP_PER_S, 'bf16') if fast
                  else (FP32_FLOP_PER_S, 'fp32'))
    print(f'breakdown: host projection {host_s:.4f} s; engine.predict_array '
          f'{engine_s:.4f} s, of which U-Net forwards {fwd_ms / 1e3:.4f} s '
          f'eager (rounds {[round(r / 1e3, 4) for r in rounds]}; '
          f'{flops / 1e12:.3f} TFLOP, {flops / fwd_ms / 1e9:.1f} TFLOP/s '
          f'{kind}; bound {flops / peak * 1e3:.2f} ms at '
          f'{peak / 1e12:.0f} TFLOP/s), {dev_ms / 1e3:.4f} s device')

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tool.predict(scan)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, (cur_s, cur_e) = 0.0, spans[0]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy = (busy_us + cur_e - cur_s) / 1e6
    print(f'profiled predict: wall {wall:.4f} s, device busy {busy:.4f} s '
          f'({busy / wall:.1%}), {len(kernels)} kernel launches')
    ops = {a.key: a.self_device_time_total / 1e3 for a in prof.key_averages()}
    print('device ms by op: ' + ', '.join(
        f'{k} {ops.get(k, 0.0):.2f}' for k in
        ('aten::cudnn_convolution', 'aten::cudnn_convolution_transpose')))
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e.name[:70]] += e.device_time_total / 1e3
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f'  {ms:9.2f} ms  {name}')


# -- 4. the port on the GPU against the port on the CPU ---------------------

def gpu_vs_cpu(precision, bar):
    phase(f'GPU vs CPU ({precision}), reduced architecture')
    fast = precision == 'fast'
    db = os.path.join(WORK, 'db_small')
    if not os.path.isdir(db):
        write_database(db, 'ts2d-v9-small', {'cardiac': 3, 'ribs': 4}, SMALL,
                       seed=200)
    scan = torso_ct((150, 96, 110), (0.9, 0.9, 2.0), seed=11)
    segs = {}
    for device in ('cuda', 'cpu'):
        reset_launches()
        with TS2D(key='ts2d-v9-small', use_remote=False, local=db,
                  device=device, param=FAST if fast else None) as tool:
            segs[device] = tool.predict(scan).get_segmentation().array
        ran = read_launches()
        on_card = device == 'cuda'
        if (ran['bspline_prefilter'] != (2 if on_card else 0)
                or (ran['fused_norm_act_conv'] > 0) != (on_card and fast)):
            raise SystemExit(f'{device} ({precision}): kernel launches {ran}')
    agree = float((segs['cuda'] == segs['cpu']).mean())
    print(f'mask agreement GPU vs CPU ({precision}): {agree:.6f} '
          f'(foreground {segs["cuda"].mean():.3f})')
    if agree < bar:
        raise SystemExit(f'GPU/CPU mask agreement {agree} < {bar}')


# -- 5. a set that does not fuse: the per-model engines ----------------------

def per_model_path():
    phase('per-model path: groups that disagree on precision')
    db = os.path.join(WORK, 'db_mixed')
    write_database(db, 'ts2d-v9-mixed', {'cardiac': 3, 'ribs': 4}, SMALL,
                   seed=300, precision={'cardiac': 'fast', 'ribs': 'exact'})
    scan = torso_ct((150, 96, 110), (0.9, 0.9, 2.0), seed=12)
    with TS2D(key='ts2d-v9-mixed', use_remote=False, local=db) as tool:
        if tool._fused is not None or not all(
                m.started for m in tool.models.values()):
            raise SystemExit('the mixed-precision set did not take the '
                             'per-model engines')
        reset_launches()
        res = tool.predict(scan)
        torch.cuda.synchronize()
        ran = read_launches()
    seg = res.get_segmentation()
    print(f'per-model predict: launches {ran}; segmentation '
          f'{seg.array.shape}, foreground {seg.array.mean():.3f}')
    if ran['bspline_prefilter'] != 4 or ran['fused_norm_act_conv'] < 1:
        raise SystemExit(f'per-model path kernel launches {ran}')
    if seg.ncomponents != 7 or not 0 < seg.array.mean() < 1:
        raise SystemExit(f'unexpected per-model segmentation {seg.array.shape}')


def main():
    shutil.rmtree(WORK, ignore_errors=True)
    smi = device_info()
    prefilter = check_prefilter()
    fused, fused_per_scan = check_fused_block()

    db = os.path.join(WORK, 'db_flagship')
    t0 = time.perf_counter()
    write_database(db, 'ts2d-v9-flagship', GROUPS, FLAGSHIP, seed=100)
    scan = torso_ct((400, 512, 512), (0.78, 0.78, 1.25), seed=7)
    print(f'database + phantom in {time.perf_counter() - t0:.1f} s')
    _, exact = main_path(db, scan, 'exact', fused_per_scan)
    launches, fast = main_path(db, scan, 'fast', fused_per_scan)
    print(f'mask agreement fast vs exact (flagship scan): '
          f'{float((fast == exact).mean()):.6f}')

    gpu_vs_cpu('exact', 0.999)
    gpu_vs_cpu('fast', 0.99)
    per_model_path()
    kernels = [prefilter, fused]
    for k in kernels:
        k['launches'] = launches[k['name']]
        if k['launches'] < 1:
            raise SystemExit(f'{k["name"]} did not run on the main path')
    shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
