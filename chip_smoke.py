"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases 1,2,11]

``--phases`` runs a subset (phase 1 always), each phase with the inputs it
needs, for example ``--phases 2,10`` (training) or ``--phases 2,11`` (the
sharded programs). Phases (any failure exits non-zero; the result lines
print only at the end):

1. Device info: the card (nvidia-smi), CUDA, nvcc; builds every kernel from
   the sources in the checkout, all at once, and beside them the native host
   library (csrc/ts2dio.cc, g++ and zlib).
2. Every kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it and at edge shapes, with bitwise-repeat
   checks; kernel, plain and library-yardstick times with CUDA events, and
   each kernel's bound at those shapes. The prefilter kernel must equal its
   chunked plain version bit for bit and agree with the sequential one
   (rtol 1e-5 / atol 1e-6), the reference formula and scipy; it is timed
   at the main path's pair of launches, at the batch-8 pair, at the
   bucket program's canvas, (448, 512, 2) and its batch-8 stack, at the
   visuals' resample of a (400, 512) image along axes 1 and 0 (phase 8), and
   at training's three call sites (phase 10): the preprocessing case
   (448, 384, 2) along axes 0, 1, augmentation's warp stack (6, 256, 256, 2)
   and one low-resolution level (4, 128, 128) along axes 1, 2, beside two
   empty launches (the launch floor). The fused block is checked and timed
   at the 11 flagship shapes at N = 16 (the main path's forward batch) and
   N = 128 (the batched serving program's: 8 scans), per scan and per
   batch. Times are eager per call (CUDA events over back-to-back calls,
   the host's launch work included), the fused block's library yardstick
   the best of 3 rounds under cuDNN's benchmark mode; beside them each
   kernel's device time (a CUDA graph of back-to-back calls, replayed), the
   fused block's tile and each instantiation's registers, shared memory
   and blocks per SM.
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
5. A set whose groups disagree on precision, at the flagship width,
   through the per-model engines on the card: both kernels must run.
   Before it, the set's two ``HostedModel``s start on the card with
   ``start(wait=False)`` (each on its own thread, with its warm-up predict
   at the 256^2 patch) and ``await_startup()``: the seconds of both, and
   the fused block's launches in the 'fast' model's warm-up, which must
   be one forward batch's (16).
6. Serving at full width, at 'exact' and 'fast': (a) 8 phantoms (seeds
   7-14, one geometry) through ``predict_array_async`` in one 8-scan
   batched program, with the launch counts set to 0 just before it and
   read just after (prefilter 2, fused block 80 fast / 0 exact), each mask
   against the solo program's (>= 0.999 exact, >= 0.99 fast), seconds per
   batch, peak memory and the device-busy share of a profiled batch; (b)
   16 phantoms through ``TS2D.predict_async`` / ``finish_predict`` with an
   in-flight window of 8, batching on and off: scans/s, latency, the
   batcher's occupancy; a result download with 1 and 4 ``fetch_split``
   slabs; (c) the HTTP server around the fast set: 8 concurrent POSTs of
   the uncompressed phantom NRRD, each response >= 0.99 against the solo
   result, ``/metrics`` with no errors and coalesced scans.
7. The geometry-as-data paths at full width, at 'exact' and 'fast', on
   phase 6's phantoms cropped in z and x to sizes that all ride one
   ``pad_quantum=64`` bucket, (448, 512): (a) the solo bucket program on
   three crop sizes (one cached program; launches per scan, prefilter 2
   and fused block 80 fast / 0 exact; masks against the exact per-shape
   program >= 0.995 exact, >= 0.99 fast; blocking s/scan, median of 5);
   (b) 8 crops of 8 sizes in one 8-scan batched bucket program (launches,
   each scan against its solo bucket result >= 0.999 exact, >= 0.99 fast,
   s per batch, peak memory); (c) the volume program against the host
   projection + ``predict_array`` on one engine (equal projections, masks
   >= 0.9999; blocking s/scan of each path, median of 5, the volume's
   upload and the host projection beside them); (d) ``predict_cohort`` of
   the 8 phantoms against ``predict_volume`` per scan (>= 0.9999 exact,
   >= 0.999 fast) and ``predict_cohort_mixed`` of the 8 crops in one padded
   program ('pad'), against the plain version of its semantics (the host
   projection centred in the bucket through the solo masked program, the
   same bars), and against 'exact' (printed: the resample and tile grids
   see the padded extent), s per scan of each; 'pad' against 'exact'
   >= 0.99 at 8 smaller crops at plan spacing, which one tile covers at the
   same place in both modes.
8. IO and visuals at full width: the native host library built and loaded;
   its one-pass MAX + MEAN host projection of the seed-7 phantom against
   numpy's two passes (bit for bit, both timed); ``TS2D.predict`` blocking
   at 'exact' and 'fast' with the native projection and with numpy's,
   median of 5 each, in turns; the phantom written and read back as
   ``.nii.gz`` and ``.mha``; ``Result.save`` of one fast result as files,
   as visuals and as both, with the launch counts set to 0 just before the
   'all' save and read just after (prefilter 6: the input visual and the
   two projection visuals, two axes each), the PNGs decoded from their IDAT
   (no PIL) and held against the same visuals rendered on the CPU (label
   visual bit for bit, intensity visuals within one gray level and equal on
   >= 99.9% of pixels); one HTTP POST of the phantom as ``.nii.gz``
   answered as ``.nii.gz``, against the in-process result.
9. DICOM, zip and the CLI at full width: the seed-7 phantom written by
   this script as 400 slice files, explicit VR little endian and JPEG
   Lossless (selection value 1, encoded here in numpy), with
   ImagePositionPatient, ImageOrientationPatient, PixelSpacing and rescale
   slope / intercept; (1) ``read_image`` of both series with the native
   host library: seconds, slices per second, the array bit for bit the
   phantom's and the geometry equal to the NRRD read's; (2) every other
   syntax on the committed fixtures (tests/fixtures/dicom/: RLE, deflate,
   JPEG baseline and extended, JPEG-LS lossless and near, JPEG 2000 5/3
   and 9/7) and 4 slices of each full series: the native decode against
   the Python path (the codec wrappers forced to None), bit for bit, ms
   per slice each; (3) ``TS2D.predict`` of the JPEG Lossless series at
   'exact' and 'fast', batching off: launches (prefilter 2, fused block 80
   fast / 0 exact), blocking seconds (median of 5, the read included)
   beside the NRRD file's, masks equal to the NRRD read's; (4)
   ``python -m totalsegmentator2d_tpu_torch.serve`` on 127.0.0.1, stopped
   by this script: the series zipped (input_format=zip) and as one legacy
   multi-frame file (input_format=dcm), request seconds, masks equal to
   the solo result; (5) the CLI on a folder with one series subdirectory
   and one NRRD: two cases, no error.
10. Training on the card at full width: (a) ``Trainer`` with the flagship
   group model (6 stages, features 32..512, patch 256^2, 2 channels) and
   the vertebrae group's 26 labels, batch 16, deep supervision and the
   augmentation recipe on, on 4 synthetic cases preprocessed on the card
   (``preprocess_case``: 2 prefilter launches each), in fp32 and bf16: s/step
   (median of 5 after 2 warm-up steps), peak memory, prefilter launches per
   step (the launch counts set to 0 just before the 5 steps and read just
   after; the low-resolution levels' share counted around each level, the
   rest the warp stack's), and the loss falling over 20 steps on one repeated batch with
   augment off; (b) the same weights (``init_params_np``) and batch on the
   GPU and the CPU at the reduced ``SMALL`` architecture, 3 steps, augment
   off: losses within rtol 1e-3; (c) ``ts2d-torch-train`` as a subprocess
   on a raw nnU-Net PNG dataset this script writes with its own encoder (8
   cases, 2 channels as 16-bit ``_0000.png`` / ``_0001.png``, label maps,
   2 folds x 20 steps at batch 8, ``--augment --pack``): the holdout Dice
   of each fold, the exported model loaded back through the port's ``Zoo``
   predicting on the card at 'exact' and 'fast' (the fused block's
   launches), and ``eval.evaluate`` of one prediction against its labels.
11. The sharded programs (parallel/) at full width: (a) a world-1 NCCL
   group in this process: ``EnsembleEngine(tile_mesh=)`` on the seed-7
   projection at 'exact' against the solo program (>= 0.9999); (b) two
   NCCL ranks on the one card (``--nccl-probe``), whose refusal is
   printed; (c) two gloo ranks sharing the card with CUDA tensors
   (``chip_smoke.py --rank r 2 port``, killed and failing the run after
   300 s): the tile-sharded scan at 'exact' and 'fast' against this
   process's solo program (>= 0.9999 / >= 0.999), ``predict_cohort(mesh=)``
   of phase 6's 8 phantoms (written once, mapped by each rank) at both
   precisions against the one-rank cohort (>= 0.9999 / >= 0.999),
   ``predict_cohort_distributed`` with shares of 5 and 3 and ``gather``
   (>= 0.9999), a fp32 flagship ``Trainer(mesh={'data': 2})`` step at
   batch 16 and a ``{'model': 2}`` step at batch 2, two steps each,
   against one rank's losses (rtol 1e-6: one step moves the loss by about
   4e-4 of itself, so a gradient that misses a rank's share shows), the
   height-sharded ``Trainer(mesh={'data': 1, 'model': 2}, spatial=True)``
   at batch 2 (fp32, two steps, against the same one-rank losses as the
   model=2 step, rtol 1e-6) and in bf16 with the augmentation recipe at
   batch 16 against one rank's bf16 augmented losses (rtol 1e-3: every
   rank must draw the global batch's augmentation as one rank does before
   it takes its slab; the prefilter runs the warp stack (6, 256, 256, 2)
   on each: 2 launches per step beside the low-resolution levels', fused
   block 0); per rank the seconds of
   each call, the kernels' launches (both kernels on every rank: prefilter
   2, fused block 80 per fast scan and per fast cohort share) and peak
   memory. Phase 2 holds both kernels at a rank's shapes: the fused block
   at N = 8 (2 of the 4 tiles) and N = 64 (4 scans of the cohort), the
   prefilter at the cohort share (4, 400, 512, 2) along axes 1, 2.
12. One JSON line with every kernel (the batch-8, bucket, visual,
   training and per-rank figures and launches per batch, per bucket scan,
   per saved result, per training step, per preprocessed case and per
   rank beside the main path's), then the card line, then the device
   line.

Needs nothing but the repository, PyTorch with CUDA, numpy, scipy and the
CUDA toolkit; imports nothing of the JAX package. It reaches no network:
the server and the CLI read the packaged model registry (``--no-fetch``)
and find the models in the local database.
"""

import sys

import torch

if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device available', file=sys.stderr)
    sys.exit(1)

import contextlib  # noqa: E402
import gc  # noqa: E402
import heapq  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import struct  # noqa: E402
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
# the main path's forward batch per scan: 4 tiles x 4 mirrors
SOLO_BATCH = 16
# the phantom's coronal projection as the visuals resample it: (z, x)
VISUAL = (400, 512)
# reduced architecture for the GPU-vs-CPU comparison
SMALL = dict(n_stages=4, features=(8, 16, 32, 32), patch=(64, 64),
             spacing=(1.5, 1.5))
# training (phase 10): a 2-channel training case at clinical spacing ((x, y)
# mm), resampled to the plan's 1.5 mm by preprocessing; the flagship patch
# at batch 16, where round(16 * 0.36) = 6 samples warp as one stack; one
# low-resolution level, 4 planes at zoom 0.5, as the cubic up-resize's
# prefilter sees them
TRAIN_CASE = (448, 384, 2)
TRAIN_SPACING = (1.1, 0.9)
TRAIN_BATCH = 16
WARP_STACK = (round(TRAIN_BATCH * 0.36), 256, 256, 2)
LOWRES_STACK = (4, 128, 128)
# phase 11, two ranks on the card: a rank's share of the tile-sharded scan
# (2 of the 4 tiles x 4 mirrors) and of the 8-phantom cohort (4 scans x 4
# tiles x 4 mirrors), and the prefilter's stack of that cohort share
RANKS = 2
TILE_RANK_N = SOLO_BATCH // RANKS
COHORT_RANK_N = 8 // RANKS * SOLO_BATCH
COHORT_RANK_STACK = (8 // RANKS, 400, 512, 2)


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
    from concurrent.futures import ThreadPoolExecutor

    def host_build():
        t0 = time.perf_counter()
        path = build.build_host('ts2dio')
        return path, time.perf_counter() - t0

    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(host_build)
        t0 = time.perf_counter()
        libs = build.build()
        print(f'built {sorted(libs)} in {time.perf_counter() - t0:.2f} s')
        host_path, host_s = host.result()
    print(f'built the host library {os.path.basename(host_path)} in '
          f'{host_s:.2f} s')
    return smi, host_s


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
    # the bucket program's mirror-extended canvas (phase 7), solo along
    # axes 0 and 1, and the batched bucket program's stack along 1 and 2
    xk = torch.randn(BUCKET + (2,), generator=gen).cuda()
    compare(compare(xk, 0), 1)
    xkb = torch.randn((8,) + BUCKET + (2,), generator=gen).cuda()
    compare(compare(xkb, 1), 2)
    # the visuals' resample (phase 8) of a (400, 512) image: along axis 1
    # (the slab path), then axis 0 (the tile path)
    xv = torch.randn(VISUAL, generator=gen).cuda()
    compare(compare(xv, 1), 0)
    # training (phase 10): the preprocessing case along axes 0, 1, the warp
    # stack and one low-res level along axes 1, 2
    xp = torch.randn(TRAIN_CASE, generator=gen).cuda()
    compare(compare(xp, 0), 1)
    xw = torch.randn(WARP_STACK, generator=gen).cuda()
    compare(compare(xw, 1), 2)
    xl = torch.randn(LOWRES_STACK, generator=gen).cuda()
    compare(compare(xl, 1), 2)
    # phase 11: a rank's share of the cohort along axes 1, 2
    xr = torch.randn(COHORT_RANK_STACK, generator=gen).cuda()
    compare(compare(xr, 1), 2)
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
            for n in (128, 256, 384, 400, 448, 512)}

    def library():
        a = torch.matmul(mats[400], x.view(1, 400, 1024))
        return torch.matmul(mats[512], a.view(400, 512, 2))

    def library_b8():
        a = torch.matmul(mats[400], xb.view(8, 400, 1024))
        return torch.matmul(mats[512], a.view(3200, 512, 2)).view(xb.shape)

    def library_bucket():
        a = torch.matmul(mats[448], xk.view(1, 448, 1024))
        return torch.matmul(mats[512], a.view(448, 512, 2))

    def library_bucket_b8():
        a = torch.matmul(mats[448], xkb.view(8, 448, 1024))
        return torch.matmul(mats[512], a.view(3584, 512, 2)).view(xkb.shape)

    def library_visual():
        a = torch.matmul(xv, mats[512].T)
        return torch.matmul(mats[400], a)

    def library_train_preprocess():
        a = torch.matmul(mats[448], xp.view(1, 448, 768))
        return torch.matmul(mats[384], a.view(448, 384, 2))

    def library_train_warp():
        a = torch.matmul(mats[256], xw.view(6, 256, 512))
        return torch.matmul(mats[256], a.view(1536, 256, 2)).view(xw.shape)

    def library_train_lowres():
        a = torch.matmul(mats[128], xl)
        return torch.matmul(a, mats[128].T)

    def library_cohort_rank():
        a = torch.matmul(mats[400], xr.view(4, 400, 1024))
        return torch.matmul(mats[512], a.view(1600, 512, 2)).view(xr.shape)

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
        torch.testing.assert_close(library_bucket(),
                                   pair(xk, (0, 1), PF.prefilter_axis)(),
                                   rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(library_bucket_b8(),
                                   pair(xkb, (1, 2), PF.prefilter_axis)(),
                                   rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(library_visual(),
                                   pair(xv, (1, 0), PF.prefilter_axis)(),
                                   rtol=1e-4, atol=1e-5)
        for lib, t, axes in ((library_train_preprocess, xp, (0, 1)),
                             (library_train_warp, xw, (1, 2)),
                             (library_train_lowres, xl, (1, 2)),
                             (library_cohort_rank, xr, (1, 2))):
            torch.testing.assert_close(lib(), pair(t, axes, PF.prefilter_axis)(),
                                       rtol=1e-4, atol=1e-5)
        floor_ms, floor_dev = cuda_ms(empty_pair, 200), device_ms(empty_pair, 50)
        for name, t, axes, lib, passes in (
                ('main', x, (0, 1), library, ((400, 1024), (512, 800))),
                ('batch8', xb, (1, 2), library_b8, ((400, 8192), (512, 6400))),
                ('bucket', xk, (0, 1), library_bucket, ((448, 1024), (512, 896))),
                ('bucket_batch8', xkb, (1, 2), library_bucket_b8,
                 ((448, 8192), (512, 7168))),
                ('visual', xv, (1, 0), library_visual, ((512, 400), (400, 512))),
                ('train_preprocess', xp, (0, 1), library_train_preprocess,
                 ((448, 768), (384, 896))),
                ('train_warp', xw, (1, 2), library_train_warp,
                 ((256, 3072), (256, 3072))),
                ('train_lowres', xl, (1, 2), library_train_lowres,
                 ((128, 512), (128, 512))),
                ('cohort_rank', xr, (1, 2), library_cohort_rank,
                 ((400, 4096), (512, 3200)))):
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
        where = {'main': '(400, 512, 2) axes 0, 1',
                 'batch8': '(8, 400, 512, 2) axes 1, 2',
                 'bucket': '(448, 512, 2) axes 0, 1',
                 'bucket_batch8': '(8, 448, 512, 2) axes 1, 2',
                 'visual': '(400, 512) axes 1, 0',
                 'train_preprocess': f'{TRAIN_CASE} axes 0, 1',
                 'train_warp': f'{WARP_STACK} axes 1, 2',
                 'train_lowres': f'{LOWRES_STACK} axes 1, 2',
                 'cohort_rank': f'{COHORT_RANK_STACK} axes 1, 2'}[name]
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
            **{name: {k: res[name][k] for k in
                      ('ms', 'device_ms', 'plain_ms', 'library_ms', 'bound_ms',
                       'bound_by')}
               for name in ('batch8', 'bucket', 'bucket_batch8', 'visual',
                            'train_preprocess', 'train_warp',
                            'train_lowres', 'cohort_rank')}}


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
    # the main path's forward batch (4 tiles x 4 mirrors), then the batched
    # serving program's (8 scans of it); fewer timing rounds at 128; then a
    # rank's share of the tile-sharded scan and of the cohort (phase 11)
    for N, iters in ((SOLO_BATCH, 20), (8 * SOLO_BATCH, 5),
                     (TILE_RANK_N, 20), (COHORT_RANK_N, 10)):
        for H, W, C, Co, act in shapes:
            args = operands(N, H, W, C, Co)
            y, err = check(args, act)
            worst = max(worst, err)
            w_oihw = args[3].permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            b16 = args[4].to(torch.bfloat16)

            def library():
                # cuDNN's bf16 conv (channels_last) + torch normact + stats
                z = args[0].float()
                if act:
                    z = z * args[1][:, None, None, :] + args[2][:, None, None, :]
                    z = torch.where(z >= 0, z, z * 0.01)
                out = F.conv2d(z.to(torch.bfloat16).permute(0, 3, 1, 2),
                               w_oihw, b16, padding=1)
                o32 = out.float()
                return out, torch.stack([o32.sum(dim=(2, 3)),
                                         o32.square().sum(dim=(2, 3))], dim=1)

            def kernel():
                return FB.fused_norm_act_conv_cuda(*args, apply_normact=act)

            with torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                            deterministic=False,
                                            allow_tf32=False):
                ly, _ = library()
                torch.testing.assert_close(ly.permute(0, 2, 3, 1).float(),
                                           y.float(), rtol=0.05, atol=0.05)
                ms = cuda_ms(kernel, iters)
                dev_ms = device_ms(kernel, iters)
                plain_ms = cuda_ms(lambda: FB.fused_norm_act_conv_plain(
                    *args, apply_normact=act), 3 if N <= SOLO_BATCH else 1)
                rounds = [cuda_ms(library, iters) for _ in range(3)]
                library_ms = min(rounds)
            del args, y
            t_bytes, t_ops = fused_bounds_ms(N, H, W, C, Co)
            bound = max(t_bytes, t_ops)
            per_shape[(N, H, W, C, Co, act)] = (ms, plain_ms, library_ms,
                                                t_bytes, t_ops, dev_ms)
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
        # give the graphs' memory pools back, so what follows allocates as
        # it would alone
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # one scan (N = 16) and one 8-scan batch (N = 128): 5 groups x one
    # forward of the tile batch
    totals = {}
    for N, what in ((SOLO_BATCH, 'one scan'), (8 * SOLO_BATCH, 'one batch'),
                    (TILE_RANK_N, "a rank's tile share"),
                    (COHORT_RANK_N, "a rank's cohort share")):
        runs = [per_shape[(N,) + sh] for sh in per_forward for _ in GROUPS]
        ms, plain_ms, library_ms = (sum(t[i] for t in runs) for i in range(3))
        dev_ms = sum(t[5] for t in runs)
        bound = sum(max(t[3], t[4]) for t in runs)
        by_ops = sum(t[4] for t in runs) > sum(t[3] for t in runs)
        print(f'fused block, {what} (N = {N}, {len(runs)} launches): kernel '
              f'{ms:.4f} ms ({bound / ms:.1%} of bound; device {dev_ms:.4f} ms, '
              f'{bound / dev_ms:.1%}), plain {plain_ms:.4f} ms, library '
              f'{library_ms:.4f} ms, bound {bound:.4f} ms; max |y - plain| '
              f'{worst:.4g}')
        totals[N] = {'ms': ms, 'device_ms': dev_ms, 'plain_ms': plain_ms,
                     'bound_ms': bound,
                     'bound_by': 'operations' if by_ops else 'bytes',
                     'library_ms': library_ms}
    solo = totals[SOLO_BATCH]
    return {'name': 'fused_norm_act_conv', 'route': 'cuda',
            'source': 'totalsegmentator2d_tpu_torch/csrc/fused_block.cu',
            'replaces': 'totalsegmentator2d_tpu/ops/pallas/fused_block.py:56',
            'max_abs_err': worst, **solo,
            'batch8': {k: totals[8 * SOLO_BATCH][k] for k in
                       ('ms', 'device_ms', 'plain_ms', 'library_ms',
                        'bound_ms')},
            **{name: totals[N] for name, N in (('tile_rank', TILE_RANK_N),
                                                ('cohort_rank', COHORT_RANK_N))}
            }


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
    res.save(out, name='scan', targets=['segmentation', 'projection'],
             content='file')
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


def profiled(fn):
    """A torch.profiler trace of fn(): (profile, wall s, the CUDA kernel
    events, device busy s = the union of their intervals)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    return prof, wall, kernels, (busy_us + cur_e - cur_s) / 1e6


def breakdown(tool, scan, fast):
    """Where one scan's time goes: the host projection, the engine call
    (upload, device program, download, unpack), inside the program the one
    tile batch of U-Net forwards (4 tiles x 4 mirrors, all 5 groups), and a
    torch.profiler trace of one whole predict: device busy time (the union
    of kernel intervals) against wall time, and the kernels by device time."""
    from collections import defaultdict

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

    _, wall, kernels, busy = profiled(lambda: tool.predict(scan))
    print(f'profiled predict: wall {wall:.4f} s, device busy {busy:.4f} s '
          f'({busy / wall:.1%}), {len(kernels)} kernel launches')
    # by kernel, not by op: the program runs on the micro-batcher's
    # dispatcher thread, whose ops the profiler does not attribute
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

def hosted_start(db):
    """The mixed set's flagship-width HostedModels started on the card
    without waiting (each loads and runs its warm-up predict at the 256^2
    patch on its own thread), then awaited, with the launch counts set to
    0 just before and read just after: the 'fast' model's warm-up is one
    forward batch (1 tile x 4 mirrors), so it launches the fused block
    once per fused layer of the flagship U-Net, the 'exact' one never."""
    from totalsegmentator2d_tpu_torch.inference import Zoo
    zoo = Zoo(remote=False, local=db)
    models = [zoo.load(i) for i in zoo.resolve('ts2d-v9-mixed',
                                               unique_model=True)]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for m in models:
        m.start(wait=False)
    for m in models:
        m.await_startup()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    ran = read_launches()
    print(f'HostedModel.start(wait=False) + await_startup() of '
          f'{[(m.name, m.precision) for m in models]}: {dt:.3f} s with the '
          f'warm-up predicts at {models[0].spec.preprocess.patch_size}; '
          f'launches {ran}')
    want = len(fused_launches(FLAGSHIP)) * sum(m.precision == 'fast'
                                               for m in models)
    if not all(m.started for m in models) or \
            ran['fused_norm_act_conv'] != want:
        raise SystemExit(f'hosted models did not warm up: launches {ran}, '
                         f'{want} fused launches expected')
    for m in models:
        m.stop()


def per_model_path():
    phase('per-model path: groups that disagree on precision')
    db = os.path.join(WORK, 'db_mixed')
    write_database(db, 'ts2d-v9-mixed', {'cardiac': 3, 'ribs': 4},
                   FLAGSHIP, seed=300,
                   precision={'cardiac': 'fast', 'ribs': 'exact'})
    scan = torso_ct((150, 96, 110), (0.9, 0.9, 2.0), seed=12)
    hosted_start(db)
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


# -- 6. serving at full width -------------------------------------------------

SPACING_YX = (1.25, 0.78)   # the phantom's projection, array order (y, x)
MODES = ('max', 'mean')
# phase 7: crops (z, x) of the (400, 512) phantom projections and volumes,
# all in one bucket at pad_quantum 64
PQ = 64
BUCKET = (448, 512)
CROPS = [(400, 512), (396, 505), (392, 498), (389, 490), (387, 480),
         (386, 470), (385, 460), (393, 452)]
# crops that ride the (256, 256) bucket: at plan spacing one 256^2 tile
# covers each of them in both cohort modes, at the same centred place
SMALL_CROPS = [(256, 256), (250, 240), (240, 230), (230, 220), (220, 210),
               (210, 200), (200, 196), (196, 193)]


def phantoms(first, seeds):
    """Torso phantoms of one geometry, made on 8 threads (numpy releases
    the GIL in its array passes); ``first`` is the seed-7 scan already
    made."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(8) as pool:
        rest = list(pool.map(lambda sd: torso_ct((400, 512, 512),
                                                 (0.78, 0.78, 1.25), sd),
                             seeds[1:]))
    return [first] + rest


def projection(scan):
    """The host projection the fused engine takes: (400, 512, 2) float32."""
    chans = project_multi(reorient(scan, 'RAI'), ['max', 'mean'], 'coronal')
    return np.stack([c.array[:, 0, :] for c in chans], -1).astype(np.float32)


def occupancy_delta(before, after):
    return [a - b for a, b in zip(after['batch_occupancy'],
                                  before['batch_occupancy'])]


def serving_batched(tool, solo_tool, arrs, precision, fused_per_scan):
    """6a: the 8 projections through predict_array_async with a linger
    long enough that they ride one program, against the solo program of an
    engine without a batcher. Returns (launches per batch, timings)."""
    fast = precision == 'fast'
    phase(f'serving ({precision}): 8 scans through the batched program')
    engine, solo = tool._fused, solo_tool._fused
    shapes = {engine._crop(a)[0].shape for a in arrs}
    if len(shapes) != 1:
        raise SystemExit(f'the 8 phantoms crop to several shapes: {shapes}')
    refs = [solo.predict_array(a, SPACING_YX) for a in arrs]
    engine.set_batch_linger(600_000.0)

    def batch():
        handles = [engine.predict_array_async(a, SPACING_YX) for a in arrs]
        outs = [engine.finish_array(h) for h in handles]
        torch.cuda.synchronize()
        return outs

    expect = {'bspline_prefilter': 2,
              'fused_norm_act_conv': fused_per_scan if fast else 0}
    before = engine._batcher.stats()
    reset_launches()
    outs = batch()
    launches = read_launches()
    occ = occupancy_delta(before, engine._batcher.stats())
    print(f'launches per batch: {launches}; programs by occupancy {occ}')
    if occ != [0] * 7 + [1]:
        raise SystemExit(f'the 8 scans did not ride one program: {occ}')
    if launches != expect:
        raise SystemExit(f'kernel launches per batch {launches}, expected '
                         f'{expect}')
    bar = 0.99 if fast else 0.999
    agree = [float((o == r).mean()) for o, r in zip(outs, refs)]
    print(f'mask agreement batched vs solo per scan: '
          f'{[round(a, 6) for a in agree]}')
    if min(agree) < bar:
        raise SystemExit(f'batched/solo mask agreement {min(agree)} < {bar}')
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        batch()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    _, wall, kernels, busy = profiled(batch)
    engine.set_batch_linger(0.0)
    per_batch = float(np.median(times))
    print(f'batched ({precision}): {per_batch:.4f} s per batch of 8, '
          f'{per_batch / 8:.4f} s per scan (median of runs '
          f'{[round(t, 4) for t in times]}); peak device memory {peak:.2f} '
          f'GiB; profiled batch: wall {wall:.4f} s, device busy {busy:.4f} '
          f's ({busy / wall:.1%}), {len(kernels)} kernel launches')
    return launches, {'s_per_batch': per_batch, 'peak_gib': peak,
                      'busy_share': busy / wall}


def serving_throughput(tools, scans, precision):
    """6b: 16 in-memory scans through TS2D.predict_async / finish_predict
    with ScanPipeline's in-flight window of 8, batching on and off."""
    from collections import deque
    phase(f'serving ({precision}): 16 scans, in-flight window 8')
    for batching, tool in tools:
        batcher = tool._fused._batcher
        before = batcher.stats() if batcher else None
        pending, lat = deque(), []

        def finish():
            t_sub, handle = pending.popleft()
            tool.finish_predict(handle)
            lat.append(time.perf_counter() - t_sub)

        t0 = time.perf_counter()
        for scan in scans:
            pending.append((time.perf_counter(), tool.predict_async(scan)))
            while len(pending) > 8:
                finish()
        while pending:
            finish()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        occ = (occupancy_delta(before, batcher.stats()) if batcher
               else 'no batcher')
        print(f'batching={batching}: {len(scans) / wall:.3f} scans/s '
              f'({wall:.3f} s), latency p50 {np.percentile(lat, 50):.4f} s, '
              f'p95 {np.percentile(lat, 95):.4f} s; programs by occupancy '
              f'{occ}')


def fetch_times():
    """One full-width result download (the packed 117 labels of a scan,
    400 x 512 x 15 bytes, and of an 8-scan batch) with 1 and with 4
    fetch_split slabs, interleaved, median of 20."""
    from totalsegmentator2d_tpu_torch.inference.ensemble_engine import \
        fetch_split
    for shape in ((400, 512, 15), (8, 400, 512, 15)):
        dev = torch.randint(0, 256, shape, dtype=torch.uint8, device='cuda')
        ref = dev.cpu().numpy()
        times = {1: [], 4: []}
        for _ in range(20):
            for k in (1, 4):
                ev = torch.cuda.Event()
                ev.record()
                t0 = time.perf_counter()
                out = fetch_split(dev, streams=k, ready=ev)
                times[k].append(time.perf_counter() - t0)
                if not np.array_equal(out, ref):
                    raise SystemExit('fetch_split changed the result')
        print(f'download of {shape} ({dev.numel() / 1e6:.2f} MB): '
              + ', '.join(f'{k} slab(s) {np.median(t) * 1e3:.3f} ms'
                          for k, t in times.items()))


def serving_http(tool, scan, solo_seg):
    """6c: TS2DServer around the fast flagship TS2D, warmed up on the
    production wire; 8 concurrent POSTs of one uncompressed phantom NRRD."""
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from totalsegmentator2d_tpu_torch.io import write_image
    from totalsegmentator2d_tpu_torch.serve import TS2DServer, production_wire
    phase('serving (fast): HTTP, 8 concurrent POST /predict')
    engine = tool._fused
    wire = production_wire(engine.spec.channel_names)
    engine.warmup((400, 512), SPACING_YX, wire=wire)
    path = os.path.join(WORK, 'scan.nrrd')
    write_image(scan, path, compress=False)
    with open(path, 'rb') as f:
        payload = f.read()
    # the server's throughput knob (--batch-linger-ms): requests that parse
    # their 210 MB bodies at different speeds still meet in one program
    engine.set_batch_linger(3000.0)
    before = engine._batcher.stats()
    with TS2DServer(tool, port=0) as srv:
        def post(i):
            t0 = time.perf_counter()
            req = urllib.request.Request(
                f'http://127.0.0.1:{srv.port}/predict', data=payload,
                method='POST')
            with urllib.request.urlopen(req, timeout=600) as r:
                body = r.read()
                status = r.status
            return status, body, time.perf_counter() - t0

        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            results = list(pool.map(post, range(8)))
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(
                f'http://127.0.0.1:{srv.port}/metrics') as r:
            metrics = json.loads(r.read())
    engine.set_batch_linger(0.0)
    agree = []
    for i, (status, body, _) in enumerate(results):
        if status != 200:
            raise SystemExit(f'POST /predict answered {status}')
        out = os.path.join(WORK, f'resp{i}.seg.nrrd')
        with open(out, 'wb') as f:
            f.write(body)
        seg = read_image(out)
        if seg.ncomponents != 117 or seg.array.shape != solo_seg.shape:
            raise SystemExit(f'unexpected response {seg.array.shape}')
        agree.append(float((seg.array == solo_seg).mean()))
    lat = [r[2] for r in results]
    print(f'HTTP: {len(results) / wall:.3f} requests/s ({wall:.3f} s for 8, '
          f'{len(payload) / 2**20:.0f} MiB each), latency p50 '
          f'{np.percentile(lat, 50):.3f} s, max {max(lat):.3f} s; agreement '
          f'with the solo result {[round(a, 6) for a in agree]}')
    # the batcher's counters are the tool's whole life: this run's share
    coalesced = (metrics['batch_scans_coalesced']
                 - before['batch_scans_coalesced'])
    print(f'metrics: {metrics}; this run: programs by occupancy '
          f'{occupancy_delta(before, metrics)}, {coalesced} scans coalesced')
    if min(agree) < 0.99:
        raise SystemExit(f'HTTP/solo mask agreement {min(agree)} < 0.99')
    if (metrics['predict_requests'] != 8 or metrics['predict_errors'] != 0
            or coalesced <= 0):
        raise SystemExit(f'unexpected serving metrics {metrics}')


def serving_inputs(first):
    """Phases 6, 7 and 11's inputs: 16 phantoms (seeds 7-22) and the
    projections of the first 8."""
    t0 = time.perf_counter()
    scans = phantoms(first, list(range(7, 23)))
    arrs = [projection(sc) for sc in scans[:8]]
    print(f'16 phantoms and 8 projections in {time.perf_counter() - t0:.1f} s')
    return scans, arrs


def serving(db, first, scans, arrs, fused_per_scan):
    """Phase 6: the serving path at full width, both precisions."""
    launches = {}
    for precision in ('exact', 'fast'):
        param = FAST if precision == 'fast' else None
        with TS2D(key='ts2d-v9-flagship', use_remote=False, local=db,
                  param=param) as tool, \
                TS2D(key='ts2d-v9-flagship', use_remote=False, local=db,
                     param=param, batching=False) as solo_tool:
            launches[precision], _ = serving_batched(
                tool, solo_tool, arrs, precision, fused_per_scan)
            serving_throughput([(True, tool), (False, solo_tool)], scans,
                               precision)
            if precision == 'fast':
                fetch_times()
                solo_seg = solo_tool.predict(first).get_segmentation().array
                serving_http(tool, first, solo_seg)
        gc.collect()
        torch.cuda.empty_cache()
    return launches['fast']


# -- 7. the geometry-as-data paths ---------------------------------------------

def median_s(fn, n=5):
    """(median seconds of n blocking calls of fn, the runs)."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), [round(t, 4) for t in times]


def agreement(a, b):
    return float((a == b).mean())


def bucket_solo(qe, xe, arrs, precision, fused_per_scan):
    """7a: three crop sizes through the solo bucket program."""
    fast = precision == 'fast'
    phase(f'bucket ({precision}): solo bucket program, pad_quantum {PQ}')
    expect = {'bspline_prefilter': 2,
              'fused_norm_act_conv': fused_per_scan if fast else 0}
    bar = 0.99 if fast else 0.995
    crops = [arrs[i][:z, :x] for i, (z, x) in enumerate(CROPS[:3])]
    agree = []
    for c in crops:
        reset_launches()
        out = qe.predict_array(c, SPACING_YX)
        torch.cuda.synchronize()
        launches = read_launches()
        if launches != expect:
            raise SystemExit(f'bucket launches per scan {launches}, expected '
                             f'{expect}')
        if (out.shape != c.shape[:2] + (qe.total_labels,)
                or not 0 < out.mean() < 1):
            raise SystemExit(f'unexpected bucket result {out.shape}')
        agree.append(agreement(out, xe.predict_array(c, SPACING_YX)))
    keys = [k for k in qe._cache if k[0] == 'bucket']
    print(f'crops {[c.shape[:2] for c in crops]}: bucket programs {keys}; '
          f'launches per scan {launches}; agreement with the exact programs '
          f'{[round(a, 6) for a in agree]}')
    if len(keys) != 1 or keys[0][1] != BUCKET:
        raise SystemExit(f'the crops did not share one {BUCKET} program')
    if min(agree) < bar:
        raise SystemExit(f'bucket/exact mask agreement {min(agree)} < {bar}')
    bucket_s, runs = median_s(lambda: qe.predict_array(crops[0], SPACING_YX))
    exact_s, eruns = median_s(lambda: xe.predict_array(crops[0], SPACING_YX))
    print(f'blocking s/scan ({precision}, crop {crops[0].shape[:2]}): bucket '
          f'{bucket_s:.4f} (runs {runs}), exact program {exact_s:.4f} (runs '
          f'{eruns})')
    return launches


def bucket_batched(qe, be, arrs, precision, fused_per_scan):
    """7b: 8 crops of 8 sizes through one batched bucket program."""
    fast = precision == 'fast'
    phase(f'bucket ({precision}): 8 sizes in one batched bucket program')
    crops = [a[:z, :x] for a, (z, x) in zip(arrs, CROPS)]
    refs = [qe.predict_array(c, SPACING_YX) for c in crops]
    be.set_batch_linger(600_000.0)

    def batch():
        handles = [be.predict_array_async(c, SPACING_YX) for c in crops]
        outs = [be.finish_array(h) for h in handles]
        torch.cuda.synchronize()
        return outs

    expect = {'bspline_prefilter': 2,
              'fused_norm_act_conv': fused_per_scan if fast else 0}
    before = be._batcher.stats()
    reset_launches()
    outs = batch()
    launches = read_launches()
    after = be._batcher.stats()
    coalesced = after['batch_scans_coalesced'] - before['batch_scans_coalesced']
    print(f'launches per batch: {launches}; programs by occupancy '
          f'{occupancy_delta(before, after)}, {coalesced} scans coalesced')
    if coalesced != 8 or occupancy_delta(before, after) != [0] * 7 + [1]:
        raise SystemExit('the 8 crops did not ride one 8-scan program')
    if launches != expect:
        raise SystemExit(f'bucket launches per batch {launches}, expected '
                         f'{expect}')
    bar = 0.99 if fast else 0.999
    agree = [agreement(o, r) for o, r in zip(outs, refs)]
    print(f'mask agreement batched vs solo bucket per scan: '
          f'{[round(a, 6) for a in agree]}')
    if min(agree) < bar:
        raise SystemExit(f'batched/solo bucket agreement {min(agree)} < {bar}')
    torch.cuda.reset_peak_memory_stats()
    per_batch, runs = median_s(batch, 3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    be.set_batch_linger(0.0)
    print(f'batched bucket ({precision}): {per_batch:.4f} s per batch of 8, '
          f'{per_batch / 8:.4f} s per scan (runs {runs}); peak device memory '
          f'{peak:.2f} GiB')
    return launches


def volume_vs_host(xe, vol, precision):
    """7c: the volume program against the host projection + predict_array,
    one engine, one phantom volume."""
    from totalsegmentator2d_tpu_torch.inference.program import upload
    phase(f'volume ({precision}): device projection against host '
          f'projection')
    reset_launches()
    seg_v, proj_v = xe.predict_volume(vol, SPACING_YX, MODES)
    torch.cuda.synchronize()
    launches = read_launches()
    proj_h = xe._host_projection(vol, MODES)
    seg_h = xe.predict_array(proj_h, SPACING_YX)
    agree = agreement(seg_v, seg_h)
    print(f'volume path: launches {launches}; projections equal: '
          f'{np.array_equal(proj_v, proj_h)}; mask agreement with the host '
          f'path {agree:.6f}')
    if not np.array_equal(proj_v, proj_h):
        raise SystemExit('device and host projections differ')
    if agree < 0.9999:
        raise SystemExit(f'volume/host mask agreement {agree} < 0.9999')
    vol_s, vruns = median_s(lambda: xe.predict_volume(vol, SPACING_YX, MODES))
    host_s, hruns = median_s(lambda: xe.predict_array(
        xe._host_projection(vol, MODES), SPACING_YX))
    proj_s, _ = median_s(lambda: xe._host_projection(vol, MODES))
    up_s, _ = median_s(lambda: upload(vol, torch.device('cuda')))
    print(f'blocking s/scan ({precision}): volume path {vol_s:.4f} (runs '
          f'{vruns}; upload of the {vol.nbytes / 2**20:.0f} MiB '
          f'{vol.dtype} volume {up_s * 1e3:.2f} ms); host path {host_s:.4f} '
          f'(runs {hruns}; host projection {proj_s * 1e3:.2f} ms)')


def cohorts(xe, vols, precision):
    """7d: predict_cohort of the 8 phantoms against predict_volume, and
    predict_cohort_mixed of the 8 crops, 'pad' against 'exact'."""
    fast = precision == 'fast'
    phase(f'cohorts ({precision}): 8 phantoms, 8 crops')
    stack = np.stack(vols)
    reset_launches()
    t0 = time.perf_counter()
    segs = xe.predict_cohort(stack, SPACING_YX, MODES)
    cohort_s = time.perf_counter() - t0
    launches = read_launches()
    singles = [xe.predict_volume(v, SPACING_YX, MODES)[0] for v in vols]
    agree = [agreement(a, b) for a, b in zip(segs, singles)]
    bar = 0.999 if fast else 0.9999
    print(f'predict_cohort: launches {launches}; agreement with '
          f'predict_volume {[round(a, 6) for a in agree]}')
    z, _, x = vols[0].shape
    if segs.shape != (8, z, x, xe.total_labels) or min(agree) < bar:
        raise SystemExit(f'cohort/volume agreement {min(agree)} < {bar}')
    t0 = time.perf_counter()
    xe.predict_cohort(stack, SPACING_YX, MODES)
    cohort_s = min(cohort_s, time.perf_counter() - t0)
    del stack, segs, singles
    # 'pad' at the 8 crops: one padded program, held against the plain
    # version of its semantics (each crop projected on the host over its
    # true extent, centred in the bucket, through the solo masked program)
    crops = [v[:z, :, :x] for v, (z, x) in zip(vols, CROPS)]
    t0 = time.perf_counter()
    pad = xe.predict_cohort_mixed(crops, SPACING_YX, MODES, bucket='pad',
                                  pad_quantum=PQ)
    pad_s = time.perf_counter() - t0
    keys = [k[1] for k in xe._cache if k[0] == 'cohortpad']
    agree = [agreement(p, pad_reference(xe, c)) for p, c in zip(pad, crops)]
    print(f'predict_cohort_mixed pad: padded programs {keys}; agreement with '
          f'the per-scan masked programs {[round(a, 6) for a in agree]}')
    if keys != [(8,) + BUCKET[:1] + vols[0].shape[1:]]:
        raise SystemExit(f'the crops did not share one padded program: {keys}')
    if min(agree) < bar:
        raise SystemExit(f'padded cohort/masked program agreement '
                         f'{min(agree)} < {bar}')
    t0 = time.perf_counter()
    exact = xe.predict_cohort_mixed(crops, SPACING_YX, MODES)
    exact_s = time.perf_counter() - t0
    print(f'pad against exact at the 8 crops (the resample and tile grids '
          f'see the padded extent): '
          f'{[round(agreement(p, e), 6) for p, e in zip(pad, exact)]}')
    print(f'cohorts ({precision}): predict_cohort {cohort_s / 8:.4f} s per '
          f'scan (best of 2 runs of 8); predict_cohort_mixed of the 8 crops '
          f'pad {pad_s / 8:.4f}, exact {exact_s / 8:.4f} s per scan')
    # the regime of the reference's bar (tests/test_008_ensemble_engine.py:
    # 238): no resample, and one tile covers each scan at the same centred
    # place in both modes, so only the masked statistics differ
    small = [v[:z, :, :x] for v, (z, x) in zip(vols, SMALL_CROPS)]
    plan = FLAGSHIP['spacing']
    pad = xe.predict_cohort_mixed(small, plan, MODES, bucket='pad',
                                  pad_quantum=PQ)
    exact = xe.predict_cohort_mixed(small, plan, MODES)
    agree = [agreement(p, e) for p, e in zip(pad, exact)]
    print(f'pad against exact at {len(small)} crops inside one tile, at plan '
          f'spacing: {[round(a, 6) for a in agree]}')
    if min(agree) < 0.99:
        raise SystemExit(f'pad/exact cohort agreement {min(agree)} < 0.99')


def pad_reference(xe, crop):
    """The padded cohort's masks of one (z, y, x) volume, plainly: the host
    projection centred in the bucket, through the solo masked program with
    the placed valid-extent mask, the crop's window cut out."""
    from totalsegmentator2d_tpu_torch.inference.program import ready_event
    z, _, x = crop.shape
    zq, xq = -(-z // PQ) * PQ, -(-x // PQ) * PQ
    sz, sx = (zq - z) // 2, (xq - x) // 2
    canvas = np.zeros((zq, xq, len(MODES)), np.float32)
    canvas[sz:sz + z, sx:sx + x] = xe._host_projection(crop, MODES)
    mask = np.zeros((zq, xq), bool)
    mask[sz:sz + z, sx:sx + x] = True
    fn, meta = xe._program_padded((zq, xq), SPACING_YX)
    out = fn(canvas, mask)
    masks = xe._fetch_masks(out, meta.get('compact'), ready_event(out))
    return masks[sz:sz + z, sx:sx + x]


def geometry_as_data(db, scans, arrs, fused_per_scan):
    """Phase 7 at both precisions. Returns the fast precision's launches
    per bucket scan and per 8-scan bucket batch."""
    vols = [reorient(sc, 'RAI').array for sc in scans[:8]]
    launches = {}
    for precision in ('exact', 'fast'):
        param = FAST if precision == 'fast' else None
        common = dict(key='ts2d-v9-flagship', use_remote=False, local=db,
                      param=param)
        with TS2D(pad_quantum=PQ, batching=False, **common) as qtool, \
                TS2D(pad_quantum=PQ, **common) as btool, \
                TS2D(batching=False, **common) as xtool:
            qe, be, xe = qtool._fused, btool._fused, xtool._fused
            solo = bucket_solo(qe, xe, arrs, precision, fused_per_scan)
            batch = bucket_batched(qe, be, arrs, precision, fused_per_scan)
            launches[precision] = (solo, batch)
            volume_vs_host(xe, vols[0], precision)
            cohorts(xe, vols, precision)
        gc.collect()
        torch.cuda.empty_cache()
    return launches['fast']


# -- 8. IO and visuals --------------------------------------------------------

def png_pixels(path):
    """The pixels of a PNG the port wrote, decoded without PIL: the
    signature, IHDR / IDAT / IEND with their CRCs, 8-bit gray or RGB, filter
    0 on every row."""
    import zlib
    with open(path, 'rb') as f:
        data = f.read()
    if data[:8] != b'\x89PNG\r\n\x1a\n':
        raise SystemExit(f'{path}: no PNG signature')
    pos, chunks = 8, []
    while pos < len(data):
        n = struct.unpack('>I', data[pos:pos + 4])[0]
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if struct.unpack('>I', data[pos + 8 + n:pos + 12 + n])[0] != \
                zlib.crc32(kind + body):
            raise SystemExit(f'{path}: bad CRC in {kind}')
        chunks.append((kind, body))
        pos += 12 + n
    if [k for k, _ in chunks] != [b'IHDR', b'IDAT', b'IEND']:
        raise SystemExit(f'{path}: chunks {[k for k, _ in chunks]}')
    w, h, depth, color = struct.unpack('>IIBB', chunks[0][1][:10])
    ch = {0: 1, 2: 3}.get(color)
    rows = np.frombuffer(zlib.decompress(chunks[1][1]), np.uint8)
    if depth != 8 or ch is None or rows.size != h * (1 + w * ch):
        raise SystemExit(f'{path}: depth {depth}, color {color}, {rows.size} '
                         f'bytes for {h} x {w}')
    rows = rows.reshape(h, 1 + w * ch)
    if rows[:, 0].any():
        raise SystemExit(f'{path}: a row filter other than 0')
    return rows[:, 1:].reshape((h, w, ch) if ch == 3 else (h, w))


class native_off:
    """Within the block the native host library is not used (numpy and
    Python's zlib take its place, as where it cannot be built)."""

    def __enter__(self):
        from totalsegmentator2d_tpu_torch.io import native
        self.native, self.lib = native, native._load()
        native._lib = None

    def __exit__(self, *exc):
        self.native._lib = self.lib


def host_projection(scan):
    """8: the native one-pass MAX + MEAN against numpy's two passes on the
    phantom's RAI volume, in turns, median of 5, bit for bit."""
    from totalsegmentator2d_tpu_torch.ops.projection import project_arrays_np
    vol = reorient(scan, 'RAI').array

    def numpy_pair():
        return (np.max(vol, axis=1).astype(np.float32),
                np.mean(vol, axis=1, dtype=np.float64).astype(np.float32))

    def native_pair():
        return tuple(o[:, 0] for o in project_arrays_np(vol, MODES, 1))

    ref, out = numpy_pair(), native_pair()
    if not all(np.array_equal(a, b) for a, b in zip(ref, out)):
        raise SystemExit('native and numpy host projections differ')
    runs = {'numpy': [], 'native': []}
    for i in range(5):
        for name in (('numpy', 'native') if i % 2 == 0 else ('native', 'numpy')):
            fn = numpy_pair if name == 'numpy' else native_pair
            t0 = time.perf_counter()
            fn()
            runs[name].append(time.perf_counter() - t0)
    med = {k: float(np.median(v)) for k, v in runs.items()}
    print(f'host projection of the {vol.shape} {vol.dtype} volume '
          f'({vol.nbytes / 2**20:.0f} MiB), MAX and MEAN, bit for bit equal: '
          f'native one pass {med["native"] * 1e3:.2f} ms (runs '
          f'{[round(t * 1e3, 2) for t in runs["native"]]}), numpy two passes '
          f'{med["numpy"] * 1e3:.2f} ms (runs '
          f'{[round(t * 1e3, 2) for t in runs["numpy"]]})')


def blocking_native_vs_numpy(tool, scan, precision):
    """8: TS2D.predict blocking with the native host projection and with
    numpy's, in turns, median of 5 each."""
    tool.predict(scan)
    torch.cuda.synchronize()
    runs = {'native': [], 'numpy': []}
    for i in range(5):
        for name in (('native', 'numpy') if i % 2 == 0 else ('numpy', 'native')):
            ctx = native_off() if name == 'numpy' else contextlib.nullcontext()
            with ctx:
                t0 = time.perf_counter()
                tool.predict(scan)
                torch.cuda.synchronize()
                runs[name].append(time.perf_counter() - t0)
    print(f'blocking s/scan ({precision}), median of 5: native projection '
          f'{float(np.median(runs["native"])):.4f} (runs '
          f'{[round(t, 4) for t in runs["native"]]}), numpy projection '
          f'{float(np.median(runs["numpy"])):.4f} (runs '
          f'{[round(t, 4) for t in runs["numpy"]]})')


def file_formats(scan):
    """8: the phantom written and read back as .nii.gz and .mha; returns
    the .nii.gz path."""
    from totalsegmentator2d_tpu_torch.io import write_image
    paths = {}
    for ext in ('nii.gz', 'mha'):
        path = paths[ext] = os.path.join(WORK, f'scan.{ext}')
        t0 = time.perf_counter()
        write_image(scan, path)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = read_image(path)
        t_read = time.perf_counter() - t0
        same = (np.array_equal(back.array, scan.array)
                and np.allclose(back.spacing, scan.spacing)
                and np.allclose(back.origin, scan.origin, atol=1e-5)
                and np.allclose(back.direction, scan.direction))
        print(f'.{ext}: write {t_write:.3f} s, read {t_read:.3f} s, '
              f'{os.path.getsize(path) / 2**20:.1f} MiB on disk; read back '
              f'equal: {same}')
        if not same:
            raise SystemExit(f'the phantom does not read back equal as .{ext}')
    return paths['nii.gz']


def visual_agreement(png, ref, labels):
    if labels:
        return float(np.array_equal(png, ref))
    diff = np.abs(png.astype(int) - ref.astype(int))
    if png.shape != ref.shape or diff.max() > 1:
        return 0.0
    return float((diff == 0).mean())


def save_visuals(res):
    """8: Result.save of one fast result as files, as visuals and as both;
    the prefilter launches of the 'all' save; the PNGs against the CPU
    renders of the same images. Returns the launches of the 'all' save."""
    from totalsegmentator2d_tpu_torch.ops.visual import create_visual
    times = {}
    for content in ('file', 'visual'):
        out = os.path.join(WORK, f'save_{content}')
        t0 = time.perf_counter()
        res.save(out, name='scan', content=content)
        torch.cuda.synchronize()
        times[content] = time.perf_counter() - t0
    out = os.path.join(WORK, 'save_all')
    reset_launches()
    t0 = time.perf_counter()
    res.save(out, name='scan', content='all')
    torch.cuda.synchronize()
    times['all'] = time.perf_counter() - t0
    launches = read_launches()
    files = sorted(os.listdir(out))
    expect = sorted(f'scan{s}.{e}' for s in ('', '.seg', '_max', '_mean')
                    for e in ('nrrd', 'png'))
    print(f'save of one fast result: files {times["file"]:.3f} s, visuals '
          f'{times["visual"]:.3f} s, both {times["all"]:.3f} s; launches of '
          f'the save with both: {launches}; wrote {files}')
    if files != expect:
        raise SystemExit(f'saved {files}, expected {expect}')
    if launches != {'bspline_prefilter': 6, 'fused_norm_act_conv': 0}:
        raise SystemExit(f'prefilter launches of save(content="all") '
                         f'{launches}, expected 6')
    renders = {
        'scan.png': (res.get_input(), dict(labels=False, axis='coronal')),
        'scan.seg.png': (res.get_segmentation(), dict(labels=True,
                                                      axis='coronal')),
        'scan_max.png': (res.get_projection('max'), {}),
        'scan_mean.png': (res.get_projection('mean'), {})}
    for name, (img, kw) in renders.items():
        png = png_pixels(os.path.join(out, name))
        ref = create_visual(img, device='cpu', **kw).array
        agree = visual_agreement(png, ref, kw.get('labels', False))
        print(f'{name}: {png.shape} {png.dtype}, against the CPU render '
              f'{"bit for bit" if kw.get("labels") else "equal on"} '
              f'{agree:.6f}')
        if agree < (1.0 if kw.get('labels') else 0.999):
            raise SystemExit(f'{name} differs from its CPU render')
    return launches


def http_nifti(tool, nii_path, seg):
    """8: one POST of the phantom as .nii.gz, answered as .nii.gz."""
    import urllib.request

    from totalsegmentator2d_tpu_torch.serve import TS2DServer
    with open(nii_path, 'rb') as f:
        body = f.read()
    with TS2DServer(tool, port=0) as srv:
        req = urllib.request.Request(
            f'http://127.0.0.1:{srv.port}/predict?input_format=nii.gz'
            f'&format=nii.gz', data=body, method='POST')
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            status, payload = r.status, r.read()
        wall = time.perf_counter() - t0
    out = os.path.join(WORK, 'resp.seg.nii.gz')
    with open(out, 'wb') as f:
        f.write(payload)
    back = read_image(out)
    agree = float((back.array == seg.array).mean()) \
        if back.array.shape == seg.array.shape else 0.0
    print(f'HTTP POST of a {len(body) / 2**20:.0f} MiB .nii.gz: status '
          f'{status} in {wall:.3f} s, {len(payload) / 2**20:.2f} MiB .nii.gz '
          f'answer; agreement with the in-process result {agree:.6f}')
    if status != 200 or agree < 0.99:
        raise SystemExit('the .nii.gz POST failed or disagrees')


def io_and_visuals(db, scan, host_build_s):
    """Phase 8. Returns the launches of one save(content='all')."""
    from totalsegmentator2d_tpu_torch.io import native
    phase('IO and visuals: the native host library, NIfTI / MetaImage, PNG '
          'visuals')
    if not native.native_available():
        raise SystemExit('the native host library is not available')
    print(f'native host library loaded from '
          f'{os.path.relpath(native._load()._name, ROOT)} (built in '
          f'{host_build_s:.2f} s, phase 1)')
    host_projection(scan)
    for precision in ('exact', 'fast'):
        with TS2D(key='ts2d-v9-flagship', use_remote=False, local=db,
                  param=FAST if precision == 'fast' else None) as tool:
            blocking_native_vs_numpy(tool, scan, precision)
            if precision == 'fast':
                nii = file_formats(scan)
                res = tool.predict(scan)
                launches = save_visuals(res)
                http_nifti(tool, nii, res.get_segmentation())
        gc.collect()
        torch.cuda.empty_cache()
    return launches


# -- 9. DICOM, zip and the CLI -------------------------------------------------

TS_EXPLICIT = '1.2.840.10008.1.2.1'
TS_JPEG_LL_SV1 = '1.2.840.10008.1.2.4.70'
CT_IMAGE_STORAGE = '1.2.840.10008.5.1.4.1.1.2'
UID_ROOT = '1.2.826.0.1.3680043.10.1138'   # this script's objects
FIXTURES = os.path.join(ROOT, 'tests', 'fixtures', 'dicom')
FIXTURE_NAMES = ('rle', 'deflate', 'jpeg-baseline8', 'jpeg-extended12',
                 'jpegls-lossless', 'jpegls-near', 'j2k-53', 'j2k-97')
JPEG_PRECISION = 16


def dicom_element(group, elem, vr, value):
    """One data element, explicit VR little endian; text padded to even
    length with a space (UI with a NUL), as PS3.5 6.2 says."""
    if isinstance(value, str):
        value = value.encode('ascii')
    if len(value) % 2:
        value += b'\0' if vr in (b'UI', b'OB', b'OW') else b' '
    head = struct.pack('<HH', group, elem) + vr
    if vr in (b'OB', b'OW', b'SQ', b'UN', b'UT'):
        return head + b'\0\0' + struct.pack('<I', len(value)) + value
    return head + struct.pack('<H', len(value)) + value


def dicom_ds(*values):
    return '\\'.join(repr(float(v)) for v in values)


def encapsulated(frames):
    """Encapsulated PixelData (PS3.5 A.4): OB of undefined length, an empty
    Basic Offset Table item, one fragment per frame, the delimiter."""
    out = [struct.pack('<HH', 0x7FE0, 0x0010) + b'OB\0\0'
           + struct.pack('<I', 0xFFFFFFFF), struct.pack('<HHI', 0xFFFE,
                                                        0xE000, 0)]
    for fr in frames:
        fr = fr + b'\0' if len(fr) % 2 else fr
        out += [struct.pack('<HHI', 0xFFFE, 0xE000, len(fr)), fr]
    out.append(struct.pack('<HHI', 0xFFFE, 0xE0DD, 0))
    return b''.join(out)


def dicom_file(path, ts, instance, position, frames=None, pixels=None,
               nframes=1, dz=None, spacing_xy=(0.78, 0.78), shape=(512, 512)):
    """A CT Image file: the file meta group, the patient geometry
    (ImagePositionPatient, ImageOrientationPatient, PixelSpacing), 12 bits
    stored in 16 with rescale slope 1 / intercept -1024, and the pixels:
    native (``pixels``, bytes) or encapsulated (``frames``). More than one
    frame makes a legacy multi-frame file (NumberOfFrames,
    SpacingBetweenSlices)."""
    sop = f'{UID_ROOT}.2.{instance}'
    meta_body = (dicom_element(0x0002, 0x0001, b'OB', b'\0\1')
                 + dicom_element(0x0002, 0x0002, b'UI', CT_IMAGE_STORAGE)
                 + dicom_element(0x0002, 0x0003, b'UI', sop)
                 + dicom_element(0x0002, 0x0010, b'UI', ts)
                 + dicom_element(0x0002, 0x0012, b'UI', UID_ROOT + '.0'))
    meta = dicom_element(0x0002, 0x0000, b'UL',
                         struct.pack('<I', len(meta_body))) + meta_body
    rows, cols = shape
    body = [dicom_element(0x0008, 0x0016, b'UI', CT_IMAGE_STORAGE),
            dicom_element(0x0008, 0x0018, b'UI', sop),
            dicom_element(0x0008, 0x0060, b'CS', 'CT'),
            dicom_element(0x0018, 0x0050, b'DS', dicom_ds(1.25))]
    if dz is not None:
        body.append(dicom_element(0x0018, 0x0088, b'DS', dicom_ds(dz)))
    body += [dicom_element(0x0020, 0x000D, b'UI', UID_ROOT + '.3'),
             dicom_element(0x0020, 0x000E, b'UI', UID_ROOT + '.4'),
             dicom_element(0x0020, 0x0013, b'IS', str(instance)),
             dicom_element(0x0020, 0x0032, b'DS', dicom_ds(*position)),
             dicom_element(0x0020, 0x0037, b'DS', dicom_ds(1, 0, 0, 0, 1, 0)),
             dicom_element(0x0028, 0x0002, b'US', struct.pack('<H', 1)),
             dicom_element(0x0028, 0x0004, b'CS', 'MONOCHROME2')]
    if nframes > 1:
        body.append(dicom_element(0x0028, 0x0008, b'IS', str(nframes)))
    body += [dicom_element(0x0028, 0x0010, b'US', struct.pack('<H', rows)),
             dicom_element(0x0028, 0x0011, b'US', struct.pack('<H', cols)),
             # PixelSpacing is (row, column) = (y, x)
             dicom_element(0x0028, 0x0030, b'DS',
                           dicom_ds(spacing_xy[1], spacing_xy[0])),
             dicom_element(0x0028, 0x0100, b'US', struct.pack('<H', 16)),
             dicom_element(0x0028, 0x0101, b'US', struct.pack('<H', 12)),
             dicom_element(0x0028, 0x0102, b'US', struct.pack('<H', 11)),
             dicom_element(0x0028, 0x0103, b'US', struct.pack('<H', 0)),
             dicom_element(0x0028, 0x1052, b'DS', '-1024'),
             dicom_element(0x0028, 0x1053, b'DS', '1')]
    body.append(encapsulated(frames) if frames is not None
                else dicom_element(0x7FE0, 0x0010, b'OW', pixels))
    with open(path, 'wb') as f:
        f.write(b'\0' * 128 + b'DICM' + meta + b''.join(body))


def huffman_lengths(counts):
    """Code lengths of a Huffman code for the symbols with counts > 0, with
    one reserved symbol of count 1 beside them so that no code is all ones
    (T.81 K.2); None when a code would pass 16 bits."""
    heap = [(int(c), i, (i,)) for i, c in enumerate(counts) if c > 0]
    heap.append((1, len(counts), (len(counts),)))  # the reserved symbol
    heapq.heapify(heap)
    lengths = np.zeros(len(counts) + 1, np.int64)
    while len(heap) > 1:
        c1, i1, s1 = heapq.heappop(heap)
        c2, i2, s2 = heapq.heappop(heap)
        lengths[list(s1 + s2)] += 1
        heapq.heappush(heap, (c1 + c2, min(i1, i2), s1 + s2))
    return None if lengths.max() > 16 else lengths[:-1]


def jpegll_encode(plane):
    """One (rows, cols) uint16 plane as a JPEG Lossless codestream (T.81
    process 14, selection value 1: each sample predicted by its left
    neighbour, the first column by the sample above), with a Huffman table
    built from this plane's difference categories, in numpy."""
    rows, cols = plane.shape
    v = plane.astype(np.int64)
    pred = np.empty_like(v)
    pred[:, 1:] = v[:, :-1]
    pred[1:, 0] = v[:-1, 0]
    pred[0, 0] = 1 << (JPEG_PRECISION - 1)
    d = (v - pred).ravel()  # in (-2^16, 2^16): taken modulo 2^16 below
    d = np.where(d >= 32768, d - 65536, np.where(d < -32768, d + 65536, d))
    ssss = np.frexp(np.abs(d).astype(np.float64))[1].astype(np.int64)
    # category 16 is the one difference 32768 (= -32768), with no extra bits
    extra = np.where(ssss == 16, 0, np.where(d > 0, d, d + (1 << ssss) - 1))
    counts = np.bincount(ssss, minlength=17)
    lengths = huffman_lengths(counts)
    if lengths is None:  # a flat 5-bit code: 17 symbols, none all ones
        lengths = np.full(17, 5)
    codes = np.zeros(17, np.int64)
    code, order = 0, []
    for n in range(1, 17):
        for sym in np.flatnonzero(lengths == n):
            codes[sym] = code
            code += 1
            order.append(int(sym))
        code <<= 1
    n_extra = np.where(ssss == 16, 0, ssss)
    nbits = lengths[ssss] + n_extra
    value = (codes[ssss] << n_extra) | extra
    ends = np.cumsum(nbits)
    total = int(ends[-1])
    owner = np.repeat(np.arange(d.size), nbits)
    k = np.arange(total) - np.repeat(ends - nbits, nbits)
    bits = ((value[owner] >> (nbits[owner] - 1 - k)) & 1).astype(np.uint8)
    pad = (-total) % 8
    packed = np.packbits(np.concatenate([bits, np.ones(pad, np.uint8)]))
    ff = np.flatnonzero(packed == 0xFF)
    data = np.insert(packed, ff + 1, 0).tobytes()  # byte stuffing

    def seg(marker, payload):
        return bytes([0xFF, marker]) + struct.pack('>H', len(payload) + 2) \
            + payload

    dht = seg(0xC4, bytes([0x00]) + bytes(int((lengths == n).sum())
                                          for n in range(1, 17))
              + bytes(order))
    sof = seg(0xC3, bytes([JPEG_PRECISION]) + struct.pack('>HH', rows, cols)
              + bytes([1, 1, 0x11, 0]))
    sos = seg(0xDA, bytes([1, 1, 0x00, 1, 0, 0]))
    return b'\xff\xd8' + dht + sof + sos + data + b'\xff\xd9'


def write_series(root, scan, ts):
    """The scan as one slice file per z plane (stored value = HU + 1024),
    encoded on 8 threads; returns the seconds it took and the JPEG
    codestreams (None for native pixels)."""
    from concurrent.futures import ThreadPoolExecutor
    os.makedirs(root, exist_ok=True)
    stored = (scan.array.astype(np.int32) + 1024).astype(np.uint16)
    sx, sy, sz = scan.spacing

    def one(z):
        frame = jpegll_encode(stored[z]) if ts == TS_JPEG_LL_SV1 else None
        kw = dict(frames=[frame]) if frame is not None \
            else dict(pixels=stored[z].tobytes())
        dicom_file(os.path.join(root, f'ct{z:04d}.dcm'), ts, z + 1,
                   (0.0, 0.0, z * sz), spacing_xy=(sx, sy),
                   shape=stored.shape[1:], **kw)
        return frame

    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        frames = list(pool.map(one, range(stored.shape[0])))
    return time.perf_counter() - t0, (frames if frames[0] is not None
                                      else None)


def same_geometry(a, b):
    return (tuple(a.spacing) == tuple(b.spacing)
            and tuple(a.origin) == tuple(b.origin)
            and np.array_equal(np.asarray(a.direction), np.asarray(b.direction)))


def geometry_note(a, b):
    return (f'spacing {tuple(a.spacing)} / {tuple(b.spacing)}, origin '
            f'{tuple(a.origin)} / {tuple(b.origin)}, direction equal '
            f'{np.array_equal(np.asarray(a.direction), np.asarray(b.direction))}')


def dicom_reads(series, nrrd_img, scan):
    """9.1: read_image of both full series with the native library."""
    from totalsegmentator2d_tpu_torch.io import native
    if not native.native_available():
        raise SystemExit('the native host library is not available')
    for name, path in series.items():
        read_image(path)  # warm: the decode pool and the file cache
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            img = read_image(path)
            times.append(time.perf_counter() - t0)
        t = float(np.median(times))
        n = img.array.shape[0]
        equal = (img.array.dtype == scan.array.dtype
                 and np.array_equal(img.array, scan.array))
        geo = same_geometry(img, nrrd_img)
        print(f'read_image of the {name} series ({n} files, '
              f'{sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)) / 2**20:.1f} MiB): '
              f'median of 3 {t:.3f} s (runs {[round(x, 3) for x in times]}), '
              f'{n / t:.1f} slices/s; array bit for bit {equal}; geometry '
              f'equal to the NRRD read {geo} ({geometry_note(img, nrrd_img)})')
        if not equal:
            raise SystemExit(f'the {name} series does not read as the phantom')
        if not geo:
            raise SystemExit(f'the {name} series geometry differs from the '
                             f'NRRD read')


def decode_ms(fn, n=3):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return out, float(np.median(times)) * 1e3


def dicom_syntaxes(series):
    """9.2: each syntax, the native decode against the Python path (the
    wrappers forced to None in this phase), bit for bit, ms per slice."""
    from totalsegmentator2d_tpu_torch.io import dicom
    cases = [(n, [os.path.join(FIXTURES, f'{n}.dcm')]) for n in FIXTURE_NAMES]
    for name, path in series.items():
        files = sorted(os.listdir(path))
        pick = [files[i] for i in np.linspace(0, len(files) - 1, 4).astype(int)]
        cases.append((f'{name} series', [os.path.join(path, f) for f in pick]))
    with np.load(os.path.join(FIXTURES, 'decoded.npz')) as z:
        stored = {n: z[n] for n in FIXTURE_NAMES}

    def decode(paths):
        return np.stack([np.stack([f['array'] for f in
                                   dicom.read_dicom_file(p)['frames']])
                         for p in paths])

    rows = []
    for name, paths in cases:
        nat, nat_ms = decode_ms(lambda: decode(paths))
        with native_off():
            py, py_ms = decode_ms(lambda: decode(paths), n=1 if 'series'
                                  in name else 3)
        equal = nat.dtype == py.dtype and np.array_equal(nat, py)
        ref = stored.get(name)
        ref_ok = ref is None or np.array_equal(nat[0], ref)
        shape = 'x'.join(map(str, nat.shape[-2:]))
        rows.append(name)
        print(f'{name}: {len(paths)} slice(s) of {shape}, native '
              f'{nat_ms / len(paths):.3f} ms/slice, Python '
              f'{py_ms / len(paths):.3f} ms/slice; native = Python bit for '
              f'bit {equal}'
              + ('' if ref is None else f'; = the reference decode {ref_ok}'))
        if not (equal and ref_ok):
            raise SystemExit(f'{name}: the native and Python decodes differ')
    return rows


def dicom_predicts(db, series_dir, nrrd_path, fused_per_scan):
    """9.3: TS2D.predict of the JPEG Lossless series at both precisions,
    batching off: launches, blocking seconds (median of 5, the read
    included), the masks against the NRRD read's (1.0: 9.1 found the
    geometry bit-equal). Returns the exact masks."""
    masks = {}
    for precision in ('exact', 'fast'):
        expect = {'bspline_prefilter': 2,
                  'fused_norm_act_conv': fused_per_scan
                  if precision == 'fast' else 0}
        with TS2D(key='ts2d-v9-flagship', use_remote=False, local=db,
                  batching=False,
                  param=FAST if precision == 'fast' else None) as tool:
            reset_launches()
            seg = tool.predict(series_dir).get_segmentation().array
            torch.cuda.synchronize()
            launches = read_launches()
            ref = tool.predict(nrrd_path).get_segmentation().array
            agree = float((seg == ref).mean()) if seg.shape == ref.shape \
                else 0.0
            dcm_s, dcm_runs = median_s(lambda: tool.predict(series_dir))
            nrrd_s, nrrd_runs = median_s(lambda: tool.predict(nrrd_path))
        print(f'TS2D.predict of the JPEG Lossless series ({precision}): '
              f'launches {launches}; blocking median of 5 {dcm_s:.4f} s '
              f'(runs {dcm_runs}), the NRRD file {nrrd_s:.4f} s (runs '
              f'{nrrd_runs}); masks against the NRRD read {agree:.6f}')
        if launches != expect:
            raise SystemExit(f'DICOM predict launches {launches}, expected '
                             f'{expect}')
        if agree < 1.0:
            raise SystemExit(f'DICOM/NRRD mask agreement {agree} < 1.0')
        masks[precision] = seg
        gc.collect()
        torch.cuda.empty_cache()
    return masks['exact']


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def dicom_server(db, series_dir, frames, shape, solo_seg):
    """9.4: ts2d-torch-serve (python -m ...serve) on 127.0.0.1: the JPEG
    Lossless series zipped (input_format=zip), and its codestreams as one
    legacy multi-frame file (NumberOfFrames, SpacingBetweenSlices; a single
    slice is a one-channel 2-D image, which the two-channel CT models
    refuse) as input_format=dcm; each mask against the solo one."""
    import signal
    import urllib.error
    import urllib.request
    import zipfile
    zpath = os.path.join(WORK, 'series.zip')
    with zipfile.ZipFile(zpath, 'w') as zf:  # stored: JPEG is compressed
        for name in sorted(os.listdir(series_dir)):
            zf.write(os.path.join(series_dir, name), f'study/ct/{name}')
    mf = os.path.join(WORK, 'multiframe.dcm')
    dicom_file(mf, TS_JPEG_LL_SV1, 1, (0.0, 0.0, 0.0), frames=frames,
               nframes=len(frames), dz=1.25, shape=shape)
    port = free_port()
    log = open(os.path.join(WORK, 'serve.log'), 'w')
    proc = subprocess.Popen(
        [sys.executable, '-m', 'totalsegmentator2d_tpu_torch.serve',
         '--local', db, '--model', 'ts2d-v9-flagship', '--port', str(port),
         '--no-fetch'], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    try:
        t0 = time.perf_counter()
        while True:
            if proc.poll() is not None:
                raise SystemExit(f'the server exited with {proc.returncode}')
            try:
                with urllib.request.urlopen(
                        f'http://127.0.0.1:{port}/health', timeout=5) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            if time.perf_counter() - t0 > 300:
                raise SystemExit('the server did not come up in 300 s')
            time.sleep(0.5)
        print(f'ts2d-torch-serve up on 127.0.0.1:{port} in '
              f'{time.perf_counter() - t0:.1f} s')
        for fmt, path in (('zip', zpath), ('dcm', mf)):
            with open(path, 'rb') as f:
                body = f.read()
            req = urllib.request.Request(
                f'http://127.0.0.1:{port}/predict?input_format={fmt}',
                data=body, method='POST')
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=600) as r:
                    status, payload = r.status, r.read()
            except urllib.error.HTTPError as ex:
                raise SystemExit(f'the {fmt} POST answered {ex.code}: '
                                 f'{ex.read()[:500]}')
            wall = time.perf_counter() - t0
            out = os.path.join(WORK, f'resp_{fmt}.seg.nrrd')
            with open(out, 'wb') as f:
                f.write(payload)
            seg = read_image(out).array
            agree = float((seg == solo_seg).mean()) \
                if seg.shape == solo_seg.shape else 0.0
            print(f'POST input_format={fmt} ({len(body) / 2**20:.1f} MiB): '
                  f'status {status} in {wall:.3f} s; agreement with the solo '
                  f'mask {agree:.6f}')
            if status != 200 or agree < 1.0:
                raise SystemExit(f'the {fmt} POST failed or disagrees')
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)
        log.close()
    print(f'the server stopped (exit {proc.returncode})')


def dicom_cli(db, series_dir, nrrd_path):
    """9.5: python -m totalsegmentator2d_tpu_torch on a study folder that
    holds one series subdirectory and one NRRD: two cases, no error."""
    study = os.path.join(WORK, 'study')
    os.makedirs(study)
    os.symlink(series_dir, os.path.join(study, 'series'))
    os.symlink(nrrd_path, os.path.join(study, 'ct.nrrd'))
    out = os.path.join(WORK, 'cli_out')
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'totalsegmentator2d_tpu_torch', '-i', study,
         '-o', out, '--local', db, '--model', 'ts2d-v9-flagship',
         '--no-fetch'], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    wall = time.perf_counter() - t0
    files = sorted(os.listdir(out)) if os.path.isdir(out) else []
    expect = sorted(f'{n}{s}.nrrd' for n in ('ct', 'series')
                    for s in ('.seg', '_max', '_mean'))
    print(f'CLI on a study folder (a series subdirectory and an NRRD): exit '
          f'{proc.returncode} in {wall:.1f} s; wrote {files}')
    if proc.returncode != 0 or files != expect or 'Traceback' in proc.stderr:
        raise SystemExit(f'the CLI failed on the study folder:\n'
                         f'{proc.stderr[-3000:]}')


def dicom_phase(db, scan, fused_per_scan):
    """Phase 9."""
    from totalsegmentator2d_tpu_torch.io import write_image
    phase('DICOM, zip and the CLI: the phantom as explicit VR and JPEG '
          'Lossless series')
    series = {'explicit VR': os.path.join(WORK, 'dicom_explicit'),
              'JPEG Lossless': os.path.join(WORK, 'dicom_jpegll')}
    for (name, path), ts in zip(series.items(), (TS_EXPLICIT, TS_JPEG_LL_SV1)):
        seconds, frames = write_series(path, scan, ts)
        print(f'wrote the {name} series in {seconds:.1f} s')
    nrrd_path = os.path.join(WORK, 'scan.nrrd')
    write_image(scan, nrrd_path)
    dicom_reads(series, read_image(nrrd_path), scan)
    dicom_syntaxes(series)
    solo = dicom_predicts(db, series['JPEG Lossless'], nrrd_path,
                          fused_per_scan)
    dicom_server(db, series['JPEG Lossless'], frames, scan.array.shape[1:],
                 solo)
    dicom_cli(db, series['JPEG Lossless'], nrrd_path)


# -- 10. training on the card -------------------------------------------------

VERTEBRAE = 26   # the vertebrae group's labels


def vertebrae_case(shape, seed):
    """A 2-channel (max, mean) training case: a spine column of VERTEBRAE
    stacked label bands over soft tissue, with noise; (image (H, W, 2)
    float32, labelmap (H, W) uint8 in 0..VERTEBRAE)."""
    h, w = shape
    rng = np.random.default_rng(seed)
    lm = np.zeros((h, w), np.uint8)
    x0 = int(w * (0.40 + 0.05 * rng.random()))
    x1 = x0 + max(8, w // 6)
    y0, band = int(h * 0.05), max(2, int(h * 0.9) // VERTEBRAE)
    for v in range(VERTEBRAE):
        lm[y0 + v * band + 1:y0 + (v + 1) * band, x0:x1] = v + 1
    noise = rng.standard_normal((h, w, 2)).astype(np.float32)
    img = np.stack([200 + 700 * (lm > 0) + 40 * noise[..., 0],
                    80 + 10 * lm + 20 * noise[..., 1]], -1)
    return img.astype(np.float32), lm


def one_hot(lm):
    return np.stack([lm == v for v in range(1, VERTEBRAE + 1)],
                    -1).astype(np.uint8)


def flagship_train_spec():
    from totalsegmentator2d_tpu_torch.models.plans import ModelSpec
    n = FLAGSHIP['n_stages']
    plans = {'configurations': {'2d': {
        'patch_size': list(FLAGSHIP['patch']),
        'spacing': list(FLAGSHIP['spacing']),
        'normalization_schemes': ['ZScoreNormalization'] * 2,
        'use_mask_for_norm': [False, False],
        'architecture': {'arch_kwargs': {
            'n_stages': n, 'features_per_stage': list(FLAGSHIP['features']),
            'kernel_sizes': [[3, 3]] * n,
            'strides': [[1, 1]] + [[2, 2]] * (n - 1),
            'n_conv_per_stage': [2] * n, 'n_conv_per_stage_decoder': [2] * (n - 1),
            'conv_bias': True, 'norm_op_kwargs': {'eps': 1e-05, 'affine': True},
            'nonlin_kwargs': {'inplace': True}}}}}}
    dataset = {'channel_names': {'0': 'max', '1': 'mean'},
               'labels': {'background': 0, **{f'vertebrae_{v}': v for v in
                                              range(1, VERTEBRAE + 1)}},
               'file_ending': '.nrrd', 'multilabel': True}
    spec = parse_model_spec(plans, dataset)
    assert isinstance(spec, ModelSpec)
    return spec


def train_timed(spec, cases, dtype):
    """Phase 10a at one compute dtype: 2 warm-up steps, then 5 steps with
    the launch counts set to 0 just before and read just after; the
    low-resolution levels' share of the prefilter's launches is counted
    around each level (the rest are the warp stack's). Returns (s/step
    median, peak GiB, {call site: prefilter launches per step}, losses)."""
    from totalsegmentator2d_tpu_torch.training import (PatchSampler,
                                                       TrainConfig, Trainer)
    cfg = TrainConfig(total_steps=100, augment=True, deep_supervision=True,
                      compute_dtype=dtype)
    sampler = PatchSampler(cases, FLAGSHIP['patch'], seed=1)
    batches = [sampler.sample_batch(TRAIN_BATCH, pack_targets=True)
               for _ in range(7)]
    tr = Trainer(spec.arch, cfg, seed=0)
    for b in batches[:2]:
        tr.step(b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    with lowres_launches() as lowres:
        reset_launches()
        for b in batches[2:]:
            t0 = time.perf_counter()
            loss = float(tr.step(b))        # waits for the step
            times.append(time.perf_counter() - t0)
            losses.append(loss)
        ran = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tr.close()
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    if not np.isfinite(losses).all():
        raise SystemExit(f'training ({dtype}): losses {losses}')
    sites = {'train_warp': (ran['bspline_prefilter'] - lowres[0]) / len(times),
             'train_lowres': lowres[0] / len(times)}
    if sites['train_warp'] != 2 or ran['fused_norm_act_conv']:
        raise SystemExit(f'training ({dtype}): kernel launches {ran}, '
                         f'of which low-res {lowres[0]}')
    return float(np.median(times)), peak, sites, losses


def loss_falls(spec, cases, dtype, steps=20):
    """20 steps on one repeated batch, augment off: the loss must fall."""
    from totalsegmentator2d_tpu_torch.training import (PatchSampler,
                                                       TrainConfig, Trainer)
    batch = PatchSampler(cases, FLAGSHIP['patch'], seed=2).sample_batch(
        TRAIN_BATCH, pack_targets=True)
    tr = Trainer(spec.arch, TrainConfig(total_steps=steps,
                                        compute_dtype=dtype), seed=0)
    t0 = time.perf_counter()
    losses = [float(tr.step(batch)) for _ in range(steps)]
    wall = time.perf_counter() - t0
    tr.close()
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise SystemExit(f'training ({dtype}) loss did not fall: {losses}')
    return losses, wall


def train_gpu_vs_cpu(smi):
    """Phase 10b: the SMALL architecture, the same weights (the reference's
    host initializer) and batch on both devices, 3 steps, augment off."""
    from totalsegmentator2d_tpu_torch.models.convert import (load_into,
                                                             params_from_jax)
    from totalsegmentator2d_tpu_torch.models.plans import ArchSpec
    from totalsegmentator2d_tpu_torch.models.unet import init_params_np
    from totalsegmentator2d_tpu_torch.training import TrainConfig, Trainer
    n = SMALL['n_stages']
    arch = ArchSpec(n_stages=n, features_per_stage=SMALL['features'],
                    kernel_sizes=((3, 3),) * n,
                    strides=((1, 1),) + ((2, 2),) * (n - 1),
                    n_conv_per_stage=(2,) * n,
                    n_conv_per_stage_decoder=(2,) * (n - 1), in_channels=2,
                    out_channels=VERTEBRAE)
    sd = params_from_jax(init_params_np(3, arch))
    img, lm = vertebrae_case((128, 128), seed=40)
    rng = np.random.default_rng(41)
    batch = {'image': np.stack([img[:64, 32:96], img[64:, 32:96]]),
             'target': np.stack([one_hot(lm[:64, 32:96]),
                                 one_hot(lm[64:, 32:96])])}
    batch['image'] += rng.standard_normal(batch['image'].shape).astype(np.float32)
    batch['image'] = (batch['image'] - 300) / 300
    losses = {}
    for device in ('cuda', 'cpu'):
        tr = Trainer(arch, TrainConfig(total_steps=10), seed=0, device=device)
        load_into(tr.model, sd)
        losses[device] = [float(tr.step(batch)) for _ in range(3)]
        tr.close()
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses['cuda'],
                                                  losses['cpu']))
    print(f'train GPU vs CPU (SMALL, fp32, 3 steps): losses '
          f'{[round(v, 6) for v in losses["cuda"]]} / '
          f'{[round(v, 6) for v in losses["cpu"]]}, max rel diff {rel:.3g} '
          f'[{smi}]')
    if rel > 1e-3:
        raise SystemExit(f'training GPU/CPU losses differ by {rel} > 1e-3')


def png_file(path, arr):
    """This script's PNG encoder: 8- or 16-bit gray, filter 0, one IDAT."""
    import zlib
    arr = np.asarray(arr)
    depth = 16 if arr.dtype == np.uint16 else 8
    h, w = arr.shape
    rows = arr.astype('>u2' if depth == 16 else np.uint8).reshape(h, -1)
    raw = b''.join(b'\0' + r.tobytes() for r in rows)

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body
                + struct.pack('>I', zlib.crc32(kind + body)))
    with open(path, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n'
                + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, depth, 0, 0,
                                             0, 0))
                + chunk(b'IDAT', zlib.compress(raw, 6)) + chunk(b'IEND', b''))


def write_png_dataset(root, n_cases=8, shape=(256, 256)):
    """An nnU-Net raw 2D dataset: 2 channels per case as 16-bit
    _0000.png / _0001.png, a labelmap PNG per case, multilabel."""
    os.makedirs(os.path.join(root, 'imagesTr'))
    os.makedirs(os.path.join(root, 'labelsTr'))
    with open(os.path.join(root, 'dataset.json'), 'w') as f:
        json.dump({'channel_names': {'0': 'max', '1': 'mean'},
                   'labels': {'background': 0,
                              **{f'vertebrae_{v}': v
                                 for v in range(1, VERTEBRAE + 1)}},
                   'numTraining': n_cases, 'file_ending': '.png',
                   'multilabel': True}, f)
    for i in range(n_cases):
        img, lm = vertebrae_case(shape, seed=50 + i)
        for c in range(2):
            png_file(os.path.join(root, 'imagesTr', f'case{i:02d}_{c:04d}.png'),
                     np.clip(img[..., c] + 1024, 0, 65535).astype(np.uint16))
        png_file(os.path.join(root, 'labelsTr', f'case{i:02d}.png'), lm)


def train_cli():
    """Phase 10c: ts2d-torch-train as a subprocess on a PNG dataset, then
    the exported model through the port's Zoo on the card and eval."""
    from totalsegmentator2d_tpu_torch.eval import evaluate
    from totalsegmentator2d_tpu_torch.inference import Zoo
    from totalsegmentator2d_tpu_torch.io import write_image
    from totalsegmentator2d_tpu_torch.ops.annotations import set_annotation_meta
    from totalsegmentator2d_tpu_torch.training import load_raw_dataset
    data = os.path.join(WORK, 'Dataset510_vertebrae')
    out = os.path.join(WORK, 'trained')
    pack = os.path.join(WORK, 'share', 'vertebrae.zip')
    write_png_dataset(data)
    cmd = [sys.executable, '-m', 'totalsegmentator2d_tpu_torch.training.cli',
           '-d', data, '-o', out, '--model', 'ts2d-v9-trained',
           '--group', 'vertebrae', '--steps', '20', '--batch-size', '8',
           '--max-patch', '256', '--folds', '2', '--log-every', '10',
           '--augment', '--pack', pack]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines or 'Traceback' in proc.stderr:
        raise SystemExit(f'ts2d-torch-train failed ({proc.returncode}):\n'
                         f'{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}')
    mid = lines[-1]
    dice = [ln for ln in lines if 'holdout Dice' in ln]
    print(f'ts2d-torch-train (subprocess, 8 PNG cases, 2 folds x 20 steps, '
          f'batch 8, --augment --pack): {wall:.1f} s, model {mid}')
    for ln in dice:
        print(f'  {ln[:160]}')
    if len(dice) != 2 or not os.path.getsize(pack):
        raise SystemExit('ts2d-torch-train: no holdout Dice or no zip')
    img, seg = load_raw_dataset(data)[0][0]
    res = {}
    for precision in ('exact', 'fast'):
        hosted = Zoo(remote=False, local=out).load(
            mid, param={'nnu': {'predict': {'precision': precision}}})
        hosted.start()
        reset_launches()
        t0 = time.perf_counter()
        pred = hosted.apply(img)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ran = read_launches()
        hosted.stop()
        res[precision] = pred
        print(f'exported model through the Zoo on the card ({precision}): '
              f'{pred.array.shape} {pred.array.dtype}, {ms:.1f} ms, '
              f'launches {ran}')
        if (pred.array.shape != img.array.shape[:2] + (VERTEBRAE,)
                or (ran['fused_norm_act_conv'] > 0) != (precision == 'fast')):
            raise SystemExit(f'exported model predict ({precision}) failed')
    gt = MedicalImage(array=seg.array, spacing=img.spacing, is_vector=True)
    names = {v: f'vertebrae_{v}' for v in range(1, VERTEBRAE + 1)}
    set_annotation_meta(gt, names=names,
                        colors={n: '#e3a81c' for n in names.values()})
    paths = [os.path.join(WORK, n) for n in ('pred.nrrd', 'gt.nrrd')]
    write_image(res['exact'], paths[0])
    write_image(gt, paths[1])
    ev = evaluate(*paths)
    agree = float((res['exact'].array == res['fast'].array).mean())
    print(f'eval.evaluate(pred, gt) on the card: mean Dice '
          f'{ev["mean_dice"]:.4f} over {ev["n_labels"]} labels; fast vs '
          f'exact mask agreement {agree:.6f}')
    if ev['n_labels'] != VERTEBRAE or not 0 <= ev['mean_dice'] <= 1:
        raise SystemExit(f'eval failed: {ev}')


def training(smi):
    """Phase 10. Returns the prefilter's launches at training's call sites:
    per preprocessed case, and per step (bf16 run) of the warp stack and of
    the low-resolution levels."""
    from totalsegmentator2d_tpu_torch.training import preprocess_case
    phase('training: the flagship group model (vertebrae, 26 labels), '
          f'batch {TRAIN_BATCH}, deep supervision, augment on')
    spec = flagship_train_spec()
    cases = []
    reset_launches()
    t0 = time.perf_counter()
    for i in range(4):
        img, lm = vertebrae_case(TRAIN_CASE[:2], seed=30 + i)
        cases.append(preprocess_case(
            MedicalImage(array=img, spacing=TRAIN_SPACING, is_vector=True),
            MedicalImage(array=one_hot(lm), spacing=TRAIN_SPACING,
                         is_vector=True), spec))
    per_case = read_launches()['bspline_prefilter'] / 4
    print(f'preprocess_case x4 {TRAIN_CASE} -> {cases[0][0].shape}: '
          f'{time.perf_counter() - t0:.2f} s, prefilter {per_case:g} '
          f'launches per case')
    if per_case != 2:
        raise SystemExit(f'preprocessing prefilter launches {per_case}')
    for dtype in (None, 'bfloat16'):
        name = dtype or 'float32'
        step_s, peak, sites, losses = train_timed(spec, cases, dtype)
        print(f'Trainer.step ({name}): {step_s:.4f} s/step (median of 5 after '
              f'2 warm-up), {TRAIN_BATCH / step_s:.1f} patches/s, peak '
              f'{peak:.2f} GiB, prefilter launches/step: warp stack '
              f'{sites["train_warp"]:g}, low-res levels '
              f'{sites["train_lowres"]:g}; losses '
              f'{[round(v, 4) for v in losses]} [{smi}]')
        falls, wall = loss_falls(spec, cases, dtype)
        print(f'loss over 20 steps on one batch, augment off ({name}): '
              f'{falls[0]:.4f} -> {falls[-1]:.4f} '
              f'({wall / len(falls):.4f} s/step) [{smi}]')
    train_gpu_vs_cpu(smi)
    train_cli()
    return {'train_preprocess': per_case, **sites}


# -- 11. parallel/: the sharded programs on torch.distributed -----------------

PAR = os.path.join(WORK, 'parallel')   # the ranks' inputs and results
RANK_TIMEOUT = 300                     # s a rank subprocess may take
PAR_BATCH = 16                         # the data=2 training step's batch


def flagship_set(db, fast=False, **kw):
    """An EnsembleEngine of the flagship database's 5 groups."""
    from totalsegmentator2d_tpu_torch.inference import EnsembleEngine, Zoo
    zoo = Zoo(local=db)
    hosted = [zoo.load(i) for i in zoo.resolve('ts2d-v9-flagship',
                                               unique_model=True)]
    return EnsembleEngine([m.spec for m in hosted],
                          [m.load_fold_params() for m in hosted],
                          compute_dtype=torch.bfloat16 if fast else None, **kw)


def par_batch(n):
    """A training batch of n vertebrae cases at the flagship patch, the
    same on every rank."""
    cases = [vertebrae_case(FLAGSHIP['patch'], seed=60 + i) for i in range(n)]
    img = np.stack([c[0] for c in cases])
    return {'image': (img - 300) / 300,
            'target': np.stack([one_hot(c[1]) for c in cases])}


def par_train(mesh, batch, steps=2, spatial=False, **cfg):
    """(losses, s of the last step) of a flagship Trainer, seed 0 (fp32
    unless ``cfg`` says otherwise)."""
    from totalsegmentator2d_tpu_torch.training import TrainConfig, Trainer
    tr = Trainer(flagship_train_spec().arch,
                 TrainConfig(total_steps=10, **cfg), mesh=mesh, seed=0,
                 spatial=spatial)
    losses = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(tr.step(batch)))
        dt = time.perf_counter() - t0
    tr.close()
    return losses, dt


@contextlib.contextmanager
def lowres_launches():
    """Counts the prefilter's launches inside augmentation's low-resolution
    levels (the rest of a step's are the warp stack's): yields a list whose
    one entry grows."""
    from totalsegmentator2d_tpu_torch.training import augment as AUG
    count, level = [0], AUG.lowres_level

    def counted_level(x, z):
        before = PF.bspline_prefilter_cuda.launches
        out = level(x, z)
        count[0] += PF.bspline_prefilter_cuda.launches - before
        return out

    AUG.lowres_level = counted_level
    try:
        yield count
    finally:
        AUG.lowres_level = level


def timed(fn):
    """(fn(), its blocking seconds, its kernel launches)."""
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_launches()


def rank_main(rank, world, port):
    """One gloo rank of phase 11 (``chip_smoke.py --rank r --world n
    --port p``): the tile-sharded scan at 'exact' and 'fast', cohort data
    parallelism and predict_cohort_distributed, a data=2, a model=2 and
    two height-sharded training steps, the peak memory of each; writes its
    masks and numbers under PAR."""
    import torch.distributed as dist

    from totalsegmentator2d_tpu_torch.parallel import (
        init_distributed, make_mesh, predict_cohort_distributed)
    init_distributed(f'127.0.0.1:{port}', world, rank, backend='gloo')
    db = os.path.join(WORK, 'db_flagship')
    arr = np.load(os.path.join(PAR, 'arr.npy'))
    vols = np.load(os.path.join(PAR, 'vols.npy'), mmap_mode='r')
    mesh = make_mesh({'data': world})
    res, arrays = {'device': str(torch.cuda.current_device())}, {}
    torch.cuda.reset_peak_memory_stats()
    for prec in ('exact', 'fast'):
        engine = flagship_set(db, prec == 'fast', tile_mesh=mesh)
        engine.predict_array(arr, SPACING_YX)          # builds the program
        seg, dt, ran = timed(lambda: engine.predict_array(arr, SPACING_YX))
        arrays[f'tile_{prec}'] = np.packbits(seg, -1)
        res[f'tile_{prec}'] = {'s': dt, 'launches': ran}
        engine.close()
        engine = flagship_set(db, prec == 'fast')
        engine.predict_cohort(vols, SPACING_YX, MODES, mesh=mesh)
        segs, dt, ran = timed(lambda: engine.predict_cohort(
            vols, SPACING_YX, MODES, mesh=mesh))
        arrays[f'cohort_{prec}'] = np.packbits(segs, -1)
        res[f'cohort_{prec}'] = {'s': dt, 'launches': ran}
        if prec == 'exact':
            mine = vols[:5] if rank == 0 else vols[5:]
            segs, dt, ran = timed(lambda: predict_cohort_distributed(
                engine, mine, SPACING_YX, MODES, mesh=mesh, gather=True))
            arrays['dist'] = np.packbits(segs, -1)
            res['dist'] = {'s': dt, 'launches': ran}
        engine.close()
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    peak = 0.0
    sp = {'data': 1, 'model': world}
    for name, axes, n, kw in (
            ('train_data2', {'data': world}, PAR_BATCH, {}),
            ('train_model2', {'model': world}, 2, {}),
            ('train_spatial2', sp, 2, {'spatial': True}),
            ('train_spatial2_aug', sp, TRAIN_BATCH,
             {'spatial': True, 'compute_dtype': 'bfloat16',
              'augment': True})):
        peak = max(peak, torch.cuda.max_memory_allocated() / 2 ** 30)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        batch = par_batch(n)
        with lowres_launches() as lowres:
            (losses, dt), _, ran = timed(lambda: par_train(make_mesh(axes),
                                                          batch, **kw))
        res[name] = {'losses': losses, 's': dt, 'launches': ran,
                     'lowres': lowres[0],
                     'peak_gib': torch.cuda.max_memory_allocated() / 2 ** 30}
    res['peak_gib'] = max(peak, torch.cuda.max_memory_allocated() / 2 ** 30)
    np.savez(os.path.join(PAR, f'rank{rank}.npz'), **arrays)
    with open(os.path.join(PAR, f'rank{rank}.json'), 'w') as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def nccl_probe_main(rank, world, port):
    """Two NCCL ranks on the one card: the first collective tells whether
    NCCL takes them (it is expected to refuse)."""
    import torch.distributed as dist

    from totalsegmentator2d_tpu_torch.parallel import init_distributed
    init_distributed(f'127.0.0.1:{port}', world, rank)
    t = torch.ones(1, device='cuda')
    dist.all_reduce(t)
    torch.cuda.synchronize()
    print(f'NCCL all_reduce on rank {rank}: {float(t)}')
    dist.destroy_process_group()


def run_ranks(flag, world, timeout):
    """``world`` processes of this script with ``flag``; [(rc, output)];
    every process still running after ``timeout`` s is killed (rc None)."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, str(r), str(world),
         str(port)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=dict(os.environ, PYTHONPATH=ROOT))
        for r in range(world)]
    out = []
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            text = p.communicate(timeout=max(1, deadline - time.monotonic()))[0]
            out.append((p.returncode, text.decode(errors='replace')))
        except subprocess.TimeoutExpired:
            p.kill()
            out.append((None, p.communicate()[0].decode(errors='replace')))
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    return out


def parallel_phase(db, smi):
    """Phase 11: the world-1 NCCL tile-sharded scan in this process, the
    NCCL probe of two ranks on one card, then two gloo ranks sharing the
    card against this process's one-rank results. Returns each rank's
    launches of the two kernels at the new call sites."""
    import torch.distributed as dist

    from totalsegmentator2d_tpu_torch.parallel import init_distributed, make_mesh
    phase(f'parallel/: world-1 NCCL, then {RANKS} gloo ranks sharing the card')
    arr = np.load(os.path.join(PAR, 'arr.npy'))
    vols = np.load(os.path.join(PAR, 'vols.npy'), mmap_mode='r')
    refs = {}
    init_distributed(f'127.0.0.1:{free_port()}', 1, 0)
    try:
        mesh = make_mesh({'data': 1})
        for prec in ('exact', 'fast'):
            solo = flagship_set(db, prec == 'fast')
            refs[f'tile_{prec}'] = solo.predict_array(arr, SPACING_YX)
            if prec == 'exact':
                tiled = flagship_set(db, tile_mesh=mesh)
                tiled.predict_array(arr, SPACING_YX)
                seg, dt, _ = timed(lambda: tiled.predict_array(arr, SPACING_YX))
                agree = agreement(seg, refs['tile_exact'])
                print(f'(a) world-1 {dist.get_backend()} group, tile-sharded '
                      f'exact scan: {dt:.4f} s, agreement with solo '
                      f'{agree:.6f} [{smi}]')
                if agree < 0.9999:
                    raise SystemExit(f'world-1 tile-sharded scan {agree}')
                tiled.close()
            refs[f'cohort_{prec}'] = solo.predict_cohort(vols, SPACING_YX,
                                                         MODES)
            solo.close()
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    refs['train_data2'] = par_train(None, par_batch(PAR_BATCH))[0]
    # the model=2 and the fp32 height-sharded steps, batch 2, both held here
    refs['train_model2'] = refs['train_spatial2'] = par_train(
        None, par_batch(2))[0]
    # the bf16 augmented height-sharded step: every rank must draw the
    # global batch's augmentation as one rank does before taking its slab
    refs['train_spatial2_aug'] = par_train(
        None, par_batch(TRAIN_BATCH), compute_dtype='bfloat16',
        augment=True)[0]
    gc.collect()
    torch.cuda.empty_cache()

    probe = run_ranks('--nccl-probe', RANKS, 60)
    if all(rc == 0 for rc, _ in probe):
        print(f'(b) NCCL took {RANKS} ranks on one card')
    else:
        lines = [ln for _, text in probe for ln in text.splitlines()]
        why = ([ln for ln in lines if 'Duplicate GPU' in ln]
               or [ln for ln in lines if 'Error' in ln] or ['?'])
        print(f'(b) NCCL refused {RANKS} ranks on one card (return codes '
              f'{[rc for rc, _ in probe]}): {why[0].strip()[:300]}')

    t0 = time.perf_counter()
    ranks = run_ranks('--rank', RANKS, RANK_TIMEOUT)
    wall = time.perf_counter() - t0
    for r, (rc, text) in enumerate(ranks):
        if rc != 0:
            raise SystemExit(f'phase 11 rank {r} failed (rc {rc}):\n'
                             f'{text[-4000:]}')
    results, n_labels = [], refs['tile_exact'].shape[-1]
    for r in range(RANKS):
        with open(os.path.join(PAR, f'rank{r}.json')) as f:
            res = json.load(f)
        npz = np.load(os.path.join(PAR, f'rank{r}.npz'))
        res['arrays'] = {k: np.unpackbits(npz[k], -1)[..., :n_labels]
                         for k in npz.files}
        results.append(res)
    print(f'(c) {RANKS} gloo ranks on {results[0]["device"]!r}: '
          f'{wall:.1f} s with their start [{smi}]')
    bars = {'tile_exact': 0.9999, 'tile_fast': 0.999, 'cohort_exact': 0.9999,
            'cohort_fast': 0.999, 'dist': 0.9999}
    for r, res in enumerate(results):
        for name, bar in bars.items():
            ref = refs['cohort_exact' if name == 'dist' else name]
            got = res['arrays'][name]
            agree = agreement(got, ref) if got.shape == ref.shape else -1.0
            ran = res[name]['launches']
            print(f'rank {r} {name}: {res[name]["s"]:.4f} s, launches {ran}, '
                  f'agreement with one rank {agree:.6f} [{smi}]')
            if agree < bar:
                raise SystemExit(f'rank {r} {name}: agreement {agree} < {bar}')
            if ran['bspline_prefilter'] < 1 or (
                    ran['fused_norm_act_conv'] < 1) != ('fast' not in name):
                raise SystemExit(f'rank {r} {name}: launches {ran}')
        for name, rtol in (('train_data2', 1e-6), ('train_model2', 1e-6),
                           ('train_spatial2', 1e-6),
                           ('train_spatial2_aug', 1e-3)):
            got, want = res[name]['losses'], refs[name]
            rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
            print(f'rank {r} {name}: losses {got} against one rank {want}, '
                  f'max rel diff {rel:.3g}, last step {res[name]["s"]:.4f} s, '
                  f'peak {res[name]["peak_gib"]:.2f} GiB [{smi}]')
            if rel > rtol:
                raise SystemExit(f'rank {r} {name}: losses differ by {rel}')
        aug = res['train_spatial2_aug']
        ran, steps = aug['launches'], len(aug['losses'])
        aug['warp'] = (ran['bspline_prefilter'] - aug['lowres']) / steps
        print(f'rank {r} train_spatial2_aug (bf16, augment, batch '
              f'{TRAIN_BATCH}): launches {ran} over {steps} steps '
              f'(prefilter per step: warp stack {aug["warp"]:g}, low-res '
              f'levels {aug["lowres"] / steps:g}), peak '
              f'{aug["peak_gib"]:.2f} GiB [{smi}]')
        if aug['warp'] != 2 or ran['fused_norm_act_conv']:
            raise SystemExit(f'rank {r} train_spatial2_aug: launches {ran}')
        print(f'rank {r}: peak memory {res["peak_gib"]:.2f} GiB [{smi}]')
    return [{**{name: res[name]['launches'] for name in
                ('tile_fast', 'cohort_fast')},
             'spatial_warp': round(res['train_spatial2_aug']['warp'])}
            for res in results]


def parallel_inputs(scans):
    """Phase 11's inputs, written once: the seed-7 projection and the 8
    phantoms of phase 6 (RAI), which each rank maps."""
    os.makedirs(PAR, exist_ok=True)
    np.save(os.path.join(PAR, 'arr.npy'), projection(scans[0]))
    vols = np.lib.format.open_memmap(
        os.path.join(PAR, 'vols.npy'), 'w+', np.int16,
        (8,) + reorient(scans[0], 'RAI').array.shape)
    for i, sc in enumerate(scans[:8]):
        vols[i] = reorient(sc, 'RAI').array
    vols.flush()
    del vols


PHASES = frozenset(range(1, 12))


def main(phases=PHASES):
    """Every phase, or with ``--phases 2,11`` a subset (phase 1 always; each
    phase makes the inputs it needs: the database and the seed-7 phantom,
    phase 6's phantoms for phases 7 and 11). A subset's kernels line holds
    what its phases measured, and only the whole run requires every
    kernel's launches on every path."""
    shutil.rmtree(WORK, ignore_errors=True)
    smi, host_build_s = device_info()
    fused_per_scan = len(fused_launches(FLAGSHIP)) * len(GROUPS)
    prefilter = {'name': 'bspline_prefilter'}
    fused = {'name': 'fused_norm_act_conv'}
    if 2 in phases:
        prefilter, fused = check_prefilter(), check_fused_block()
    kernels = [prefilter, fused]
    sites = {}   # [(kernel key, counts by kernel name)] of the phases run

    db = os.path.join(WORK, 'db_flagship')
    if phases & {3, 6, 7, 8, 9, 11}:
        t0 = time.perf_counter()
        write_database(db, 'ts2d-v9-flagship', GROUPS, FLAGSHIP, seed=100)
        scan = torso_ct((400, 512, 512), (0.78, 0.78, 1.25), seed=7)
        print(f'database + phantom in {time.perf_counter() - t0:.1f} s')
    if 3 in phases:
        _, exact = main_path(db, scan, 'exact', fused_per_scan)
        sites['launches'], fast = main_path(db, scan, 'fast', fused_per_scan)
        print(f'mask agreement fast vs exact (flagship scan): '
              f'{float((fast == exact).mean()):.6f}')
    if 4 in phases:
        gpu_vs_cpu('exact', 0.999)
        gpu_vs_cpu('fast', 0.99)
    if 5 in phases:
        per_model_path()
    if phases & {6, 7, 11}:
        scans, arrs = serving_inputs(scan)
        if 6 in phases:
            sites['batch8'] = serving(db, scan, scans, arrs, fused_per_scan)
        if 7 in phases:
            sites['bucket'], sites['bucket_batch8'] = geometry_as_data(
                db, scans, arrs, fused_per_scan)
        if 11 in phases:
            parallel_inputs(scans)
        del scans, arrs
    if 8 in phases:
        prefilter.setdefault('visual', {})['launches'] = io_and_visuals(
            db, scan, host_build_s)['bspline_prefilter']
    if 9 in phases:
        dicom_phase(db, scan, fused_per_scan)
    if 10 in phases:
        for key, n in training(smi).items():   # per case, per training step
            prefilter.setdefault(key, {})['launches'] = n
    if 11 in phases:
        per_rank = parallel_phase(db, smi)
        # per rank of phase 11 (the fewest of the ranks)
        prefilter.setdefault('cohort_rank', {})['launches'] = min(
            r['cohort_fast']['bspline_prefilter'] for r in per_rank)
        # the height-sharded step's warp stack, per rank and step: the
        # shape of phase 10's (train_warp), timed there in phase 2
        prefilter.setdefault('train_warp', {})['spatial_rank_launches'] = \
            min(r['spatial_warp'] for r in per_rank)
        for key, call in (('tile_rank', 'tile_fast'),
                          ('cohort_rank', 'cohort_fast')):
            fused.setdefault(key, {})['launches'] = min(
                r[call]['fused_norm_act_conv'] for r in per_rank)
    for k in kernels:
        name = k['name']
        for key, counts in sites.items():
            if key == 'launches':
                k['launches'] = counts[name]
            else:
                k.setdefault(key, {})['launches'] = counts[name]
        if phases == PHASES and min(
                k['launches'], k['batch8']['launches'],
                k['bucket']['launches'],
                k['bucket_batch8']['launches']) < 1:
            raise SystemExit(f'{name} did not run on the main path, the '
                             f'batched serving path or the bucket paths')
    shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    if len(sys.argv) == 5 and sys.argv[1] in ('--rank', '--nccl-probe'):
        (rank_main if sys.argv[1] == '--rank' else nccl_probe_main)(
            *(int(a) for a in sys.argv[2:]))
    elif len(sys.argv) == 3 and sys.argv[1] == '--phases':
        main(frozenset(int(p) for p in sys.argv[2].split(',')) | {1})
    elif len(sys.argv) == 1:
        main()
    else:
        sys.exit('usage: python3 chip_smoke.py [--phases 1,2,11]')
