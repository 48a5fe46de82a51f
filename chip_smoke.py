"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; the result lines print only at the end):

1. Device info: the card (nvidia-smi), CUDA, nvcc; builds every kernel from
   the sources in the checkout.
2. Every kernel against its plain PyTorch version (and scipy) on the card,
   at the shapes the main path gives it and at edge shapes; kernel, plain
   and library-yardstick times with CUDA events.
3. The main path at full width: ``TS2D(...).predict(scan)`` with a random
   5-group / 117-label flagship ensemble (6-stage nnU-Net, features
   32..512, patch 256^2) on a clinical-spacing torso phantom CT
   (400x512x512 at 1.25x0.78x0.78 mm, so both projection axes resample),
   with the kernels' launch counts read around one scan; then
   ``Result.save`` read back; then the blocking seconds per scan and a
   breakdown of one scan (host, engine, U-Net forwards, a profiler trace).
4. The port on the GPU against the port on the CPU (plain kernel versions)
   at a reduced architecture: mask agreement >= 0.999.
5. One JSON line with every kernel, then the device line.

Needs nothing but the repository, PyTorch with CUDA, numpy, scipy and the
CUDA toolkit; imports nothing of the JAX package.
"""

import sys

import torch

if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device available', file=sys.stderr)
    sys.exit(1)

import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import scipy.ndimage as ndi  # noqa: E402

from totalsegmentator2d_tpu_torch.api import TS2D  # noqa: E402
from totalsegmentator2d_tpu_torch.io import MedicalImage, read_image  # noqa: E402
from totalsegmentator2d_tpu_torch.models.unet import UNet  # noqa: E402
from totalsegmentator2d_tpu_torch.models.plans import parse_model_spec  # noqa: E402
from totalsegmentator2d_tpu_torch.ops.cuda import build  # noqa: E402
from totalsegmentator2d_tpu_torch.ops.cuda import prefilter as PF  # noqa: E402
from totalsegmentator2d_tpu_torch.ops.geometry import reorient  # noqa: E402
from totalsegmentator2d_tpu_torch.ops.projection import project_multi  # noqa: E402
from totalsegmentator2d_tpu_torch.utils.config import get_label_colors  # noqa: E402
from totalsegmentator2d_tpu_torch.utils.device import exact_numerics  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, 'build', 'chip_smoke')   # ignored by git

# published H100 SXM peaks (NVIDIA data sheet): HBM and fp32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

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

def check_prefilter():
    phase('kernel: bspline_prefilter')
    gen = torch.Generator().manual_seed(0)
    worst = 0.0

    def compare(x, axis):
        nonlocal worst
        y = PF.bspline_prefilter_cuda(x, axis)
        torch.cuda.synchronize()
        plain = PF.bspline_prefilter_plain(x, axis)
        torch.testing.assert_close(y, plain, rtol=1e-5, atol=1e-6)
        ref = ndi.spline_filter1d(x.double().cpu().numpy(), order=3, axis=axis,
                                  mode='mirror')
        np.testing.assert_allclose(y.cpu().numpy(), ref, rtol=1e-4, atol=1e-5)
        worst = max(worst, float((y - plain).abs().max()))
        return y

    # the main path: the (H, W, C=2) projection along axis 0, then axis 1
    x = torch.randn((400, 512, 2), generator=gen).cuda()
    y0 = compare(x, 0)
    compare(y0, 1)
    # edge shapes: n = 2, 3, 4; a line count that is not a multiple of 32;
    # a 3-D array along each axis
    for shape, axis in (((2, 77), 0), ((3, 41), 0), ((4, 45), 0),
                        ((13, 1001), 0), ((37, 19), 1), ((9, 10, 11), 0),
                        ((9, 10, 11), 1), ((9, 10, 11), 2)):
        compare(torch.randn(shape, generator=gen).cuda(), axis)
    print(f'max |kernel - plain| = {worst:.3g}')

    # times at the main-path shapes: one scan's pair of launches
    def kernel():
        return PF.bspline_prefilter_cuda(PF.bspline_prefilter_cuda(x, 0), 1)

    def plain():
        return PF.bspline_prefilter_plain(PF.bspline_prefilter_plain(x, 0), 1)

    # library yardstick: the dense n x n prefilter matrix (the filter of the
    # identity) applied by one batched matmul per axis, fp32 without TF32
    mats = [PF.bspline_prefilter_plain(torch.eye(n, device='cuda'), 0)
            for n in (400, 512)]

    def library():
        a = torch.matmul(mats[0], x.view(1, 400, 1024))
        return torch.matmul(mats[1], a.view(400, 512, 2))

    with exact_numerics():
        torch.testing.assert_close(library(), kernel(), rtol=1e-4, atol=1e-5)
        ms = cuda_ms(kernel, 200)
        plain_ms = cuda_ms(plain, 5)
        library_ms = cuda_ms(library, 200)

    bound = 0.0
    for n, lines in ((400, 1024), (512, 800)):
        nbytes = 2 * n * lines * 4
        flops = lines * (5 * n + 2 * PF.HORIZON)
        bound += max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3
    print(f'prefilter (400,512,2) axis 0 + axis 1: kernel {ms:.4f} ms, '
          f'plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, '
          f'bound {bound:.5f} ms (bytes)')
    return {'name': 'bspline_prefilter', 'route': 'cuda',
            'source': 'totalsegmentator2d_tpu_torch/csrc/prefilter.cu',
            'replaces': 'totalsegmentator2d_tpu/ops/pallas/prefilter.py:36',
            'max_abs_err': worst, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound, 'bound_by': 'bytes', 'library_ms': library_ms}


# -- the synthetic model database -------------------------------------------

def write_database(root, model, groups, arch, seed):
    """nnU-Net results trees with random UNet weights, written by the port."""
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
            json.dump({'param': {'nnu': {'configuration': '2d', 'folds': [0],
                                         'predict': {'precision': 'exact'}}}},
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


# -- 3. the main path at full width -------------------------------------------

def main_path():
    phase('main path: TS2D.predict, 5 groups / 117 labels, flagship arch')
    db = os.path.join(WORK, 'db_flagship')
    t0 = time.perf_counter()
    write_database(db, 'ts2d-v9-flagship', GROUPS, FLAGSHIP, seed=100)
    scan = torso_ct((400, 512, 512), (0.78, 0.78, 1.25), seed=7)
    print(f'database + phantom in {time.perf_counter() - t0:.1f} s')

    with TS2D(key='ts2d-v9-flagship', use_remote=False, local=db) as tool:
        PF.bspline_prefilter_cuda.launches = 0
        res = tool.predict(scan)
        torch.cuda.synchronize()
        launches = {'bspline_prefilter': PF.bspline_prefilter_cuda.launches}
        print(f'launches on one scan: {launches}')
        if launches['bspline_prefilter'] != 2:
            raise SystemExit('the prefilter kernel did not run twice per scan')

        seg = res.get_segmentation()
        if seg.ncomponents != 117 or seg.array.shape != (400, 1, 512, 117):
            raise SystemExit(f'unexpected segmentation {seg.array.shape}')
        if not 0 < seg.array.mean() < 1:
            raise SystemExit('segmentation is empty or full')
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

        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(5):
            before = PF.bspline_prefilter_cuda.launches
            t0 = time.perf_counter()
            tool.predict(scan)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if PF.bspline_prefilter_cuda.launches - before != 2:
                raise SystemExit('the prefilter kernel did not run twice per scan')
        print(f'blocking s/scan: median {float(np.median(times)):.4f} '
              f'(runs {[round(t, 4) for t in times]}); peak device memory '
              f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
        breakdown(tool, scan)
    return launches


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


def breakdown(tool, scan):
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
        fwd_ms = cuda_ms(lambda: engine._net(batch), 3)
    flops = len(GROUPS) * 16 * conv_flops(FLAGSHIP, *FLAGSHIP['patch'])
    print(f'breakdown: host projection {host_s:.4f} s; engine.predict_array '
          f'{engine_s:.4f} s, of which U-Net forwards {fwd_ms / 1e3:.4f} s '
          f'({flops / 1e12:.3f} TFLOP, {flops / fwd_ms / 1e9:.1f} TFLOP/s '
          f'fp32; bound {flops / FP32_FLOP_PER_S * 1e3:.2f} ms at 67 TFLOP/s)')

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
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f'  {ms:9.2f} ms  {name}')


# -- 4. the port on the GPU against the port on the CPU ---------------------

def gpu_vs_cpu():
    phase('GPU vs CPU, reduced architecture')
    db = os.path.join(WORK, 'db_small')
    write_database(db, 'ts2d-v9-small', {'cardiac': 3, 'ribs': 4}, SMALL,
                   seed=200)
    scan = torso_ct((150, 96, 110), (0.9, 0.9, 2.0), seed=11)
    segs = {}
    for device in ('cuda', 'cpu'):
        before = PF.bspline_prefilter_cuda.launches
        with TS2D(key='ts2d-v9-small', use_remote=False, local=db,
                  device=device) as tool:
            segs[device] = tool.predict(scan).get_segmentation().array
        ran = PF.bspline_prefilter_cuda.launches - before
        if ran != (2 if device == 'cuda' else 0):
            raise SystemExit(f'{device}: {ran} prefilter kernel launches')
    agree = float((segs['cuda'] == segs['cpu']).mean())
    print(f'mask agreement GPU vs CPU: {agree:.6f} '
          f'(foreground {segs["cuda"].mean():.3f})')
    if agree < 0.999:
        raise SystemExit(f'GPU/CPU mask agreement {agree} < 0.999')


def main():
    shutil.rmtree(WORK, ignore_errors=True)
    smi = device_info()
    kernels = [check_prefilter()]
    launches = main_path()
    gpu_vs_cpu()
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
