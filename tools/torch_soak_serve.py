"""Serving soak of the PyTorch port: randomized concurrent load against the
live HTTP server, with dispatcher crashes injected.

The port's counterpart of ``tools/soak_serve.py``. It serves
``TS2D(..., batching=True)`` (the micro-batcher coalesces concurrent
requests; a dispatcher that dies restarts on the next submit) behind
``serve.TS2DServer`` with a Bearer token, a per-request timeout and a body
ceiling, and fires the reference's mix from 4 client threads, each
sleeping U(0, 50 ms) between requests:

- 55% valid ``POST /predict`` of the payload NRRD;
- 20% corrupt payloads (its first 4 KiB with 1-8 bytes set): must answer 400;
- 5% oversized posts (the ceiling + 1 MiB): must answer 413;
- 5% ``/labels`` without the token or with a wrong one: must answer 401;
- 15% ``GET /health``, ``/metrics`` and ``/labels``.

With ``--chaos P`` the middle third of the run wraps
``DynamicBatcher._dispatch``: a seeded draw kills the dispatcher thread
with probability P per dispatch, its callers answered 500, never 3 times
in a row (the batcher gives up after 3 consecutive deaths, by design);
the last third must serve again. It passes when every request was
answered with an expected status, every 200 body equals the solo
reference bytes or has their size and agrees with the reference masks at
the batched bar (exact >= 0.999, fast >= 0.99), RSS grew by less than
1,500 MB, ``/metrics`` parses, ``stop()`` drains, and the dispatcher
crashes ``/metrics`` counts equal those injected; on a CUDA card also when
the allocated device memory after the drain is within 256 MiB of its value
after the warm-up, and when each kernel's launch counter equals its
launches per program times the programs ``/metrics`` counts (the warm-up
request's solo program among them): prefilter 2, fused block (one U-Net
forward batch per group and program) at 'fast' and 0 at 'exact'.

    python tools/torch_soak_serve.py [--minutes M] [--chaos P]
        [--device cuda|cpu] [--precision exact|fast] [--phantom cuda|cpu]

The device is the CUDA card unless ``--device cpu`` is named. The tool
writes its own model database of random weights from a seed and its own
torso phantom NRRD: on the card the flagship's full width (the 5-group /
117-label set, 6 stages, 256^2 patches, a 400 x 512 x 512 CT), on the CPU
a 2-group set of 4 stages at 64^2 and a 48 x 64 x 64 CT;
``--phantom cuda`` posts the card's CT from the CPU too (the host's
memory under 200 MiB bodies). It imports nothing of JAX or of the
reference package.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import random
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import InvalidStateError
from typing import Callable

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: the group architecture by device (2 blocks per stage, the PlainConvUNet
#: layout): full width on the card, small on the CPU
ARCHS = {
    'cpu': dict(n_stages=4, features=(8, 16, 32, 32), patch=(64, 64),
                  spacing=(1.5, 1.5), groups={'cardiac': 24, 'ribs': 24}),
    'cuda': dict(n_stages=6, features=(32, 64, 128, 256, 512, 512),
                     patch=(256, 256), spacing=(1.5, 1.5),
                     groups={'cardiac': 24, 'muscles': 21, 'organs': 22,
                             'ribs': 24, 'vertebrae': 26}),
}
#: the phantom by device: (z, y, x) voxels at (x, y, z) spacing
PHANTOMS = {'cpu': ((48, 64, 64), (1.6, 1.6, 2.5)),
            'cuda': ((400, 512, 512), (0.78, 0.78, 1.25))}
#: mask agreement of a batched response with the solo reference
#: (PERF.md section 2)
BATCHED_BAR = {'exact': 0.999, 'fast': 0.99}
RSS_GROWTH_MB = 1500
DEVICE_DRIFT_BYTES = 256 << 20
TOKEN = 'soak-token'


def rss_mb() -> float:
    with open('/proc/self/status') as f:
        for line in f:
            if line.startswith('VmRSS'):
                return int(line.split()[1]) / 1024
    return 0.0


# -- the database and the payload -----------------------------------------------

def write_database(root: str, model: str, arch: dict, seed: int,
                   precision: str) -> None:
    """nnU-Net results trees of random UNet weights (``seed`` + group
    index), one per group, written by the port."""
    import torch

    from totalsegmentator2d_tpu_torch.models.plans import parse_model_spec
    from totalsegmentator2d_tpu_torch.models.unet import UNet
    from totalsegmentator2d_tpu_torch.utils.config import get_label_colors
    names = iter(get_label_colors())
    n = arch['n_stages']
    for i, (group, n_labels) in enumerate(arch['groups'].items()):
        labels = [next(names) for _ in range(n_labels)]
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
                                         'predict': {'precision': precision}}}},
                      f)
        for fn, obj in (('plans.json', plans), ('dataset.json', dataset)):
            with open(os.path.join(data_dir, fn), 'w') as f:
                json.dump(obj, f)
        torch.manual_seed(seed + i)
        torch.save({'network_weights': UNet(parse_model_spec(
                        plans, dataset).arch).state_dict(),
                    'inference_allowed_mirroring_axes': [0, 1],
                    'trainer_name': 'nnUNetTrainer'},
                   os.path.join(data_dir, 'fold_0', 'checkpoint_final.pth'))


def torso_ct(shape_zyx, spacing_xyz, seed: int):
    """An int16 torso phantom: air, an elliptic body tapering along z, a
    spine column with vertebral banding, noise."""
    from totalsegmentator2d_tpu_torch.io import MedicalImage
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
    spine = ((((yy - y * 0.78) / (y * 0.07)) ** 2
              + ((xx - x * 0.5) / (x * 0.10)) ** 2) <= 1.0) & body
    vert = 650 + 350 * (np.sin(zc * (z - 1) / 3.4) > 0)
    vol = np.where(spine, vert + 40 * noise, vol)
    arr = np.clip(np.round(vol), -1024, 3071).astype(np.int16)
    return MedicalImage(array=arr, spacing=spacing_xyz)


def fused_per_forward(arch: dict, in_channels: int = 2) -> int:
    """The fused block's launches in one fast U-Net forward: a stack's first
    block runs through the kernel without normact when its stride is 1 and
    C >= 16, every later block with normact (``ConvStack._forward_fused``);
    each decoder stage has one stack of two blocks."""
    first = 1 if in_channels >= 16 else 0
    return first + arch['n_stages'] + 2 * (arch['n_stages'] - 1)


# -- chaos --------------------------------------------------------------------------

class ChaosCrash(BaseException):
    """Kills the dispatcher thread: the batcher re-raises what is not an
    Exception, counts the death and restarts on the next submit."""


class Chaos:
    """Wraps ``DynamicBatcher._dispatch`` while ``active`` is set: a seeded
    draw crashes a dispatch with probability ``rate``, never 3 in a row.
    Its callers get a RuntimeError (the server answers 500)."""

    def __init__(self, rate: float, seed: int = 1234):
        from totalsegmentator2d_tpu_torch.inference.batching import \
            DynamicBatcher
        self.rate, self.rng = rate, random.Random(seed)
        self.active = threading.Event()
        self.injected = self.streak = 0
        self.lock = threading.Lock()
        self.cls, self.real = DynamicBatcher, DynamicBatcher._dispatch
        self.hook = threading.excepthook
        chaos = self

        def dispatch(batcher, key, take):
            with chaos.lock:
                crash = (chaos.active.is_set() and chaos.streak < 2
                         and chaos.rng.random() < chaos.rate)
                chaos.streak = chaos.streak + 1 if crash else 0
                chaos.injected += crash
            if not crash:
                return chaos.real(batcher, key, take)
            for *_, fut in take:
                try:
                    fut.set_exception(RuntimeError(
                        'chaos: injected dispatcher crash'))
                except InvalidStateError:
                    pass   # a request that timed out and cancelled
            raise ChaosCrash()

        def hook(args):
            if not issubclass(args.exc_type, ChaosCrash):
                chaos.hook(args)

        DynamicBatcher._dispatch = dispatch
        threading.excepthook = hook

    def remove(self) -> None:
        self.cls._dispatch = self.real
        threading.excepthook = self.hook


# -- the soak -----------------------------------------------------------------------

def _agreement(body: bytes, ref: np.ndarray, tmp: str) -> float:
    from totalsegmentator2d_tpu_torch.io import read_image
    path = os.path.join(tmp, f'resp-{threading.get_ident()}.nrrd')
    with open(path, 'wb') as f:
        f.write(body)
    arr = read_image(path).array
    return float((arr == ref).mean()) if arr.shape == ref.shape else 0.0


def soak(db: str, key: str, payload_path: str, minutes: float, chaos: float,
         device: str, precision: str, fused_per_program: int,
         say: Callable[[str], None] = print) -> dict:
    """The soak of one server (see the module doc). Returns its figures and
    ``ok``; ``errors`` names what failed."""
    import torch

    from totalsegmentator2d_tpu_torch.api import TS2D
    from totalsegmentator2d_tpu_torch.io import read_image
    from totalsegmentator2d_tpu_torch.ops.cuda import fused_block as FB
    from totalsegmentator2d_tpu_torch.ops.cuda import prefilter as PF
    from totalsegmentator2d_tpu_torch.serve import TS2DServer
    from totalsegmentator2d_tpu_torch.utils.logging import is_silent, log_silent
    cuda = torch.device(device).type == 'cuda'
    with open(payload_path, 'rb') as f:
        payload = f.read()
    max_body = max(32 << 20, len(payload) + (1 << 20))
    oversized = b'x' * (max_body + (1 << 20))
    stats = collections.Counter()   # status counts by request kind
    extra = collections.Counter()   # 200s by third, non-bitwise 200s
    errors, latencies, agreements = [], [], []
    stop = threading.Event()
    third = [0]   # the third of the run (chaos in the middle one)
    injector = Chaos(chaos) if chaos > 0 else None
    # the server's request lines would bury the result: the soak's own
    # lines and the warnings (stderr) stay
    quiet = is_silent()
    log_silent(True)
    param = {'nnu.predict.precision': 'fast'} if precision == 'fast' else None
    try:
        with tempfile.TemporaryDirectory(prefix='ts2d-soak-') as tmp, \
                TS2D(key=key, use_remote=False, fetch_remote=False, local=db,
                     param=param, device=device, batching=True) as tool, \
                TS2DServer(tool, port=0, max_body_bytes=max_body,
                           auth_token=TOKEN, request_timeout=300.0) as srv:
            base = f'http://127.0.0.1:{srv.port}'
            auth = {'Authorization': f'Bearer {TOKEN}'}

            def call(path, data=None, headers=auth, timeout=600):
                req = urllib.request.Request(base + path, data=data,
                                             method='POST' if data is not None
                                             else 'GET', headers=headers or {})
                try:
                    with urllib.request.urlopen(req, timeout=timeout) as r:
                        return r.status, r.read()
                except urllib.error.HTTPError as ex:
                    return ex.code, ex.read()

            # the warm-up: the solo reference through the batcher's solo
            # program, its launches counted from here
            PF.bspline_prefilter_cuda.launches = 0
            FB.fused_norm_act_conv_cuda.launches = 0
            st, ref_body = call('/predict?format=nrrd', payload)
            if st != 200:
                raise RuntimeError(f'the warm-up predict answered {st}: '
                                   f'{ref_body[:300]!r}')
            ref_path = os.path.join(tmp, 'ref.nrrd')
            with open(ref_path, 'wb') as f:
                f.write(ref_body)
            ref = read_image(ref_path).array
            rss0 = rss_mb()
            if cuda:
                torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated() if cuda else None
            say(f'warm-up done ({len(payload) / 2**20:.1f} MiB payload, '
                f'{len(ref_body) / 2**20:.1f} MiB response); soaking '
                f'{minutes:g} min, chaos {chaos:g}')

            def client(cid):
                rng = random.Random(cid)
                while not stop.is_set():
                    roll = rng.random()
                    phase = third[0]
                    try:
                        if roll < 0.55:
                            before = injector.injected if injector else 0
                            t0 = time.perf_counter()
                            st, body = call('/predict?format=nrrd', payload)
                            dt = time.perf_counter() - t0
                            crashed = injector is not None and \
                                injector.injected != before
                            if st == 500 and crashed:
                                # it rode a dispatch that was killed
                                stats['predict:500-chaos'] += 1
                            else:
                                stats[f'predict:{st}'] += 1
                                if st != 200:
                                    errors.append(f'predict -> {st}: '
                                                  f'{body[:200]!r}')
                                else:
                                    extra[f'third{phase}'] += 1
                                    latencies.append(dt)
                                    if body != ref_body:
                                        extra['nonbitwise'] += 1
                                        if len(body) != len(ref_body):
                                            errors.append('response size '
                                                          'drift')
                                        else:
                                            agreements.append(_agreement(
                                                body, ref, tmp))
                        elif roll < 0.75:
                            data = bytearray(payload[:4096])
                            for _ in range(rng.randint(1, 8)):
                                data[rng.randrange(len(data))] = \
                                    rng.randrange(256)
                            st, _ = call('/predict?format=nrrd', bytes(data))
                            stats[f'corrupt:{st}'] += 1
                            if st != 400:
                                errors.append(f'corrupt payload -> {st}')
                        elif roll < 0.80:
                            st, _ = call('/predict?format=nrrd', oversized)
                            stats[f'oversized:{st}'] += 1
                            if st != 413:
                                errors.append(f'oversized -> {st}')
                        elif roll < 0.85:
                            bad = rng.choice(
                                [None, {'Authorization': 'Bearer wrong'}])
                            st, _ = call('/labels', headers=bad)
                            stats[f'unauthorized:{st}'] += 1
                            if st != 401:
                                errors.append(f'unauthorized -> {st}')
                        else:
                            path = rng.choice(['/health', '/metrics',
                                               '/labels'])
                            st, body = call(path)
                            stats[f'{path}:{st}'] += 1
                            if st != 200:
                                errors.append(f'{path} -> {st}')
                            elif path == '/metrics':
                                json.loads(body)
                    except Exception as ex:  # noqa: BLE001 - unanswered
                        errors.append(f'{type(ex).__name__}: {ex}')
                    time.sleep(rng.random() * 0.05)

            threads = [threading.Thread(target=client, args=(i,), daemon=True)
                       for i in range(4)]
            t_start = time.perf_counter()
            for t in threads:
                t.start()
            rss_by_third = []
            for k in range(3):
                # chaos in the middle third; the last third must recover
                third[0] = k
                if injector is not None and k == 1:
                    injector.active.set()
                    say('chaos on')
                elif injector is not None and k == 2:
                    injector.active.clear()
                    say('chaos off')
                time.sleep(minutes * 20)
                rss_by_third.append(round(rss_mb(), 1))
            stop.set()
            for t in threads:
                t.join(timeout=900)
            wall = time.perf_counter() - t_start
            if any(t.is_alive() for t in threads):
                errors.append('a client thread did not finish')
            st, body = call('/metrics')
            metrics = json.loads(body) if st == 200 else {}
            if st != 200:
                errors.append(f'/metrics -> {st}')
            rss1 = rss_mb()
            # the drain: stop() returns True once the predicts in flight
            # finished (the context manager's exit is then a no-op)
            if not srv.stop():
                errors.append('the shutdown drain timed out')
            launches = {'bspline_prefilter': PF.bspline_prefilter_cuda.launches,
                        'fused_norm_act_conv':
                            FB.fused_norm_act_conv_cuda.launches}
            if cuda:
                torch.cuda.synchronize()
            mem1 = torch.cuda.memory_allocated() if cuda else None
    finally:
        log_silent(quiet)
        if injector is not None:
            injector.remove()

    programs = metrics.get('batch_programs', 0)
    crashes = metrics.get('batch_dispatcher_crashes')
    injected = injector.injected if injector else 0
    per_program = {'bspline_prefilter': 2,
                   'fused_norm_act_conv':
                       fused_per_program if precision == 'fast' else 0}
    answered = sum(stats.values())
    result = {
        'statuses': {k: v for k, v in sorted(stats.items())},
        'requests': answered, 'seconds': round(wall, 3),
        'requests_per_s': answered / wall if wall else 0.0,
        'predict_200': len(latencies), 'predict_200_by_third': [
            extra[f'third{w}'] for w in range(3)],
        'nonbitwise_200': extra['nonbitwise'],
        'latency_p50_s': float(np.percentile(latencies, 50)) if latencies
        else None,
        'latency_p95_s': float(np.percentile(latencies, 95)) if latencies
        else None,
        'min_agreement': min(agreements) if agreements else None,
        'injected': injected, 'crashes_counted': crashes,
        'programs': programs,
        'occupancy': metrics.get('batch_occupancy'),
        'rss_mb': (round(rss0, 1), round(rss1, 1)),
        'rss_mb_by_third': rss_by_third,
        'device_bytes': (mem0, mem1), 'launches': launches,
        'launches_per_program': {k: v / programs if programs else None
                                 for k, v in launches.items()},
        'metrics': {k: v for k, v in metrics.items()
                    if isinstance(v, (int, float))}}
    bar = BATCHED_BAR[precision]
    if agreements and min(agreements) < bar:
        errors.append(f'a batched response agrees {min(agreements):.6f} < '
                      f'{bar} with the solo reference')
    if rss1 - rss0 >= RSS_GROWTH_MB:
        errors.append(f'RSS grew {rss1 - rss0:.0f} MB')
    if crashes != injected:
        errors.append(f'/metrics counts {crashes} dispatcher crashes, '
                      f'{injected} injected')
    if injector is not None and extra['third2'] == 0:
        errors.append('no predict succeeded after the chaos window')
    if not latencies:
        errors.append('no predict succeeded')
    if cuda:
        if abs(mem1 - mem0) > DEVICE_DRIFT_BYTES:
            errors.append(f'device memory {mem0} -> {mem1} bytes after the '
                          f'drain')
        want = {k: v * programs for k, v in per_program.items()}
        if launches != want:
            errors.append(f'kernel launches {launches}, expected {want} '
                          f'({per_program} per program x {programs} '
                          f'programs)')
    result['errors'] = errors
    result['ok'] = not errors
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--minutes', type=float, default=5.0)
    ap.add_argument('--chaos', type=float, default=0.0,
                    help='dispatcher crashes per dispatch in the middle '
                         'third of the run')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument('--precision', choices=('exact', 'fast'), default='exact')
    ap.add_argument('--phantom', choices=tuple(PHANTOMS),
                    help="the payload CT by device (default: --device's)")
    args = ap.parse_args(argv)
    import torch

    from totalsegmentator2d_tpu_torch.io import write_image
    kind = torch.device(args.device).type
    if kind == 'cuda' and not torch.cuda.is_available():
        raise SystemExit('no CUDA device: pass --device cpu to soak the CPU')
    if kind == 'cpu':
        # the server runs torch on several threads at once: a full set of
        # intra-op threads each oversubscribes the cores many times over
        torch.set_num_threads(min(2, torch.get_num_threads()))
    arch = ARCHS[kind]
    with tempfile.TemporaryDirectory(prefix='ts2d-soak-db-') as tmp:
        write_database(tmp, 'ts2d-v9-soak', arch, seed=100,
                       precision=args.precision)
        payload = os.path.join(tmp, 'phantom.nrrd')
        shape, spacing = PHANTOMS[args.phantom or kind]
        write_image(torso_ct(shape, spacing, seed=7), payload, compress=False)
        res = soak(tmp, 'ts2d-v9-soak', payload, args.minutes, args.chaos,
                   args.device, args.precision,
                   fused_per_forward(arch) * len(arch['groups']))
    print('status counts:', res['statuses'])
    print('metrics:', res['metrics'])
    print(f'{res["requests"]} requests in {res["seconds"]:.1f} s '
          f'({res["requests_per_s"]:.2f}/s); 200 latency p50 '
          f'{res["latency_p50_s"]} s, p95 {res["latency_p95_s"]} s; '
          f'crashes injected {res["injected"]}, counted '
          f'{res["crashes_counted"]}; RSS {res["rss_mb"][0]} -> '
          f'{res["rss_mb"][1]} MB (heap trims '
          f'{res["metrics"].get("heap_trims")}); device bytes '
          f'{res["device_bytes"]}; '
          f'launches {res["launches"]} over {res["programs"]} programs')
    for e in res['errors'][:10]:
        print('ERROR:', e)
    print('SOAK', 'PASS' if res['ok'] else 'FAIL')
    return 0 if res['ok'] else 1


if __name__ == '__main__':
    sys.exit(main())
