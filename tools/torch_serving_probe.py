"""The fused ensemble's host API on the GPU, per checkout, each in a process
of its own:

    python tools/torch_serving_probe.py ROOT [ROOT ...]

Each ROOT is a checkout of the repository whose ``totalsegmentator2d_tpu_torch``
is measured: the flagship 5-group fast (bf16) ensemble (6-stage nnU-Net,
features 32..512, 117 labels) with random weights from a seed, on one
synthetic (400, 512, 2) projection at 1.25 x 0.78 mm (an integral MIP-like
channel and a fractional mean-like one, so the int16 wire applies). Per
ROOT and configuration one line: the median wall time of
``predict_array`` over 10 calls after 3 warm-up calls, and for the
checkouts that have it, the split of a call into ``predict_array_async``
(crop, wire, dispatch) and ``finish_array`` (wait, download, unpack). The
configurations a checkout has: the solo program on the calling thread with
the plain mask wire, with the compact wire and 1 or 4 download streams,
and through the micro-batcher (``auto_batch=8``, a lone request's solo
dispatch); then 8 requests in one batched program, split into its phases
(submit, dispatch, fetch, finish), with the compact and the plain mask
wire. The first line is the card's name and power limit. Give the parent and the change as ``parent change change
parent`` to compare them inside one run on one card.
"""

import os
import subprocess
import sys

MEASURE = r'''
import sys, time
import numpy as np
import torch
from totalsegmentator2d_tpu_torch.inference import EnsembleEngine
from totalsegmentator2d_tpu_torch.models.plans import parse_model_spec
from totalsegmentator2d_tpu_torch.models.unet import UNet

n = 6
specs, params = [], []
for i, n_labels in enumerate((24, 21, 22, 24, 26)):
    plans = {'configurations': {'2d': {
        'patch_size': [256, 256], 'spacing': [1.5, 1.5],
        'normalization_schemes': ['ZScoreNormalization'] * 2,
        'use_mask_for_norm': [False, False],
        'architecture': {'arch_kwargs': {
            'n_stages': n, 'features_per_stage': [32, 64, 128, 256, 512, 512],
            'kernel_sizes': [[3, 3]] * n,
            'strides': [[1, 1]] + [[2, 2]] * (n - 1),
            'n_conv_per_stage': [2] * n,
            'n_conv_per_stage_decoder': [2] * (n - 1), 'conv_bias': True,
            'norm_op_kwargs': {'eps': 1e-05, 'affine': True},
            'nonlin_kwargs': {'inplace': True}}}}}}
    dataset = {'channel_names': {'0': 'max', '1': 'mean'},
               'labels': {'background': 0,
                          **{f'g{i}-{j}': j + 1 for j in range(n_labels)}},
               'multilabel': True}
    spec = parse_model_spec(plans, dataset)
    torch.manual_seed(100 + i)
    specs.append(spec)
    params.append([UNet(spec.arch).state_dict()])
rng = np.random.default_rng(0)
arr = np.stack([np.round(rng.standard_normal((400, 512)) * 300),
                rng.standard_normal((400, 512)) * 100], -1).astype(np.float32)
spacing = (1.25, 0.78)
serving = hasattr(EnsembleEngine, 'predict_array_async')


def set_streams(streams):
    """The download streams of fetch_split's default and the fetch-once
    result's (inference/wire.py; a checkout without it keeps them in
    ensemble_engine.py and batching.py)."""
    try:
        from totalsegmentator2d_tpu_torch.inference.wire import (
            DeviceResult as result, fetch_split)
    except ImportError:
        from totalsegmentator2d_tpu_torch.inference.batching import (
            _BatchResult as result)
        from totalsegmentator2d_tpu_torch.inference.ensemble_engine import (
            fetch_split)
    defaults = list(fetch_split.__defaults__)
    defaults[1] = streams
    fetch_split.__defaults__ = tuple(defaults)
    result._SPLIT_STREAMS = streams


def measure(label, engine, streams=None):
    if streams is not None:
        set_streams(streams)
    for _ in range(3):
        out = engine.predict_array(arr, spacing)
    torch.cuda.synchronize()
    walls, halves = [], []
    for _ in range(10):
        t0 = time.perf_counter()
        if serving:
            h = engine.predict_array_async(arr, spacing)
            t1 = time.perf_counter()
            engine.finish_array(h)
            halves.append((t1 - t0, time.perf_counter() - t1))
        else:
            engine.predict_array(arr, spacing)
        walls.append(time.perf_counter() - t0)
    line = (f'{sys.argv[1]} [{label}]: predict_array median '
            f'{np.median(walls) * 1e3:.2f} ms (runs '
            f'{[round(w * 1e3, 1) for w in walls]})')
    if halves:
        line += (f'; async {np.median([a for a, _ in halves]) * 1e3:.2f} ms, '
                 f'finish {np.median([b for _, b in halves]) * 1e3:.2f} ms')
    print(line + f'; foreground {out.mean():.3f}', flush=True)


def measure_batch(label, engine):
    """8 requests in one batched program (a long linger): the phases of a
    batch, medians over 5 batches after one warm-up, one download stream."""
    set_streams(1)
    engine.set_batch_linger(600_000.0)
    arrs = [arr + i for i in range(8)]
    phases = []
    for rep in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handles = [engine.predict_array_async(a, spacing) for a in arrs]
        t1 = time.perf_counter()
        # the batcher's future (a tuple ('future', future) before wire.py)
        first = handles[0][1] if isinstance(handles[0], tuple) else handles[0]
        br = first.result()[0]
        t2 = time.perf_counter()
        br.get()
        t3 = time.perf_counter()
        for h in handles:
            engine.finish_array(h)
        t4 = time.perf_counter()
        if rep:
            phases.append((t1 - t0, t2 - t1, t3 - t2, t4 - t3, t4 - t0))
    med = [np.median([p[i] for p in phases]) * 1e3 for i in range(5)]
    print(f'{sys.argv[1]} [{label}]: 8-scan batch {med[4]:.1f} ms = submit '
          f'{med[0]:.1f} (crop, wire, queue) + dispatch {med[1]:.1f} (stack, '
          f'pack, upload, launches) + fetch {med[2]:.1f} (wait, download, '
          f'rebuild) + finish {med[3]:.1f} (unpack, place) ms',
          flush=True)


kw = dict(compute_dtype=torch.bfloat16, device='cuda')
if not serving:
    measure('solo', EnsembleEngine(specs, params, **kw))
else:
    configs = [('solo, plain wire', dict(compact_wire=False), None),
               ('solo, compact wire, 1 stream', {}, 1),
               ('solo, compact wire, 4 streams', {}, 4),
               ('batcher, compact wire, 1 stream', dict(auto_batch=8), 1),
               ('batcher, compact wire, 4 streams', dict(auto_batch=8), 4)]
    for label, extra, streams in configs:
        engine = EnsembleEngine(specs, params, **kw, **extra)
        measure(label, engine, streams)
        engine.close()
    for label, extra in (('batch, compact wire', {}),
                         ('batch, plain wire', dict(compact_wire=False))):
        engine = EnsembleEngine(specs, params, **kw, auto_batch=8, **extra)
        measure_batch(label, engine)
        engine.close()
'''


def main(roots):
    if not roots:
        raise SystemExit(__doc__)
    print('card: ' + subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for root in roots:
        root = os.path.abspath(root)
        env = dict(os.environ, PYTHONPATH=root)
        subprocess.run([sys.executable, '-c', MEASURE, root], env=env,
                       cwd=root, check=True)


if __name__ == '__main__':
    main(sys.argv[1:])
