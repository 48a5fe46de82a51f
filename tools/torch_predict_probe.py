"""``TS2D.predict`` blocking on the GPU, per checkout, each in a process of
its own:

    python tools/torch_predict_probe.py ROOT [ROOT ...]

Each ROOT is a checkout of the repository whose ``totalsegmentator2d_tpu_torch``
is measured: ``TS2D(...).predict(scan)`` of the flagship 5-group / 117-label
set (6-stage nnU-Net, features 32..512, patch 256^2, random weights from a
seed) on the 400x512x512 int16 torso phantom at 1.25 x 0.78 x 0.78 mm of
``chip_smoke.py`` (both projection axes resample), at precision 'exact'
and 'fast'. Per ROOT, precision and configuration one line: the median of
5 blocking predicts after 2 warm-up predicts, the runs beside it. The
configurations a checkout has: micro-batching on and off
(``TS2D(batching=...)``) times the compact mask wire on and off
(``TS2D_COMPACT``); a checkout without them has one. The database and the
phantom are written by each process from the same seeds. The first line is
the card's name and power limit. Give the parent and the change as
``parent change change parent`` to compare them inside one run on one card.
"""

import os
import subprocess
import sys

MEASURE = r'''
import inspect, json, os, sys, tempfile, time
import numpy as np
import torch
from totalsegmentator2d_tpu_torch.api import TS2D
from totalsegmentator2d_tpu_torch.io import MedicalImage
from totalsegmentator2d_tpu_torch.models.plans import parse_model_spec
from totalsegmentator2d_tpu_torch.models.unet import UNet

GROUPS = {'cardiac': 24, 'muscles': 21, 'organs': 22, 'ribs': 24,
          'vertebrae': 26}


def write_database(root):
    n = 6
    for i, (group, n_labels) in enumerate(GROUPS.items()):
        plans = {'configurations': {'2d': {
            'patch_size': [256, 256], 'spacing': [1.5, 1.5],
            'normalization_schemes': ['ZScoreNormalization'] * 2,
            'use_mask_for_norm': [False, False],
            'architecture': {'arch_kwargs': {
                'n_stages': n,
                'features_per_stage': [32, 64, 128, 256, 512, 512],
                'kernel_sizes': [[3, 3]] * n,
                'strides': [[1, 1]] + [[2, 2]] * (n - 1),
                'n_conv_per_stage': [2] * n,
                'n_conv_per_stage_decoder': [2] * (n - 1), 'conv_bias': True,
                'norm_op_kwargs': {'eps': 1e-05, 'affine': True},
                'nonlin_kwargs': {'inplace': True}}}}}}
        dataset = {'channel_names': {'0': 'max', '1': 'mean'},
                   'labels': {'background': 0,
                              **{f'{group}-{j}': j + 1
                                 for j in range(n_labels)}},
                   'file_ending': '.nrrd', 'multilabel': True}
        base = os.path.join(root, f'ts2d-v9-probe_{group}', 'r001')
        data = os.path.join(base, f'Dataset{200 + i}_{group}',
                            'nnUNetTrainer__nnUNetPlans__2d')
        os.makedirs(os.path.join(data, 'fold_0'))
        with open(os.path.join(base, 'model.json'), 'w') as f:
            json.dump({'param': {'nnu': {'configuration': '2d',
                                         'folds': [0]}}}, f)
        for fn, obj in (('plans.json', plans), ('dataset.json', dataset)):
            with open(os.path.join(data, fn), 'w') as f:
                json.dump(obj, f)
        torch.manual_seed(100 + i)
        spec = parse_model_spec(plans, dataset).arch
        torch.save({'network_weights': UNet(spec).state_dict(),
                    'inference_allowed_mirroring_axes': [0, 1],
                    'trainer_name': 'nnUNetTrainer'},
                   os.path.join(data, 'fold_0', 'checkpoint_final.pth'))


def torso_ct(shape_zyx, spacing_xyz, seed):
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
    vol = np.where(spine, 650 + 350 * (np.sin(zc * (z - 1) / 3.4) > 0)
                   + 40 * noise, vol)
    shell = (r2 >= 0.82) & body & (np.sin(zc * (z - 1) / 2.1) > 0.3)
    vol = np.where(shell, 420 + 60 * noise, vol)
    arr = np.clip(np.round(vol), -1024, 3071).astype(np.int16)
    return MedicalImage(array=arr, spacing=spacing_xyz)


db = tempfile.mkdtemp(dir=os.path.join(sys.argv[1], 'build'))
write_database(db)
scan = torso_ct((400, 512, 512), (0.78, 0.78, 1.25), 7)
serving = 'batching' in inspect.signature(TS2D.__init__).parameters
configs = ([(b, c) for b in (True, False) for c in ('1', '0')] if serving
           else [(None, None)])
for precision in ('exact', 'fast'):
    param = {'nnu.predict.precision': precision}
    for batching, compact in configs:
        kw = {} if batching is None else {'batching': batching}
        if compact is not None:
            os.environ['TS2D_COMPACT'] = compact
        with TS2D(key='ts2d-v9-probe', use_remote=False, local=db,
                  param=param, **kw) as tool:
            for _ in range(2):
                tool.predict(scan)
            runs = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tool.predict(scan)
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - t0)
        label = ('solo' if batching is None else
                 f'batching {"on" if batching else "off"}, compact wire '
                 f'{"on" if compact == "1" else "off"}')
        print(f'{sys.argv[1]} [{precision}, {label}]: blocking s/scan median '
              f'{np.median(runs):.4f} (runs {[round(r, 4) for r in runs]})',
              flush=True)
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
        os.makedirs(os.path.join(root, 'build'), exist_ok=True)
        env = dict(os.environ, PYTHONPATH=root)
        subprocess.run([sys.executable, '-c', MEASURE, root], env=env,
                       cwd=root, check=True)


if __name__ == '__main__':
    main(sys.argv[1:])
