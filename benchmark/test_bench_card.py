"""The harness on the card: one short run of a cell, its traced run, and
the reference's memory on a radiograph of a real detector's size. Skips
without a CUDA card (run on the chip: ``python -m pytest
benchmark/test_bench_card.py -q -s``)."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import check, database, phantom, reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.requires_cuda


@pytest.mark.parametrize('trace', [0, 1])
def test_a_cell_runs_on_the_card(cuda, trace):
    out = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload',
         'ct-fast.cohort8-mixed', '--seed', str(2 ** 31 + 99),
         '--seconds', '2', '--trace', str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line['correct'] and line['failed'] == 0, line['check']
    assert line['device']['platform'] == 'gpu'
    if trace:
        assert 0 < line['device']['busy_s'] < line['device']['window_s']
        assert 0 < line['metrics']['fused_block_roofline']['value'] <= 100
    else:
        assert line['metrics']['scans_per_s']['value'] > 0


def test_reference_of_a_radiograph_fits_in_16_gb(cuda):
    """check.compare of one 2544 x 3056 chest radiograph at 0.148 mm and 117
    labels (the ts2d-v2 groups and widths over one channel), the
    reference's own decisions in the program's place: one group's logits
    at a time keep the card's peak under 16 GB."""
    with open(os.path.join(ROOT, 'benchmark', 'configs',
                           'ts2d-v2-exact.json')) as f:
        cfg = json.load(f)
    cfg['channels'] = ['xray']
    gen = torch.Generator(device=cuda).manual_seed(cfg['weight_seed'])
    groups = []
    for group in cfg['groups']:
        net = reference.RefUNet(database.arch(cfg, group))
        net.load_state_dict(reference.init_state(
            database.arch(cfg, group), gen, cfg['head_bias_shift'], cuda))
        groups.append([net.to(cuda).eval()])
    spacing = [0.148, 0.148]
    image = phantom.volumes([[2544, 3056]], 2 ** 31 + 7, cuda)[0]
    arr, spacing_yx = reference.model_input(image, spacing)
    kw = dict(patch=tuple(cfg['patch_size']),
              plan_spacing=tuple(cfg['spacing']),
              step=cfg['tile_step_size'], mirror_axes=tuple(cfg['mirror_axes']))
    mask = np.concatenate([
        (lg > 0).to(torch.uint8).cpu().numpy() for lg in
        reference.group_logits(arr, spacing_yx, groups, **kw)], axis=-1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = check.compare({0: mask}, [image], spacing, cfg, groups)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(json.dumps({'reference_s': seconds, 'memory_peak_bytes': peak,
                      'kind': torch.cuda.get_device_name(0), **got}))
    assert got['scans_compared'] == 1 and got['worst_flip_logit'] < 1e-3
    assert peak < 16e9
