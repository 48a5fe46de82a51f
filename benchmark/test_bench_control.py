"""The control of each cell, the reference one precision below the
configuration's in the program's place, comes out not correct under the
cell's limits, on three seeds. The small architecture runs on two larger
projections here (~40,000 pixels each), so that a coarser rounding meets
as many voxels near the decision boundary as a cell's scans give it."""

import pytest

from benchmark import calibrate, check, database, harness, manifest
from totalsegmentator2d_tpu_torch.utils.config import get_label_colors

CELLS = ['ct-exact.solo', 'ct-fast.cohort8', 'ct-fast.cohort8-mixed']


VOLUMES = [[160, 64, 256], [200, 64, 240]]


@pytest.mark.parametrize('name', CELLS)
def test_control_is_not_correct(small_root, name):
    cell = manifest.cell(small_root, name)
    cell.traffic['volumes'] = VOLUMES
    device = harness.torch.device('cpu')
    db = database.ensure(small_root, cell.config_path, cell.config, device,
                         list(get_label_colors()))
    groups = database.load_nets(db, cell.config, device)
    quant = calibrate.CONTROL[cell.config['precision']]
    failed = 0
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        vols, _ = harness.images(cell, seed, device)
        sample = {v: None for v in range(len(vols))}
        got = check.compare(sample, vols, cell.traffic['spacing_xyz'],
                            cell.config, groups, quant=quant)
        checks = check.verdict(got, cell.limits, 0, len(vols))
        failed += not check.passes(checks)
    assert failed == 3
