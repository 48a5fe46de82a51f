"""Readings that the limits of ``benchmark/workloads/<cell>.json`` are set
from, in one process (set-up is paid once):

    python3 -m benchmark.calibrate --workload <cell> --seeds <n> --first-seed <s>
        [--seconds 4] [--controls 3]

For each of ``n`` seeds from ``s`` on: the cell's volumes from the seed, a
short window of the cell's own traffic, and the comparison of its sampled
results with the reference (the program's readings, the lower end of each
limit). For the first ``--controls`` seeds, the control: the reference
one precision below the configuration's (TF32 for 'exact', float8 e4m3 for
'fast') in the program's place (the upper end). One JSON line each on
stdout. The benchmark's runs do not run this.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from . import check, database, harness, manifest, traffic

CONTROL = {'exact': 'tf32', 'fast': 'fp8'}


def main(argv, root: str, device=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, default=12)
    p.add_argument('--first-seed', type=int, required=True)
    p.add_argument('--seconds', type=float, default=4.0)
    p.add_argument('--controls', type=int, default=3)
    args = p.parse_args(argv)
    cell = manifest.cell(root, args.workload)
    if device is None and not torch.cuda.is_available():
        return harness.fail('no CUDA device')
    device = torch.device(device or 'cuda')
    tool, db = harness.open_tool(cell, root, device)
    groups = database.load_nets(db, cell.config, device)
    sp = manifest.spacing(cell.traffic)
    quant = CONTROL[cell.config['precision']]
    try:
        for k in range(args.seeds):
            seed = args.first_seed + k
            t0 = time.perf_counter()
            vols, imgs = harness.images(cell, seed, device)
            if k == 0:
                harness.warm_up(tool, imgs, cell.traffic)
            sample = traffic.Sample(seed)
            loop = traffic.ClosedLoop(
                tool, imgs, seed, cell.traffic['in_flight'],
                cell.traffic['entry'] == 'async', on_result=sample.offer)
            loop.window(args.seconds)
            t1 = time.perf_counter()
            got = check.compare(sample.kept, vols, sp, cell.config, groups)
            line = {'seed': seed, 'side': 'program', 'failed': loop.failed,
                    'scans': loop.finished(), **got,
                    'window_s': t1 - t0,
                    'reference_s': time.perf_counter() - t1}
            print(json.dumps(line), flush=True)
            if k < args.controls:
                got = check.compare(sample.kept, vols, sp, cell.config,
                                    groups, quant=quant)
                print(json.dumps({'seed': seed, 'side': f'control-{quant}',
                                  **got}), flush=True)
    finally:
        tool.close()
    return 0


if __name__ == '__main__':
    import os
    sys.exit(main(sys.argv[1:], os.getcwd()))
