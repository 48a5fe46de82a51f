"""One run of one cell: set-up, the measured window, the traced slice, the
comparison with the reference, and the result's line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read by ``benchmark/metrics/<name>.py``
from the window's spans and counters and from a profiled slice of scans
after it. Every run ends by comparing a seeded sample of the window's
results with the plain reference (check.py), and prints each number
compared beside its limit, last on stderr and last in the line.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from . import (check, database, manifest, phantom, profiling, reference,
               traffic)

# top-level module names the process may not hold once the window closes:
# the JAX stack and the JAX package the port was made from
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'totalsegmentator2d_tpu')
PORT = 'totalsegmentator2d_tpu_torch'
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class Run:
    """What a per-layer metric's reader reads."""
    cell: manifest.Cell
    extents: List[Tuple[int, int]]       # each image's model input, cropped
    tiles: List[int]                     # tiles of each image's scan
    window_s: float = 0.0
    scans: int = 0
    dispatch_s: List[float] = field(default_factory=list)
    occupancy: List[int] = field(default_factory=list)   # programs by size
    slice: Optional[profiling.Slice] = None


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (the port's own name begins with the JAX package's)."""
    return sorted(m for m in list(sys.modules)
                  if m.split('.', 1)[0] in FORBIDDEN)


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str) -> int:
    print(f'benchmark: {msg}', file=sys.stderr, flush=True)
    return 1


def images(cell: manifest.Cell, seed: int, device) -> tuple:
    """The mix's images from the seed, CT volumes or native 2D radiographs:
    (host int16 arrays, MedicalImages)."""
    from totalsegmentator2d_tpu_torch.io import MedicalImage
    vols = phantom.volumes(cell.traffic['volumes'], seed, device)
    sp = tuple(manifest.spacing(cell.traffic))
    return vols, [MedicalImage(array=v, spacing=sp) for v in vols]


def warm_up(tool, imgs: list, traffic_: dict) -> None:
    """Each shape of the mix once at its load: a lone predict, or as many
    scans of it as the mix keeps in flight sent at once (the batcher runs
    its solo and its batched program on them)."""
    first: Dict[tuple, int] = {}
    for i, img in enumerate(imgs):
        first.setdefault(img.array.shape, i)
    for i in first.values():
        if traffic_['entry'] == 'predict':
            tool.predict(imgs[i])
            continue
        handles = [tool.predict_async(imgs[i])
                   for _ in range(traffic_['in_flight'])]
        for h in handles:
            tool.finish_predict(h)


def device_info(device) -> dict:
    if device.type != 'cuda':
        return {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
                'memory_peak_bytes': 0}
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': 1,
            'memory_peak_bytes': int(torch.cuda.max_memory_allocated())}


def open_tool(cell: manifest.Cell, root: str, device) -> tuple:
    """Build the port's kernels (on the card), write or find the cell's
    model database, and open ``TS2D`` on it: (tool, database root). Raises
    ImportError when the port is not the checkout's own."""
    import totalsegmentator2d_tpu_torch as port
    if not os.path.abspath(port.__file__).startswith(
            os.path.join(CHECKOUT, PORT) + os.sep):
        raise ImportError(f'{PORT} was not found in the checkout at '
                          f'{CHECKOUT}')
    from totalsegmentator2d_tpu_torch import TS2D
    from totalsegmentator2d_tpu_torch.utils.config import get_label_colors
    if device.type == 'cuda':
        from totalsegmentator2d_tpu_torch.ops.cuda import build
        build.build()
        build.build_host('ts2dio')
    db = database.ensure(root, cell.config_path, cell.config, device,
                         list(get_label_colors()))
    tool = TS2D(key=cell.config['model_key'], use_remote=False,
                fetch_remote=False, local=db,
                device=None if device.type == 'cuda' else 'cpu')
    return tool, db


def main(argv, t0: float, root: str, device=None) -> int:
    """One run; returns the exit code. ``root`` holds BENCHMARK.json and
    the benchmark's files (and its build directory); ``device``: the card
    (None) or, in tests only, 'cpu'."""
    args = parse(argv)
    try:
        cell = manifest.cell(root, args.workload)
    except (KeyError, OSError, ValueError) as ex:
        return fail(f'cannot resolve the workload: {ex}')
    if device is None:
        if not torch.cuda.is_available():
            return fail('no CUDA device: the benchmark runs on the card only')
        if torch.cuda.device_count() < cell.chips:
            return fail(f'{cell.name} needs {cell.chips} cards, '
                        f'{torch.cuda.device_count()} found')
    device = torch.device(device or 'cuda')

    marks = [('start', traffic.now())]
    try:
        tool, db = open_tool(cell, root, device)
    except ImportError as ex:
        return fail(str(ex))
    marks.append(('open', traffic.now()))
    config, traffic_ = cell.config, cell.traffic
    vols, imgs = images(cell, args.seed, device)
    marks.append(('volumes', traffic.now()))
    warm_up(tool, imgs, traffic_)
    sync(device)
    marks.append(('warm_up', traffic.now()))
    print('benchmark: set-up s ' + ', '.join(
        f'{name} {t - t0:.3f}' for name, t in marks), file=sys.stderr)

    sample = traffic.Sample(args.seed)
    split = bool(args.trace) or traffic_['entry'] == 'async'
    loop = traffic.ClosedLoop(tool, imgs, args.seed, traffic_['in_flight'],
                              split, on_result=sample.offer,
                              annotate=bool(args.trace))
    batcher = getattr(tool._fused, '_batcher', None)
    before = batcher.stats()['batch_occupancy'] if batcher else []
    setup_s = traffic.now() - t0
    window_s = loop.window(args.seconds, drain=not args.trace)
    extents_ = [extent(img.array) for img in imgs]
    run = Run(cell=cell, extents=extents_,
              tiles=[tiles(cell, e) for e in extents_],
              window_s=window_s, scans=loop.finished(),
              dispatch_s=list(loop.dispatch_s))
    if batcher:
        run.occupancy = [a - b for a, b in zip(
            batcher.stats()['batch_occupancy'], before)]
    scans, latency, failed = loop.finished(), list(loop.latency), loop.failed
    if args.trace:
        done = len(loop.volumes)
        with profiling.profiled() as got:
            loop.finish_count(traffic_['traced_scans'])
            sync(device)
        run.slice = got[0]
        run.slice.scans = loop.volumes[done:]
        loop.drain()
        failed = loop.failed
    info = device_info(device)
    for err in loop.errors:
        print(f'benchmark: a scan failed: {err}', file=sys.stderr)
    tool.close()
    del tool, loop
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    groups = database.load_nets(db, config, device)
    numbers = check.compare(sample.kept, vols, manifest.spacing(traffic_),
                            config, groups)
    checks = check.verdict(numbers, cell.limits, failed, len(imgs))
    correct = check.passes(checks)

    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = manifest.reader(root, m['name'])(run)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
        info['busy_s'] = run.slice.busy_s
        info['window_s'] = run.slice.window_s
    else:
        metrics = end_to_end(cell, setup_s, window_s, scans, latency)
    line = {'correct': correct, 'attempted': scans, 'failed': failed,
            'metrics': metrics, 'device': info}
    if args.trace:
        line['breakdown'] = run.slice.breakdown()
    line['reference_foreground'] = numbers['reference_foreground']
    line['check'] = checks
    found = forbidden_modules()
    if found:
        return fail(f'the process holds modules it may not load: {found}')
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def sync(device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize()


def extent(image) -> Tuple[int, int]:
    """(rows, cols) of the model input of one image, cropped to non-zero as
    the program crops it: a CT volume's coronal projection (z, x), whole,
    since air projects to -1024; a radiograph inside its collimation
    border."""
    if image.ndim == 3:
        return image.shape[0], image.shape[2]
    (y0, y1), (x0, x1) = reference.nonzero_bbox(image[..., None])
    return y1 - y0, x1 - x0


def tiles(cell: manifest.Cell, extent_hw: Tuple[int, int]) -> int:
    """Sliding-window tiles of one scan whose model input keeps
    ``extent_hw`` after the crop."""
    c = cell.config
    return reference.tile_count(
        extent_hw, reference.spacing_yx(manifest.spacing(cell.traffic)),
        tuple(c['patch_size']), tuple(c['spacing']), c['tile_step_size'])


def end_to_end(cell: manifest.Cell, setup_s: float, window_s: float,
               scans: int, latency: List[float]) -> dict:
    from . import arith
    values = {'setup_s': setup_s,
              'scans_per_s': arith.rate(scans, window_s)}
    if latency:
        values['scan_p50_s'] = arith.quantile(latency, 0.5)
        values['scan_p90_s'] = arith.quantile(latency, 0.9)
    return {m['name']: {'value': values[m['name']], 'unit': m['unit']}
            for m in cell.end_to_end if m['name'] in values}
