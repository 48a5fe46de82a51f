"""The host's MAX + MEAN projection per checkout, each in a process of its
own, and the projection's paths over one benchmark run:

    python tools/torch_projection_probe.py ROOT [ROOT ...]
    python tools/torch_projection_probe.py --cell CELL --seed N [--trace 1]
    python tools/torch_projection_probe.py --pages

Each ROOT is a checkout of the repository whose
``totalsegmentator2d_tpu_torch`` is measured: ``io.native.project_max_mean``
on a (400, 512, 512) int16 volume from a fixed seed (the benchmark's
400-slice CT size), 15 calls after 3 warm-ups: the median and the runs in
ms, and a sha256 of the outputs, equal across checkouts whose passes agree
bit for bit. A checkout with the threaded pass is also timed at 1, 2, 4 and
8 threads, each run's outputs checked against the one-thread call's. The
first line is the host: its usable cores and CPU model. Give the parent and
the change as ``parent change change parent`` to compare them on one host.

``--cell`` runs one benchmark run of this checkout in this process
(``benchmark/harness.py``, 45 s window) and then prints
``projection_counts()`` and ``assembly_counts()``, the calls each host
pass took by path in the whole run, the micro-batcher's ``stats()`` as the
run closed ``TS2D`` (its ``batch_solo_reasons`` say why scans went alone),
and the one-pass assembly of a radiograph's Result (``assemble_masks``: a
3056 x 2544 frame of 117 labels from a 2900 x 2400 crop, merged and per
group) timed on 1 to 8 threads, 5 calls each after one warm-up, against
numpy's unpack, place and copies, each run's arrays checked against the
one-thread call's.

``--pages`` times the routes to that Result's pages before its pass, each
on a thread of its own: ``io.native.map_mask_arrays`` populating its
mappings whole or in chunks of 32, 8, 2 and 0.5 MiB, and ``np.empty``
with one byte a page written. For each: the job's ms alone; the job's ms
and a caller's ms beside it, a caller that writes fresh memory as a
radiograph's crop and fetch do (a 32 MB copy and a zeroed 228 MB array,
twice) and one that only computes on memory it wrote before (each against
its ms alone); and the pass's ms into the job's arrays (against the pass
into fresh ones); medians of 3, the arrays checked against the fresh
pass's.
"""

import json
import os
import statistics
import subprocess
import sys
import time

MEASURE = r'''
import hashlib, json, statistics, time
import numpy as np
from totalsegmentator2d_tpu_torch.io import native

vol = np.random.default_rng(19).integers(-1024, 3071, (400, 512, 512),
                                         dtype=np.int16)


def timed(fn, n=15, warm=3):
    for _ in range(warm):
        out = fn()
    runs = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        runs.append((time.perf_counter() - t0) * 1e3)
    return out, runs


out, runs = timed(lambda: native.project_max_mean(vol))
digest = hashlib.sha256(out[0].tobytes() + out[1].tobytes()).hexdigest()
line = {'root': ROOT, 'project_max_mean_ms': statistics.median(runs),
        'runs_ms': [round(r, 3) for r in runs], 'sha256': digest[:16]}
if hasattr(native, '_project_native'):
    lib = native._load()
    by = {}
    for threads in (1, 2, 4, 8):
        got, runs = timed(lambda: native._project_native(lib, vol, threads))
        assert all(a.tobytes() == b.tobytes() for a, b in zip(got, out))
        by[threads] = round(statistics.median(runs), 3)
    line['threads_ms'] = by
    line['usable_cores'] = native.usable_cores()
    line['projection_counts'] = native.projection_counts()
print(json.dumps(line), flush=True)
'''


def host() -> str:
    model = ''
    try:
        with open('/proc/cpuinfo') as f:
            model = next((ln.split(':', 1)[1].strip() for ln in f
                          if ln.startswith('model name')), '')
    except OSError:
        pass
    return (f'host: {len(os.sched_getaffinity(0))} usable cores of '
            f'{os.cpu_count()}, {model}')


def cell(argv) -> int:
    """One benchmark run of this checkout, then the projection's paths."""
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from benchmark import harness
    args = ['--workload', argv[argv.index('--cell') + 1],
            '--seed', argv[argv.index('--seed') + 1], '--seconds', '45',
            '--trace', argv[argv.index('--trace') + 1]
            if '--trace' in argv else '0']
    from totalsegmentator2d_tpu_torch import api
    from totalsegmentator2d_tpu_torch.io import native
    stats = {}
    close = api.TS2D.close

    def closing(tool):
        batcher = getattr(tool._fused, '_batcher', None)
        if batcher is not None:
            stats.update(batcher.stats())
        close(tool)
    api.TS2D.close = closing
    rc = harness.main(args, t0, root)
    print('projection_counts', native.projection_counts(), flush=True)
    print('assembly_counts', native.assembly_counts(), flush=True)
    print('batcher', {k: stats.get(k) for k in (
        'batch_solo_reasons', 'batch_occupancy')}, flush=True)
    print('assembly', json.dumps(time_assembly()), flush=True)
    return rc


def time_pages(full=(3056, 2544), crop=(2900, 2400),
               counts=(24, 21, 22, 24, 26)) -> dict:
    """The routes to a detector-size radiograph's Result pages before its
    pass, beside a caller writing fresh memory: median ms of 3 each."""
    import threading
    import numpy as np
    from totalsegmentator2d_tpu_torch.io import native
    n_labels = sum(counts)
    packed = np.random.default_rng(22).integers(
        0, 256, crop + (-(-n_labels // 8),), dtype=np.uint8)
    window = (0, 0) + crop
    origin = tuple((f - c) // 2 for f, c in zip(full, crop))

    def ms(t):
        return (time.perf_counter() - t) * 1e3

    def caller():
        t = time.perf_counter()
        for _ in range(2):
            a = np.empty(32 << 20, np.uint8)
            a.fill(1)
            b = np.zeros(228 << 20, np.uint8)
            b[::4096] = 1
            del a, b
        return ms(t)
    warm = np.ones(64 << 20, np.uint8)

    def computer():
        t = time.perf_counter()
        for _ in range(8):
            warm.sum(dtype=np.int64)
        return ms(t)
    callers = {'caller': caller, 'computer': computer}

    def touched():
        got = ([np.empty(full + (n_labels,), np.uint8)],
               [np.empty(full + (n,), np.uint8) for n in counts])
        for a in got[0] + got[1]:
            a.reshape(-1)[::4096] = 0
        return got[0][0], got[1]

    def mapped(chunk):
        def job():
            native.PAGES_CHUNK_BYTES = chunk
            return native.map_mask_arrays(full, counts, True)
        return job

    def passed(out=None):
        t = time.perf_counter()
        got = native.assemble_masks(packed, window, origin, full, counts,
                                    True, out)
        return got, ms(t)
    chunk0 = native.PAGES_CHUNK_BYTES
    want, _ = passed()
    line = {'frame': list(full) + [n_labels], 'fresh_pass_ms': round(
        statistics.median(passed()[1] for _ in range(3)), 3)}
    for name, fn in callers.items():
        line[f'{name}_alone_ms'] = round(statistics.median(
            fn() for _ in range(3)), 3)
    routes = {'touch': touched, 'map_whole': mapped(1 << 62)}
    routes.update((f'map_{c >> 10}KiB', mapped(c)) for c in (
        32 << 20, 8 << 20, 2 << 20, 512 << 10))
    for name, job in routes.items():
        runs = {}
        for beside in (None, *callers):
            for _ in range(3):
                box = {}

                def run():
                    t = time.perf_counter()
                    box['out'] = job()
                    box['job_ms'] = ms(t)
                worker = threading.Thread(target=run)
                worker.start()
                if beside is not None:
                    runs.setdefault(f'{beside}_ms', []).append(
                        callers[beside]())
                worker.join()
                key = f'job_beside_{beside}_ms' if beside else 'job_ms'
                runs.setdefault(key, []).append(box['job_ms'])
                got, pass_ms = passed(box.pop('out'))
                assert all(a.tobytes() == b.tobytes() for a, b in
                           zip([got[0]] + got[1], [want[0]] + want[1]))
                del got
                runs.setdefault('pass_ms', []).append(pass_ms)
        line[name] = {k: round(statistics.median(v), 3)
                      for k, v in runs.items()}
    native.PAGES_CHUNK_BYTES = chunk0
    return line


def time_assembly(full=(3056, 2544), crop=(2900, 2400),
                  counts=(24, 21, 22, 24, 26)) -> dict:
    """The one-pass assembly of a detector-size radiograph's masks on 1 to
    8 threads against numpy's chain, median ms of 5 calls each."""
    import numpy as np
    from totalsegmentator2d_tpu_torch.inference.ensemble_engine import \
        unpack_bits
    from totalsegmentator2d_tpu_torch.io import native
    n_labels = sum(counts)
    packed = np.random.default_rng(22).integers(
        0, 256, crop + (-(-n_labels // 8),), dtype=np.uint8)
    window = (0, 0) + crop
    origin = tuple((f - c) // 2 for f, c in zip(full, crop))

    def chain():
        seg = np.zeros(full + (n_labels,), np.uint8)
        seg[origin[0]:origin[0] + crop[0], origin[1]:origin[1] + crop[1]] = \
            unpack_bits(packed, n_labels)
        ends = np.cumsum((0,) + counts)
        return seg, [np.ascontiguousarray(seg[..., a:b])
                     for a, b in zip(ends[:-1], ends[1:])]

    def timed(fn, n=5):
        out = fn()
        runs = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            runs.append((time.perf_counter() - t) * 1e3)
        return out, round(statistics.median(runs), 3)
    lib = native._load()
    want, numpy_ms = timed(chain)
    want = [want[0]] + want[1]
    by = {}
    for threads in range(1, 9):
        got, by[threads] = timed(lambda: native._assemble_native(
            lib, packed, window, origin, full, counts, True, threads))
        assert all(a.tobytes() == b.tobytes()
                   for a, b in zip([got[0]] + got[1], want))
    return {'frame': list(full) + [n_labels], 'numpy_ms': numpy_ms,
            'threads_ms': by, 'usable_cores': native.usable_cores()}


def main(argv) -> int:
    if '--cell' in argv:
        return cell(argv)
    if '--pages' in argv:
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        print(host(), flush=True)
        print('pages', json.dumps(time_pages()), flush=True)
        return 0
    print(host(), flush=True)
    rc = 0
    for root in argv:
        root = os.path.abspath(root)
        code = f'ROOT = {root!r}\n' + MEASURE
        proc = subprocess.run([sys.executable, '-c', code], cwd=root,
                              env={**os.environ, 'PYTHONPATH': root})
        rc = rc or proc.returncode
    return rc


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
