"""The PyTorch port's B-spline prefilter kernel on the GPU, for each of
several checkouts, each in a process of its own:

    python tools/torch_prefilter_probe.py ROOT [ROOT ...]

Each ROOT is a checkout of the repository whose
``totalsegmentator2d_tpu_torch`` kernel is measured (built from that
checkout's sources) at two pairs of launches: the main path's (400, 512, 2)
projection along axis 0 then 1, and the batch-8 shape (8, 400, 512, 2) along
axes 1 then 2. Per ROOT and pair one line: eager ms per pair (CUDA events
over 200 back-to-back pairs, the host's launch work included) and device ms
per pair (a CUDA graph of 50 pairs, replayed), beside the launch floor (two
empty kernels timed the same two ways) and the bytes bound at 3.35 TB/s.
Inputs come from a seed, so every ROOT filters the same data; each line
ends with a checksum of the outputs. Give the parent and the change as
``parent change change parent`` to compare them inside one run on one card.
"""

import os
import subprocess
import sys

MEASURE = r'''
import sys
import torch
from totalsegmentator2d_tpu_torch.ops.cuda import prefilter as PF


def eager_ms(fn, iters=200):
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


def device_ms(fn, iters=50):
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
    return start.elapsed_time(end) / iters


def empty_pair():
    torch.cuda._sleep(0)
    torch.cuda._sleep(0)


gen = torch.Generator().manual_seed(0)
cases = (('main (400, 512, 2) axes 0, 1', (400, 512, 2), (0, 1)),
         ('batch-8 (8, 400, 512, 2) axes 1, 2', (8, 400, 512, 2), (1, 2)))
floor = (eager_ms(empty_pair), device_ms(empty_pair))
for name, shape, axes in cases:
    x = torch.randn(shape, generator=gen).cuda()

    def pair():
        return PF.bspline_prefilter_cuda(PF.bspline_prefilter_cuda(x, axes[0]),
                                         axes[1])

    bound = 2 * 2 * x.numel() * 4 / 3.35e12 * 1e3
    total = float(pair().double().abs().sum())
    print(f'{sys.argv[1]}: {name}: eager {eager_ms(pair):.4f} ms, device '
          f'{device_ms(pair):.4f} ms; launch floor {floor[0]:.4f} / '
          f'{floor[1]:.4f} ms; bytes bound {bound:.5f} ms; '
          f'sum |y| {total:.6f}', flush=True)
'''


def main(roots):
    if not roots:
        raise SystemExit(__doc__)
    for root in roots:
        root = os.path.abspath(root)
        env = dict(os.environ, PYTHONPATH=root)
        subprocess.run([sys.executable, '-c', MEASURE, root], env=env,
                       cwd=root, check=True)


if __name__ == '__main__':
    main(sys.argv[1:])
