"""One fast (bf16) U-Net forward of the PyTorch port on the GPU, for each of
several checkouts, each in a process of its own:

    python tools/torch_forward_probe.py ROOT [ROOT ...]

Each ROOT is a checkout of the repository whose ``totalsegmentator2d_tpu_torch``
is measured: the flagship group architecture (6-stage nnU-Net, features
32..512, 25 outputs) with random weights from a seed, on the main path's
16 x 2 x 256 x 256 tile batch. Per ROOT one line: the eager time of a forward
(CUDA events over 10 back-to-back forwards), the host's time to enqueue one,
and from a torch.profiler trace of one forward the summed device time of
its kernels and of the fused block kernel's launches. Give the parent and
the change as ``parent change change parent`` to compare them inside one
run on one card.
"""

import os
import subprocess
import sys

MEASURE = r'''
import sys, time
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from totalsegmentator2d_tpu_torch.models.plans import ArchSpec
from totalsegmentator2d_tpu_torch.models.unet import UNet

n = 6
spec = ArchSpec(n_stages=n, features_per_stage=(32, 64, 128, 256, 512, 512),
                kernel_sizes=((3, 3),) * n,
                strides=((1, 1),) + ((2, 2),) * (n - 1),
                n_conv_per_stage=(2,) * n,
                n_conv_per_stage_decoder=(2,) * (n - 1),
                in_channels=2, out_channels=25)
torch.manual_seed(0)
net = UNet(spec).cuda().eval()
net.prepare_fast()
x = torch.randn(16, 2, 256, 256, device='cuda')
with torch.no_grad():
    for _ in range(3):
        net.forward_nchw(x, torch.bfloat16)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(10):
        net.forward_nchw(x, torch.bfloat16)
    end.record()
    host_ms = (time.perf_counter() - t0) / 10 * 1e3
    torch.cuda.synchronize()
    eager_ms = start.elapsed_time(end) / 10
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        net.forward_nchw(x, torch.bfloat16)
        torch.cuda.synchronize()
kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
device = sum(e.device_time_total for e in kernels) / 1e3
fused = sum(e.device_time_total for e in kernels if 'fused_conv' in e.name) / 1e3
print(f'{sys.argv[1]}: forward eager {eager_ms:.3f} ms, host enqueue '
      f'{host_ms:.3f} ms, device sum {device:.3f} ms (fused block kernel '
      f'{fused:.3f} ms), {len(kernels)} kernels', flush=True)
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
