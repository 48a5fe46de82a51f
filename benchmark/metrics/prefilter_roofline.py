"""kernel csrc/prefilter.cu: the least time of the B-spline prefilter of
the scans finished in the profiled slice (one pass along each axis of the
two-channel (z, x) projection, from its shape) over the device time of the
kernel's launches in it, in %."""

from benchmark import arith

KERNELS = ('prefilter_kernel',)


def read(run):
    s = run.slice
    if s is None or not s.scans:
        return None
    device_s = s.device_s(KERNELS)
    if device_s <= 0:
        return None
    channels = len(run.cell.config['channels'])
    bound = 0.0
    for v in s.scans:
        z, _, x = run.cell.traffic['volumes'][v]
        bound += arith.prefilter_bound_s([(z, x * channels),
                                          (x, z * channels)])
    return 100.0 * bound / device_s
