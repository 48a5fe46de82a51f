"""kernel csrc/prefilter.cu: the least time of the B-spline prefilter of
the scans finished in the profiled slice (one pass along each axis of the
cropped model input that the down-resample changes: a CT's (z, x, 2)
projection, a radiograph's (rows, cols, 1) crop, from their shapes) over
the device time of the kernel's launches in it, in %."""

from benchmark import arith, manifest, reference

KERNELS = ('prefilter_kernel',)


def passes(extent, spacing_yx, config):
    """[(samples, lines)] of each prefilter pass over one scan's input."""
    h, w = extent
    c = len(config['channels'])
    rs = reference.resampled_shape(extent, spacing_yx, config['spacing'])
    return ([(h, w * c)] if rs[0] != h else []) + (
        [(w, h * c)] if rs[1] != w else [])


def read(run):
    s = run.slice
    if s is None or not s.scans:
        return None
    device_s = s.device_s(KERNELS)
    if device_s <= 0:
        return None
    sp = reference.spacing_yx(manifest.spacing(run.cell.traffic))
    bound = 0.0
    for v in s.scans:
        bound += arith.prefilter_bound_s(
            passes(run.extents[v], sp, run.cell.config))
    return 100.0 * bound / device_s
