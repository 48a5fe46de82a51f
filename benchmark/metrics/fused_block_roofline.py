"""kernel csrc/fused_block.cu: the least time of the fused norm-act-conv
blocks of the scans finished in the profiled slice (every fused block of
each group's forwards at N = tiles x mirrors x folds, from the shapes of the
configuration's network) over the device time of the kernel's launches in
it, in %."""

from benchmark import arith, database, reference

KERNELS = ('fused_conv_sm90', 'stats_sum_kernel')


def bound_s(config, tiles):
    n = (tiles * len(reference.mirror_combos(config['mirror_axes']))
         * len(config['folds']))
    # the groups' networks differ only in their heads, which are not fused
    arch = database.arch(config, next(iter(config['groups'])))
    blocks = arith.fused_launches(arch, tuple(config['patch_size']))
    return len(config['groups']) * sum(
        arith.fused_bound_s(n, *b) for b in blocks)


def read(run):
    s = run.slice
    if s is None or not s.scans:
        return None
    device_s = s.device_s(KERNELS)
    if device_s <= 0:
        return None
    return 100.0 * sum(bound_s(run.cell.config, run.tiles[v])
                       for v in s.scans) / device_s
