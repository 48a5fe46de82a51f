"""The whole step's share of the card's peak: the U-Net operations of the
scans finished in the profiled slice (each scan's tiles x mirrors x folds
forwards of every group, counted from the configuration's network) over the
slice's seconds x the peak of the configuration's precision, in %."""

from benchmark import arith, database, reference


def flops_per_scan(config, tiles):
    """U-Net operations of one scan of ``tiles`` tiles."""
    forwards = (tiles * len(reference.mirror_combos(config['mirror_axes']))
                * len(config['folds']))
    h, w = config['patch_size']
    return forwards * sum(arith.unet_flops(database.arch(config, group), h, w)
                          for group in config['groups'])


def read(run):
    s = run.slice
    if s is None or not s.scans or not s.kernels or s.window_s <= 0:
        return None
    config = run.cell.config
    flops = sum(flops_per_scan(config, run.tiles[v]) for v in s.scans)
    peak = arith.PEAKS[arith.PRECISION_PEAK[config['precision']]]
    return 100.0 * flops / (s.window_s * peak)
