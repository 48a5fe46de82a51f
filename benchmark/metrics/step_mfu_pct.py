"""The whole step's share of the card's peak: the U-Net operations of the
scans finished in the profiled slice (each scan's tiles x mirrors x folds
forwards of every group, counted from the architecture) over the slice's
seconds x the peak of the configuration's precision, in %."""

from benchmark import arith, reference


def flops_per_scan(config, tiles):
    """U-Net operations of one scan of ``tiles`` tiles."""
    forwards = (tiles * len(reference.mirror_combos(config['mirror_axes']))
                * len(config['folds']))
    h, w = config['patch_size']
    return forwards * sum(
        arith.unet_flops(config['features_per_stage'], len(config['channels']),
                         labels, h, w) for labels in config['groups'].values())


def read(run):
    s = run.slice
    if s is None or not s.scans or not s.kernels or s.window_s <= 0:
        return None
    config = run.cell.config
    flops = sum(flops_per_scan(config, run.tiles[v]) for v in s.scans)
    peak = arith.PEAKS[arith.PRECISION_PEAK[config['precision']]]
    return 100.0 * flops / (s.window_s * peak)
