"""api.TS2D host half: the port's ``api.project`` span (RAI reorient, the
MIP + AIP projection and the 2D model input) over the traced run's profiled
slice, in ms a scan."""

from benchmark import spans


def read(run):
    return spans.ms_per_scan(spans.of_slice(run), 'api.project')
