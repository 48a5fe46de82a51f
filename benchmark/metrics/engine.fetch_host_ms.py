"""inference/ensemble_engine fetch: the port's ``engine.fetch`` span (the
bitmap, the compact prefix and the host rebuild) less its
``engine.device_wait`` (the waits on the card's copies), summed over the
programs of the traced run's profiled slice, over the scans they carried,
in ms a scan."""

from benchmark import spans


def read(run):
    return spans.ms_per_scan(spans.of_slice(run), 'engine.fetch',
                             less=('engine.device_wait',))
