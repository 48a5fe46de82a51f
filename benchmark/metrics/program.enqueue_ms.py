"""inference/ensemble_engine + inference/program: the port's
``program.enqueue`` span (the device program's launches, up to its last,
on the host) less any ``program.sync`` inside it, summed over the programs
of the traced run's profiled slice, over the scans they carried, in ms a
scan."""

from benchmark import spans


def read(run):
    return spans.ms_per_scan(spans.of_slice(run), 'program.enqueue',
                             less=('program.sync',))
