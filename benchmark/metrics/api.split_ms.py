"""api.TS2D finish: the port's ``api.split`` span inside ``api.assemble``
(each model's copy of its channels out of the merged masks, and their
images) over the traced run's profiled slice, in ms a scan."""

from benchmark import spans


def read(run):
    return spans.ms_per_scan(spans.of_slice(run), 'api.split')
