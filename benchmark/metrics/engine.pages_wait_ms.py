"""api.TS2D finish: the port's ``engine.pages_wait`` span, the finish's
wait for the pages thread to map and populate the Result's arrays (mapped
from the call on, so a wait is the part of that job the crop, the card
and the fetch did not hide), over the traced run's profiled slice, in ms
a scan; None from a port without the span."""

from benchmark import spans


def read(run):
    return spans.ms_per_scan(spans.of_slice(run), 'engine.pages_wait')
