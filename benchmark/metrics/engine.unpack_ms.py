"""api.TS2D finish: the port's ``engine.unpack`` (the masks' bits to one
byte a label) and ``engine.place`` (the crop's masks into the full frame)
spans, the host's rebuild of the full-frame masks, over the traced run's
profiled slice, in ms a scan."""

from benchmark import spans


def read(run):
    got = spans.of_slice(run)
    unpack = spans.ms_per_scan(got, 'engine.unpack')
    if unpack is None:
        return None
    return unpack + (spans.ms_per_scan(got, 'engine.place') or 0.0)
