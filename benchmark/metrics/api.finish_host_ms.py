"""api.TS2D finish: the port's ``api.finish_predict`` span less its
``engine.wait`` (the wait for the batcher's future and the fetched result):
unpack, place and the Result's assembly, over the traced run's profiled
slice, in ms a scan."""

from benchmark import spans


def read(run):
    return spans.ms_per_scan(spans.of_slice(run), 'api.finish_predict',
                             less=('engine.wait',))
