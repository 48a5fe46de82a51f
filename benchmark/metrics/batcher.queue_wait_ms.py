"""inference/batching.DynamicBatcher: the port's ``batcher.queue`` span,
from a scan's submit to the dispatcher's take, over the traced run's
profiled slice, in ms a scan."""

from benchmark import spans


def read(run):
    return spans.ms_per_scan(spans.of_slice(run), 'batcher.queue')
