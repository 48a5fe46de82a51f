"""inference/ensemble_engine fetch: the bytes that the port's
``engine.fetch`` spans copied from the card (the compact wire's bitmap and
prefix, a speculative prefix included, or the plain wire's packed masks),
summed over the programs of the traced run's profiled slice, over the
scans they carried, in MB (1e6 bytes) a scan; None from a port whose
spans carry no byte count."""

from benchmark import spans


def read(run):
    got = [s for s in spans.of_slice(run) or ()
           if s.name == 'engine.fetch']
    counted = [getattr(s, 'nbytes', 0) for s in got]
    if not any(counted):
        return None
    return sum(counted) / 1e6 / sum(max(1, len(s.scans)) for s in got)
