"""The H100: the share of the profiled slice in which no kernel ran (the
union of the kernels' intervals against the slice's length), in %."""


def read(run):
    s = run.slice
    if s is None or not s.kernels or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
