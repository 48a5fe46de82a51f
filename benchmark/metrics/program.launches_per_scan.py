"""The solo and batched programs: CUDA kernels launched in the profiled
slice over the scans finished in it."""


def read(run):
    if run.slice is None or not run.slice.scans or not run.slice.launches():
        return None
    return run.slice.launches() / len(run.slice.scans)
