"""api.TS2D's host half per scan: RAI reorient, the MIP + AIP projection,
the crop and the submit, timed by the benchmark's own span around
``predict_async`` over the traced run's window, in ms a scan."""


def read(run):
    if not run.dispatch_s:
        return None
    return 1e3 * sum(run.dispatch_s) / len(run.dispatch_s)
