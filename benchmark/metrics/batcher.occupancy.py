"""inference/batching.DynamicBatcher: scans a device program carried, on
average, over the traced run's window (the batcher's occupancy counter,
read before and after the window)."""


def read(run):
    programs = sum(run.occupancy)
    if not programs:
        return None
    return sum((i + 1) * n for i, n in enumerate(run.occupancy)) / programs
