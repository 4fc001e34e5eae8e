"""The device's idle share of the profiled tail: 1 - (the union of its
kernel, memcpy and memset intervals) / (the tail's wall time)."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.wall_s)
