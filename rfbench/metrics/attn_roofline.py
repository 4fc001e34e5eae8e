"""Share of the attention kernels' roofline in the profiled tail: the least
time of its requests' or steps' attention sites (rfbench/counts.py: the
larger of FLOPs over the dtype's dense peak and bytes over 3.35 TB/s) over
the device time of the metric's kernels (``attn_roofline.<kind>.json``)
that ran, forward, remat recomputation and backward alike."""


def read(run, kernels=()):
    if run.trace is None:
        return None
    events = run.trace.kernels(tuple(kernels))
    if not events:
        return None
    least = sum(s.least_s for sites in run.tail['sites'] for s in sites)
    return 100.0 * least / (sum(e['dur'] for e in events) * 1e-6)
