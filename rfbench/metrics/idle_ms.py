"""Device idle milliseconds a request or step inside the program's spans
that the metric names (``idle_ms.<name>.json``: ``spans``), or with
``outside`` true in the rest of the profiled tail: the wall time of the
union of those spans on the tail's main thread (``rfbench/spans.py``) less
the device's busy union (kernels, copies, memsets) within it.  Spans that
overlap count once.  None when the trace holds none of the spans."""

from rfbench import spans as sp


def read(run, spans=(), outside=False):
    trace = sp.readable(run)
    if trace is None:
        return None
    inside = sp.union(sp.on_main(trace, spans))
    if not inside:
        return None
    busy = trace.busy_intervals()
    wall, busy_in = sp.length(inside), sp.overlap(inside, busy)
    if outside:
        idle = (trace.end - trace.start - wall) - (sp.length(busy) - busy_in)
    else:
        idle = wall - busy_in
    return idle * 1e-3 / len(run.tail['records'])
