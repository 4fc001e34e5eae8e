"""Device milliseconds a request or step of the kernels launched inside the
program's spans that the metric names (``device_ms.<name>.json``:
``spans``).  A kernel belongs to them when the runtime call that launched
it, matched by its correlation id, lies inside one of them on the tail's
main thread (``rfbench/spans.py``); one inside two nested or overlapping
spans counts once.  None when the trace holds none of the spans."""

from rfbench import spans as sp


def read(run, spans=()):
    trace = sp.readable(run)
    if trace is None:
        return None
    inside = sp.union(sp.on_main(trace, spans))
    if not inside:
        return None
    main = sp.main_thread(trace)
    total = 0.0
    for e in trace.device:
        at = trace.launch_at.get(e.get('args', {}).get('correlation'))
        if (e['cat'] == 'kernel' and at and at[1] == main
                and any(a <= at[0] <= b for a, b in inside)):
            total += e['dur']
    return total * 1e-3 / len(run.tail['records'])
