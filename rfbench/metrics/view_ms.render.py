"""Device milliseconds a request of the kernels launched inside
``model.view_transformer``'s forward (the benchmark's own forward hooks put
a host range around it; kernels join it through the launch correlation)."""

from rfbench.drivers.render import VIEW_RANGE


def read(run):
    if run.trace is None:
        return None
    events = [e for e in run.trace.launched_in(VIEW_RANGE) if e['cat'] == 'kernel']
    if not events:
        return None
    return sum(e['dur'] for e in events) * 1e-3 / len(run.tail['records'])
