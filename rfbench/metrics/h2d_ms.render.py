"""Device milliseconds of host-to-device copies a request in the profiled tail."""


def read(run):
    if run.trace is None:
        return None
    copies = run.trace.copies('HtoD')
    if not copies:
        return None
    return sum(e['dur'] for e in copies) * 1e-3 / len(run.tail['records'])
