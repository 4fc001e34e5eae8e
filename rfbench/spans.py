"""The program's own host ranges in a profiled tail (``utils/profiling.annotate``
in ``renderformer_tpu_torch``: ``rf.render``, ``rf.model.encoder``,
``rf.train.forward``, ...), as intervals on the tail's main thread, where
the client or the job calls the program.

Intervals are (start, end) pairs in the trace's microseconds.  A program
that sets no range of a name has none in the trace: the readers then
return None, so a metric of a span the program lacks is left out of the
line, not read as nought.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from rfbench.trace import TAIL, Trace

Interval = Tuple[float, float]


def main_thread(trace: Trace) -> int:
    """The thread that entered the tail's range."""
    return trace.ranges[TAIL][0][2]


def on_main(trace: Trace, names: Iterable[str]) -> List[Interval]:
    """Every range of one of ``names`` on the main thread, in the tail."""
    main = main_thread(trace)
    return [(max(a, trace.start), min(b, trace.end)) for n in names
            for a, b, tid in trace.ranges.get(n, ()) if tid == main and b > trace.start
            and a < trace.end]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Overlapping or touching intervals merged, sorted."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def length(intervals: Iterable[Interval]) -> float:
    return sum(b - a for a, b in intervals)


def overlap(xs: List[Interval], ys: List[Interval]) -> float:
    """The length of the intersection of two sorted unions."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def readable(run) -> Optional[Trace]:
    """The run's trace when it has device events and the tail records to
    share them out over; else None."""
    trace = run.trace
    if trace is None or not trace.device or not (run.tail or {}).get('records'):
        return None
    return trace
