"""The benchmark's own profiler session over a short tail of work, and what
its trace says.

``profiled(fn)`` runs ``fn`` under ``torch.profiler`` (CPU and CUDA
activities, CUPTI on the card) inside the range ``rfbench.tail``, writes the
Chrome trace to a file in ``TMPDIR``, reads it back and removes it.  From
the trace's own timeline:

* device intervals: every kernel, memcpy and memset on the device;
* busy: the union of those intervals inside the tail's range, so
  overlapping work counts once; idle is the rest of the range's wall time;
* a kernel belongs to a host range (``record_function``) when the runtime
  call that launched it, matched by the profiler's correlation id, lies
  inside the range on the same thread;
* the breakdown: device operations by total time, and the idle gaps by
  the host operation that covers each gap's middle.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import re
import tempfile
from typing import Dict, List, Optional, Tuple

TAIL = 'rfbench.tail'
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'user_annotation', 'cuda_runtime', 'cuda_driver', 'python_function')


@dataclasses.dataclass
class Trace:
    start: float                      # the tail's range, microseconds
    end: float
    device: List[dict]                # device events inside the range
    host: List[dict]                  # host events (main thread)
    ranges: Dict[str, List[Tuple[float, float, int]]]   # annotation -> [(ts, end, tid)]
    launch_at: Dict[int, Tuple[float, int]]             # correlation -> (ts, tid)

    @property
    def wall_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        spans = sorted((max(e['ts'], self.start), min(e['ts'] + e['dur'], self.end))
                       for e in self.device)
        merged: List[List[float]] = []
        for a, b in spans:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def kernels(self, names) -> List[dict]:
        """Kernel events whose name holds one of ``names``."""
        return [e for e in self.device
                if e['cat'] == 'kernel' and any(n in e['name'] for n in names)]

    def copies(self, direction: str) -> List[dict]:
        """memcpy events of one direction ('HtoD', 'DtoH', 'DtoD')."""
        return [e for e in self.device if e['cat'] == 'gpu_memcpy' and direction in e['name']]

    def launched_in(self, range_name: str) -> List[dict]:
        """Device events whose launch lies inside a host range of that name."""
        spans = self.ranges.get(range_name, [])
        out = []
        for e in self.device:
            at = self.launch_at.get(e.get('args', {}).get('correlation'))
            if at and any(a <= at[0] <= b and tid == at[1] for a, b, tid in spans):
                out.append(e)
        return out

    def breakdown(self, top: int = 10) -> dict:
        ops: Dict[str, float] = collections.Counter()
        for e in self.device:
            ops[short_name(e['name'])] += e['dur'] * 1e-6
        gaps: Dict[str, float] = collections.Counter()
        busy = self.busy_intervals()
        edges = [self.start] + [x for ab in busy for x in ab] + [self.end]
        host = sorted(self.host, key=lambda e: e['ts'])
        starts = [e['ts'] for e in host]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps[self.host_at((a + b) / 2, host, starts)] += (b - a) * 1e-6
        return {'device_ops': [[k, v] for k, v in ops.most_common(top)],
                'idle_gaps': [[k, v] for k, v in gaps.most_common(top)]}

    @staticmethod
    def host_at(t: float, host: List[dict], starts: List[float], reach: int = 4096) -> str:
        """The innermost host event covering time ``t``: host events nest, so
        it is the latest-starting one that covers it."""
        i = bisect.bisect_right(starts, t) - 1
        for e in host[i:max(i - reach, -1):-1]:
            if e['ts'] + e['dur'] >= t:
                return f"host: {short_name(e['name'])}"
        return 'host: no profiled op (python)'


def short_name(name: str, width: int = 96) -> str:
    """A kernel or op name without template arguments and parameter lists."""
    s = re.sub(r'<.*>', '', name)
    s = re.sub(r'\(.*\)', '', s).replace('void ', '').strip()
    return (s or name)[:width]


def parse(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f).get('traceEvents', [])
    spans = [e for e in events if e.get('ph') == 'X' and 'dur' in e]
    tails = [e for e in spans if e.get('cat') == 'user_annotation' and e['name'] == TAIL]
    if not tails:
        raise RuntimeError(f'the trace holds no {TAIL} range')
    start, end = tails[0]['ts'], tails[0]['ts'] + tails[0]['dur']
    main_tid = tails[0]['tid']
    device = [e for e in spans if e.get('cat') in DEVICE_CATS
              and e['ts'] < end and e['ts'] + e['dur'] > start]
    host = [e for e in spans if e.get('cat') in HOST_CATS and e['tid'] == main_tid
            and e['name'] != TAIL]
    ranges: Dict[str, List[Tuple[float, float, int]]] = collections.defaultdict(list)
    for e in spans:
        if e.get('cat') == 'user_annotation':
            ranges[e['name']].append((e['ts'], e['ts'] + e['dur'], e['tid']))
    launch_at = {e['args']['correlation']: (e['ts'], e['tid']) for e in spans
                 if e.get('cat') in ('cuda_runtime', 'cuda_driver')
                 and 'correlation' in e.get('args', {})}
    return Trace(start, end, device, host, dict(ranges), launch_at)


def profiled(fn, device_type: str = 'cuda') -> Tuple[object, Optional[Trace]]:
    """(fn()'s result, the trace of its run) under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device_type == 'cuda' else [])
    with profile(activities=acts) as prof:
        with record_function(TAIL):
            out = fn()
        if device_type == 'cuda':
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix='.json', prefix='rfbench-trace-')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return out, parse(path)
    finally:
        os.remove(path)
