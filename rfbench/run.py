"""Run one cell of the benchmark once and print its result line.

    python3 -m rfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (imports, the kernel library, seeded
weights on the device, the traffic's inputs, warm-up of every shape the
cell uses) is timed from the start of this module to the window's start
as ``setup_s``.  The window then runs the cell's traffic for ``--seconds``;
with ``--trace 1`` a short tail of the same work follows under the
profiler, and the per-layer metrics are read from the window and that
tail.  After the window the program's outputs are compared with the plain
reference in ``rfbench/reference`` (``correct``).  The last line of
standard output is one JSON object; each number compared, with its limit,
ends standard error and the result line.

Exit codes: 0 with a result; 2 without the cell's CUDA devices; 3 when a
module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional  # noqa: E402

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'renderformer_tpu')


def forbidden_modules():
    """Top-level names of loaded modules that a run may not load, compared
    whole (``renderformer_tpu_torch`` is not ``renderformer_tpu``)."""
    return sorted({name.split('.')[0] for name in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """What a metric's reader reads: the window's records, the profiled
    tail's records and attention sites, and its trace."""

    cell: object
    window: Dict
    tail: Optional[Dict] = None
    trace: Optional[object] = None


def card_line() -> str:
    import torch
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f'nvidia-smi: {e}'
    return f'card: {torch.cuda.get_device_name(0)} | {out} | torch {torch.__version__}'


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = 'cuda',
             t_start: float = T_START, controls=()) -> Dict:
    """One run of ``cell``; returns the result's fields, and with
    ``controls`` (reference precisions) their readings under 'controls'."""
    import torch
    from rfbench import registry
    from rfbench import trace as tracing
    dev = torch.device(device)
    drv = registry.driver(cell.mix['kind']).Driver(cell, seed, device)
    t_setup = time.perf_counter()
    drv.setup()
    setup_s = time.perf_counter() - t_start
    last, phases = t_setup, [f'imports {t_setup - t_start:.3f}']
    for name, t in drv.phases:
        phases.append(f'{name} {t - last:.3f}')
        last = t
    print('setup phases (s): ' + ', '.join(phases), flush=True)
    window = drv.window(seconds)
    tail = prof = None
    if trace:
        tail, prof = tracing.profiled(drv.tail, dev.type)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda' else 0
    loaded = forbidden_modules()
    for key, n in sorted(drv.launches.items(), key=lambda kv: kv[0][0]):
        print(f'launches: {n} x (triangles {key[0]}) ' + json.dumps(dict(key[1:])), flush=True)
    t_judge = time.perf_counter()
    verdict = drv.judge(controls)
    print(f'timing: setup {setup_s:.3f} s, window {window["t_end"] - window["t0"]:.3f} s, '
          f'{len(window["records"])} done, comparison {time.perf_counter() - t_judge:.3f} s',
          flush=True)
    ends = [window['t0']] + [r['t_done'] for r in window['records']]
    gaps = sorted(b - a for a, b in zip(ends, ends[1:]))
    if len(gaps) >= 4:
        third = len(gaps) // 3
        print('window: ms between completions, quartiles '
              + ', '.join(f'{q * 1e3:.2f}' for q in statistics.quantiles(gaps, n=4))
              + '; first and last thirds, mean ' + ', '.join(
                  f'{statistics.mean(b - a for a, b in zip(e, e[1:])) * 1e3:.2f}'
                  for e in (ends[:third + 1], ends[-third - 1:])), flush=True)
    run = Run(cell, window, tail, prof)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = setup_s if m['name'] == 'setup_s' else registry.reader(m['name'])(run)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    limits = cell.limits['limits']
    checks = {k: {'value': v, 'limit': limits[k]} for k, v in verdict['gaps'].items()}
    correct = (verdict['finite'] and drv.failed == 0
               and all(c['value'] <= c['limit'] for c in checks.values()))
    dev_info = {'platform': 'gpu' if dev.type == 'cuda' else dev.type,
                'kind': torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu',
                'count': cell.chips, 'memory_peak_bytes': int(peak)}
    result = {'correct': bool(correct), 'attempted': drv.attempted, 'failed': drv.failed,
              'metrics': metrics, 'device': dev_info}
    if prof is not None:
        dev_info['busy_s'] = prof.busy_s
        dev_info['window_s'] = prof.wall_s
        result['breakdown'] = prof.breakdown()
    result['checks'] = checks
    return dict(result=result, loaded=loaded, controls=verdict['controls'],
                sample=verdict['sample'], detail=verdict.get('detail'))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from rfbench import registry
    cell = registry.load(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f'rfbench: {args.workload} needs {cell.chips} CUDA device(s); '
              f'found {torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    print(card_line(), flush=True)
    loaded = sorted(set(out['loaded']) | set(forbidden_modules()))
    if loaded:
        print(f'rfbench: the run loaded {loaded}: the port and the benchmark may load '
              'neither JAX nor the JAX package', file=sys.stderr)
        return 3
    res = out['result']
    print(f"compared requests/steps: {out['sample']}", flush=True)
    for name, c in res['checks'].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
