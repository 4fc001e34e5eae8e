"""Readings for a cell's correctness limits: the program and the controls on many seeds.

    python3 -m rfbench.calibrate --workload <cell> --seeds 11 12 13 [--seconds 3] [--control]
        [--also bf16,bf16 bf16,fp32,tf32 ...]
        [--fault unchanged_state|half_batch|altered_image|altered_gradient]

Each seed is one run of the cell (set-up, a short window at the cell's own
load, the comparison) in this one process.  With ``--control`` each
control that ``workloads/<cell>.json`` lists (the reference one step below
the configuration's precision) is read on the same sample as the program
is; ``--also`` reads further reference precisions so, each given as
``encoder,view[,tf32]``.  With ``--fault`` the program runs with that fault
planted (``rfbench/faults.py``), and its readings are the fault's.  One
JSON line a seed, then the largest program reading and the smallest
reading of each control, number by number.  The limits are set between
the two, by hand, in the cell's file.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def precision(spec: str):
    from rfbench.reference.model import Precision
    parts = spec.split(',')
    return Precision(encoder=parts[0], view=parts[1], tf32=parts[2:] == ['tf32'])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--seconds', type=float, default=3.0)
    ap.add_argument('--control', action='store_true')
    ap.add_argument('--also', nargs='*', default=[])
    ap.add_argument('--fault', default=None)
    args = ap.parse_args(argv)
    import contextlib
    import torch
    from rfbench import faults, registry
    from rfbench.reference.model import Precision
    from rfbench.run import run_cell
    cell = registry.load(args.workload)
    if not torch.cuda.is_available():
        print('rfbench.calibrate: no CUDA device', file=sys.stderr)
        return 2
    controls = [Precision(**c) for c in cell.limits['controls']] if args.control else []
    controls += [precision(a) for a in args.also]
    program, least = {}, {c.name: {} for c in controls}
    for seed in args.seeds:
        t = time.perf_counter()
        with faults.FAULTS[args.fault]() if args.fault else contextlib.nullcontext():
            out = run_cell(cell, seed, args.seconds, False, t_start=t, controls=tuple(controls))
        res = out['result']
        line = {'seed': seed, 'correct': res['correct'], 'attempted': res['attempted'],
                'program': {k: c['value'] for k, c in res['checks'].items()},
                'controls': {c.name: out['controls'][c] for c in controls},
                'sample': out['sample'], 'detail': out['detail'],
                'seconds': time.perf_counter() - t}
        for c in controls:
            for k, v in out['controls'][c].items():
                least[c.name][k] = min(least[c.name].get(k, float('inf')), v)
        for k, v in line['program'].items():
            program[k] = max(program.get(k, 0.0), v)
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({'workload': args.workload, 'seeds': len(args.seeds), 'fault': args.fault,
                      'program_max': program,
                      'controls_min': least}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
