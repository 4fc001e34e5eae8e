"""Finds a cell's parts by name, from ``BENCHMARK.json`` and files of their own.

* a configuration: the ``file`` its entry names (``configs/<name>.json``);
* a traffic mix: ``traffic/<traffic>.json``, parameters read by
  ``rfbench/scenes.py`` and the driver its ``kind`` names
  (``drivers/<kind>.py``);
* a cell's correctness limits: ``workloads/<cell>.json``;
* a metric: ``metrics/<name>.py``, or else the reader of its family,
  ``metrics/<family>.py``, the family being the name before its first dot
  (``idle.render`` -> ``idle``) or, in a name with no dot, after its first
  underscore (``train_rays_per_s`` -> ``rays_per_s``).  The reader's
  ``read(run, **params)`` returns a number or None (nothing to read; the
  metric is then left out of the line); ``params`` are the metric's own
  data, ``metrics/<name>.json`` where there is one (a kernel list).

A new cell, mix or metric is a new file and a new entry in
``BENCHMARK.json``; no file that is there changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
from typing import List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict        # the configuration file: 'model' holds the model's keys
    mix: dict           # the traffic file
    limits: dict        # workloads/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def model(self) -> dict:
        return self.config['model']


def _applies(metric: dict, cell: str) -> bool:
    return 'workloads' not in metric or cell in metric['workloads']


def load(cell_name: str, root: str = ROOT, bench: Optional[dict] = None) -> Cell:
    """The cell ``cell_name`` of ``root/BENCHMARK.json`` with its files."""
    bench = bench or _read_json(os.path.join(root, 'BENCHMARK.json'))
    cells = {w['name']: w for w in bench['workloads']}
    if cell_name not in cells:
        raise KeyError(f'no workload {cell_name!r} in BENCHMARK.json ({sorted(cells)})')
    w = cells[cell_name]
    configs = {c['name']: c for c in bench['configs']}
    config = _read_json(os.path.join(root, configs[w['config']]['file']))
    here = os.path.join(root, 'rfbench')
    mix = _read_json(os.path.join(here, 'traffic', f"{w['traffic']}.json"))
    limits = _read_json(os.path.join(here, 'workloads', f'{cell_name}.json'))
    e2e = [m for m in bench['end_to_end'] if _applies(m, cell_name)]
    reported = {m['name'] for m in e2e}
    per_layer = [m for m in bench['per_layer']
                 if _applies(m, cell_name) and m['moves'] in reported]
    return Cell(cell_name, int(w['chips']), config, mix, limits, e2e, per_layer)


def driver(kind: str):
    """The module that drives a traffic mix of ``kind``."""
    return importlib.import_module(f'rfbench.drivers.{kind}')


def family(metric: str) -> str:
    return metric.split('.')[0] if '.' in metric else metric.split('_', 1)[-1]


def reader(metric: str, root: str = ROOT):
    """``run -> value`` for ``metric``: the ``read`` of its own file or of
    its family's (the file name may hold dots), with its data."""
    here = os.path.join(root, 'rfbench', 'metrics')
    path = os.path.join(here, f'{metric}.py')
    if not os.path.exists(path):
        path = os.path.join(here, f'{family(metric)}.py')
    spec = importlib.util.spec_from_file_location(
        f'rfbench.metrics.{os.path.basename(path)[:-3]}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    data = os.path.join(here, f'{metric}.json')
    params = _read_json(data) if os.path.exists(data) else {}
    return lambda run: mod.read(run, **params)
