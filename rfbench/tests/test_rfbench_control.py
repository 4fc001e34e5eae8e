"""The controls of each cell's comparison: the reference computed one step
below the configuration's precision (each control the cell's file lists),
read as the program is read, has to fail the cell's limits while the
program passes them.

On the CPU at a tiny size; on the card (marked ``cuda``) at the cell's
own size for one seed, as ``python3 -m rfbench.calibrate --control`` reads
it for many: ``python -m pytest -m cuda rfbench/tests/test_rfbench_control.py``.
"""

import time

import pytest

from rfbench import registry
from rfbench.reference.model import Precision
from rfbench.run import run_cell
from rfbench_tiny import tiny_cell

CELLS = ['v1-base.render', 'v1.1-swin-large.render', 'v1.1-swin-large.train']


def fails_its_limits(readings, limits):
    return any(readings[k] > limits[k] for k in limits)


def check(cell, seed, seconds, device):
    controls = [Precision(**c) for c in cell.limits['controls']]
    if device == 'cpu':
        # the CPU has no TF32: there a control whose view stage is lowered to
        # TF32 alone reads as the program does
        controls = [c for c in controls if not c.tf32 or 'fp8' in (c.encoder, c.view)]
    assert controls
    out = run_cell(cell, seed, seconds, False, device=device, t_start=time.perf_counter(),
                   controls=tuple(controls))
    limits = cell.limits['limits']
    assert out['result']['correct'], out['result']['checks']
    for c in controls:
        assert fails_its_limits(out['controls'][c], limits), (c.name, out['controls'][c])


@pytest.mark.parametrize('name', CELLS)
def test_control_fails_at_a_tiny_size(name):
    check(tiny_cell(name), 21, 0.3, 'cpu')


@pytest.mark.cuda
@pytest.mark.parametrize('name', CELLS)
def test_control_fails_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the cell runs at its own size on the card')
    check(registry.load(name), 2**31 + 101, 3.0, 'cuda')
