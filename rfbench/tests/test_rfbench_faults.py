"""A run with the timed path broken underneath has to come out not correct.

Each test drives the rest of a run (set-up, window, comparison against the
reference with the cell's own limits) on the CPU at a tiny size, skipping
only the look for a card, once sound and once with each fault a cell can
have (``rfbench/faults.py``)."""

import contextlib
import time

import pytest

from rfbench import faults
from rfbench.run import run_cell
from rfbench_tiny import tiny_cell

CASES = [('v1-base.render', None), ('v1-base.render', 'altered_image'),
         ('v1.1-swin-large.render', 'altered_image'),
         ('v1.1-swin-large.train', None), ('v1.1-swin-large.train', 'unchanged_state'),
         ('v1.1-swin-large.train', 'half_batch'), ('v1.1-swin-large.train', 'altered_gradient')]


@pytest.mark.parametrize('cell,fault', CASES)
def test_correct_comes_out_false_under_each_fault(cell, fault):
    with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
        out = run_cell(tiny_cell(cell), 11, 1.5, False, device='cpu',
                       t_start=time.perf_counter())
    res = out['result']
    assert res['correct'] is (fault is None), res['checks']
    assert res['attempted'] >= 2 and res['failed'] == 0
    assert list(res)[-1] == 'checks'
    assert set(res['metrics']) == {'setup_s', 'train_rays_per_s'} if 'train' in cell else \
        set(res['metrics']) == {'setup_s', 'render_rays_per_s', 'render_p95_ms'}


def test_traced_run_reports_per_layer_metrics():
    out = run_cell(tiny_cell('v1.1-swin-large.render'), 12, 1.5, True, device='cpu',
                   t_start=time.perf_counter())
    res = out['result']
    assert res['correct']
    # the CPU has no device trace: only the window's metrics read something
    assert set(res['metrics']) == {'mfu.render'}
    assert res['device']['window_s'] > 0 and 'breakdown' in res
