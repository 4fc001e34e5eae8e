"""What the benchmark loads: never JAX or the JAX package, compared by
whole top-level names; the reference nothing of the program either."""

import ast
import glob
import json
import os
import subprocess
import sys

from rfbench import registry, run

ROOT = registry.ROOT
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'renderformer_tpu'}
REFERENCE_MAY_IMPORT = {'__future__', 'contextlib', 'dataclasses', 'math', 'typing', 'numpy',
                        'torch', 'rfbench'}


def loaded_after(code: str) -> set:
    """Top-level names of the modules a fresh interpreter holds after ``code``."""
    out = subprocess.run(
        [sys.executable, '-c', code + '\nimport sys, json\n'
         'print(json.dumps(sorted({m.split(".")[0] for m in list(sys.modules)})))'],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_harness_loads_no_jax():
    metrics = [m[:-3] for m in map(os.path.basename,
                                   glob.glob(os.path.join(ROOT, 'rfbench', 'metrics', '*.py')))]
    code = ('import rfbench.run, rfbench.calibrate, rfbench.faults, rfbench.drivers.render, '
            'rfbench.drivers.train\nfrom rfbench import registry\n'
            + ''.join(f'registry.reader({m!r})\n' for m in metrics)
            + 'import renderformer_tpu_torch.training.state, '
              'renderformer_tpu_torch.pipelines.rendering_pipeline')
    names = loaded_after(code)
    assert 'renderformer_tpu_torch' in names
    assert not names & FORBIDDEN


def test_a_run_loads_no_jax():
    """A whole run of a tiny render cell on the CPU, in a fresh process."""
    code = ('import sys, time; sys.path.insert(0, "rfbench/tests")\n'
            'from rfbench_tiny import tiny_cell\nfrom rfbench.run import run_cell\n'
            'out = run_cell(tiny_cell("v1-base.render"), 3, 0.3, True, device="cpu", '
            't_start=time.perf_counter())\nassert out["result"]["correct"]')
    names = loaded_after(code)
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_after('import rfbench.reference.model, rfbench.reference.train, '
                         'rfbench.weights, rfbench.counts, rfbench.scenes')
    assert 'renderformer_tpu_torch' not in names and not names & FORBIDDEN
    for path in glob.glob(os.path.join(ROOT, 'rfbench', 'reference', '*.py')):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split('.')[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or '').split('.')[0]}
            else:
                continue
            assert tops <= REFERENCE_MAY_IMPORT, (path, tops)


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, 'renderformer_tpu_torch_extra', sys)
    monkeypatch.setitem(sys.modules, 'jaxtyping', sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, 'jax.numpy', sys)
    monkeypatch.setitem(sys.modules, 'renderformer_tpu', sys)
    assert run.forbidden_modules() == ['jax', 'renderformer_tpu']


def test_no_card_no_result(capsys):
    """Without the cell's CUDA devices the command exits non-zero and prints
    no result line."""
    import torch
    if torch.cuda.is_available():
        return
    assert run.main(['--workload', 'v1-base.render', '--seed', '1', '--seconds', '1']) == 2
    assert capsys.readouterr().out == ''
