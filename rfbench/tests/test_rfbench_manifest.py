"""BENCHMARK.json against the benchmark's contract, and every part of a cell
found by name, a new one too."""

import json
import math
import os
import re
import shutil
import types

import pytest
import torch

from rfbench import registry
from rfbench.reference.model import param_spec
from rfbench.weights import parameter_count

ROOT = registry.ROOT
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')
KEYS = {
    'top': {'command', 'paths', 'run_seconds', 'configs', 'workloads', 'end_to_end', 'per_layer'},
    'configs': {'name', 'source', 'file', 'reduced', 'why'},
    'workloads': {'name', 'config', 'traffic', 'chips', 'why'},
    'end_to_end': {'name', 'unit', 'better', 'bound', 'source'},
    'per_layer': {'name', 'unit', 'better', 'source', 'layer', 'moves'},
}
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}


def bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_top_level():
    b = bench()
    assert set(b) == KEYS['top']
    assert os.path.getsize(os.path.join(ROOT, 'BENCHMARK.json')) <= 64 * 1024
    assert 1 <= len(b['command']) <= 32 and all(line(w) for w in b['command'])
    assert 1 <= len(b['paths']) <= 16
    for p in b['paths']:
        assert PATH.match(p) and not p.startswith('/') and '..' not in p.split('/')
        assert not p.endswith('_torch') and os.path.isdir(os.path.join(ROOT, p))
    assert isinstance(b['run_seconds'], int) and 1 <= b['run_seconds'] <= 51
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (b['run_seconds'] + 60) + 24 * 180 + 1200 <= 43200


def test_entries_names_units_and_lines():
    b = bench()
    for section in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        names = [e['name'] for e in b[section]]
        assert len(names) == len(set(names)), section
        for e in b[section]:
            allowed = KEYS[section] | ({'workloads'} if section in ('end_to_end', 'per_layer')
                                       else set())
            assert KEYS[section] <= set(e) <= allowed, (section, e['name'])
            assert NAME.match(e['name'])
    for c in b['configs']:
        assert line(c['source']) and line(c['why'])
        assert len(c['reduced']) <= 16 and all(NAME.match(k) for k in c['reduced'])
        assert c['file'].startswith(tuple(p + '/' for p in b['paths']))
    for w in b['workloads']:
        assert NAME.match(w['config']) and NAME.match(w['traffic']) and line(w['why'])
        assert w['chips'] in (1, 4)
    metrics = b['end_to_end'] + b['per_layer']
    assert len({m['name'] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
        assert m['source'] in SOURCES
    for m in b['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    assert [m['bound'] for m in b['end_to_end'] if m['name'] == 'setup_s'] == [0.25]
    e2e = {m['name'] for m in b['end_to_end']}
    for m in b['per_layer']:
        assert line(m['layer']) and m['moves'] in e2e
    four = sum(w['chips'] == 4 for w in b['workloads'])
    assert four <= max(1, len(b['workloads']) // 4)


def test_every_cell_resolves_and_reports_enough():
    b = bench()
    configs = {c['name'] for c in b['configs']}
    used = set()
    for w in b['workloads']:
        assert w['config'] in configs
        used.add(w['config'])
        cell = registry.load(w['name'])
        assert cell.chips == w['chips']
        assert cell.mix['kind'] in ('render', 'train')
        assert hasattr(registry.driver(cell.mix['kind']), 'Driver')
        names = {m['name'] for m in cell.end_to_end}
        assert 'setup_s' in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m['moves'] in names
        assert set(cell.limits['limits']) and all(v > 0 for v in cell.limits['limits'].values())
    assert used == configs
    for m in b['end_to_end'] + b['per_layer']:
        for cell in m.get('workloads', []):
            assert cell in {w['name'] for w in b['workloads']}


def test_every_metric_has_a_reader():
    b = bench()
    for m in b['end_to_end'] + b['per_layer']:
        if m['name'] != 'setup_s':
            assert callable(registry.reader(m['name']))


@pytest.mark.parametrize('name', ['v1-base', 'v1.1-swin-large'])
def test_configuration_is_the_published_model(name):
    """The file's model keys build the port's model with the reference's
    weight names and shapes, and the published parameter count."""
    from renderformer_tpu_torch.config import RenderFormerConfig
    from renderformer_tpu_torch.models.renderformer import RenderFormer
    entry = {c['name']: c for c in bench()['configs']}[name]
    with open(os.path.join(ROOT, entry['file'])) as f:
        doc = json.load(f)
    assert doc['source'] == entry['source'] and doc['reduced'] == entry['reduced'] == []
    assert parameter_count(doc['model']) == doc['parameters']
    with torch.device('meta'):
        model = RenderFormer(RenderFormerConfig.from_dict(doc['model']))
    port = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert port == {k: tuple(s) for k, s, _ in param_spec(doc['model'])}
    assert sum(math.prod(s) for s in port.values()) == doc['parameters']


def test_a_new_cell_mix_and_metric_are_found_without_edits(tmp_path):
    """A copy of the benchmark with a traffic mix, a cell, its limits and a
    metric added as files and entries: the registry finds them all."""
    root = tmp_path / 'checkout'
    shutil.copytree(os.path.join(ROOT, 'rfbench'), root / 'rfbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    b = bench()
    with open(root / 'rfbench' / 'traffic' / 'render.json') as f:
        mix = json.load(f)
    mix['triangles'] = [512, 1024]
    (root / 'rfbench' / 'traffic' / 'render_small.json').write_text(json.dumps(mix))
    with open(root / 'rfbench' / 'workloads' / 'v1-base.render.json') as f:
        limits = json.load(f)
    (root / 'rfbench' / 'workloads' / 'v1-base.render_small.json').write_text(json.dumps(limits))
    (root / 'rfbench' / 'metrics' / 'render_median_ms.py').write_text(
        'def read(run):\n    return 42.0\n')
    b['workloads'].append({'name': 'v1-base.render_small', 'config': 'v1-base',
                           'traffic': 'render_small', 'chips': 1, 'why': 'small scenes'})
    b['per_layer'].append({'name': 'render_median_ms', 'unit': 'ms', 'better': 'lower',
                           'source': 'host_clock', 'layer': 'whole request',
                           'moves': 'render_p95_ms', 'workloads': ['v1-base.render_small']})
    for m in b['end_to_end']:
        if m['name'].startswith('render_'):
            m['workloads'].append('v1-base.render_small')
    (root / 'BENCHMARK.json').write_text(json.dumps(b))
    cell = registry.load('v1-base.render_small', root=str(root))
    assert cell.mix['triangles'] == [512, 1024]
    assert 'render_median_ms' in {m['name'] for m in cell.per_layer}
    assert registry.reader('render_median_ms', root=str(root))(None) == 42.0
    # the cells that were there are as they were
    assert registry.load('v1-base.render', root=str(root)).per_layer == \
        registry.load('v1-base.render').per_layer


def test_a_metric_of_a_family_takes_the_familys_reader(tmp_path):
    """A metric with no file of its own is read by its family's reader with
    its own data file: ``idle.video`` by ``idle.py``, ``attn_roofline.video``
    by ``attn_roofline.py`` with the kernels of ``attn_roofline.video.json``,
    ``video_rays_per_s`` by ``rays_per_s.py``."""
    root = tmp_path / 'checkout'
    shutil.copytree(os.path.join(ROOT, 'rfbench'), root / 'rfbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    (root / 'rfbench' / 'metrics' / 'attn_roofline.video.json').write_text(
        json.dumps({'kernels': ['only_this_kernel']}))

    class Trace:
        busy_s, wall_s, device = 0.25, 1.0, [{}]

        def kernels(self, names):
            assert names == ('only_this_kernel',)
            return [{'dur': 2e6}]

    run = types.SimpleNamespace(
        trace=Trace(), tail={'sites': [[types.SimpleNamespace(least_s=0.5)]]},
        window={'t0': 0.0, 't_end': 2.0, 'records': [{'ok': True, 'rays': 10}]})
    assert registry.family('idle.video') == 'idle'
    assert registry.family('video_rays_per_s') == 'rays_per_s'
    assert registry.reader('idle.video', root=str(root))(run) == 75.0
    assert registry.reader('attn_roofline.video', root=str(root))(run) == 25.0
    assert registry.reader('video_rays_per_s', root=str(root))(run) == 5.0


def test_every_request_draws_its_own_scene():
    """Requests of one size share no contents, so no cache of a scene or of
    an upload can serve one request from another; the same seed and request
    give the same scene, into a reader's buffer too."""
    import numpy as np
    from rfbench import scenes
    mix = registry.load('v1-base.render').mix
    a, b = (scenes.render_scene(9, mix, i, 64) for i in (0, 6))
    buf = np.ones((1, 80, 13, 32, 32), np.float32)
    again = scenes.render_scene(9, mix, 0, 64, out=buf)
    for k in ('triangles', 'texture', 'vn'):
        assert not (a[k] == b[k]).all() and (a[k] == again[k]).all()
    assert np.shares_memory(again['texture'], buf) and again['texture'].flags.c_contiguous
    assert a['texture'].shape == again['texture'].shape == (1, 64, 13, 32, 32)
