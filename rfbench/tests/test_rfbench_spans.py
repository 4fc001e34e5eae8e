"""The readers of the program's spans and counter (``metrics/device_ms.py``,
``metrics/idle_ms.py``, ``metrics/upload_mb.py``) on small synthetic traces:
inside and outside idle, overlapping spans counted once, a launch or a span
of another thread left out, and None where there is nothing to read."""

import importlib.util
import os
import types

import pytest

from rfbench import registry
from rfbench.trace import TAIL, Trace

MAIN, OTHER = 1, 2
NEW = {'device_ms.render.stage1': 'rf.model.encoder', 'device_ms.render.dpt': 'rf.model.dpt',
       'idle_ms.render.upload': 'rf.render.upload', 'idle_ms.render.client': 'rf.render',
       'idle_ms.train.forward': 'rf.train.forward',
       'idle_ms.train.backward': 'rf.train.backward',
       'idle_ms.train.optimizer': 'rf.train.optimizer'}


def family(name):
    path = os.path.join(registry.ROOT, 'rfbench', 'metrics', f'{name}.py')
    spec = importlib.util.spec_from_file_location(f'rfbench.metrics.{name}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def event(cat, ts, dur, corr):
    return {'cat': cat, 'name': cat, 'ts': ts, 'dur': dur, 'args': {'correlation': corr}}


def synthetic(ranges, records=2):
    """A tail of 100 us on the main thread: kernels at 20-30 (launched at 15),
    38-45 (at 35), 56-61 (at 55, from another thread); a copy at 12-16
    (launched at 11).  Busy 26 us, idle 74 us."""
    device = [event('kernel', 20, 10, 1), event('kernel', 38, 7, 2),
              event('kernel', 56, 5, 3), event('gpu_memcpy', 12, 4, 4)]
    launch_at = {1: (15, MAIN), 2: (35, MAIN), 3: (55, OTHER), 4: (11, MAIN)}
    trace = Trace(0.0, 100.0, device, [], dict(ranges, **{TAIL: [(0.0, 100.0, MAIN)]}),
                  launch_at)
    return types.SimpleNamespace(trace=trace, tail={'records': [{}] * records})


SPANS = {'rf.a': [(10.0, 30.0, MAIN), (20.0, 40.0, MAIN)],   # overlap: their union is 10-40
         'rf.in_a': [(14.0, 16.0, MAIN)],                    # nested in rf.a
         'rf.b': [(50.0, 60.0, OTHER)],                      # another thread's
         'rf.c': [(52.0, 70.0, MAIN)]}


def test_device_ms_counts_kernels_launched_inside_once():
    read = family('device_ms')
    run = synthetic(SPANS)
    # kernels 1 and 2 (10 + 7 us); the copy launched at 11 is no kernel
    assert read(run, spans=['rf.a']) == pytest.approx(17e-3 / 2)
    # nested spans: kernel 1 once
    assert read(run, spans=['rf.a', 'rf.in_a']) == pytest.approx(17e-3 / 2)
    assert read(run, spans=['rf.in_a']) == pytest.approx(10e-3 / 2)
    # kernel 3 was launched from another thread, inside rf.c's time
    assert read(run, spans=['rf.c']) == 0.0


def test_idle_ms_inside_and_outside_the_spans():
    read = family('idle_ms')
    run = synthetic(SPANS)
    # 10-40: 30 us, busy 12-16, 20-30, 38-40 = 16 us
    assert read(run, spans=['rf.a']) == pytest.approx(14e-3 / 2)
    assert read(run, spans=['rf.a', 'rf.in_a']) == pytest.approx(14e-3 / 2)
    # 70 us outside, busy 40-45 and 56-61 there
    assert read(run, spans=['rf.a'], outside=True) == pytest.approx(60e-3 / 2)
    # inside and outside add up to the tail's idle
    both = read(run, spans=['rf.a', 'rf.c']) + read(run, spans=['rf.a', 'rf.c'], outside=True)
    assert both == pytest.approx(74e-3 / 2)
    # rf.c: 52-70, busy 56-61
    assert read(run, spans=['rf.c']) == pytest.approx(13e-3 / 2)


def test_spans_clipped_to_the_tail():
    read = family('idle_ms')
    run = synthetic({'rf.long': [(-50.0, 20.0, MAIN)]})
    # 0-20, busy 12-16
    assert read(run, spans=['rf.long']) == pytest.approx(16e-3 / 2)


@pytest.mark.parametrize('name', ['device_ms', 'idle_ms'])
def test_nothing_to_read_is_none(name):
    read = family(name)
    assert read(synthetic(SPANS), spans=['rf.missing']) is None
    assert read(synthetic(SPANS), spans=['rf.b']) is None       # on another thread only
    assert read(synthetic(SPANS, records=0), spans=['rf.a']) is None
    assert read(types.SimpleNamespace(trace=None, tail=None), spans=['rf.a']) is None
    if name == 'idle_ms':
        assert read(synthetic(SPANS), spans=['rf.missing'], outside=True) is None


def test_the_new_metrics_read_their_spans_and_nothing_without_them():
    """Each metric's own span list: a value from a trace with the program's
    spans, None from a trace of a program that sets none (the parent's)."""
    for metric, span in NEW.items():
        read = registry.reader(metric)
        assert read(synthetic({})) is None, metric
        value = read(synthetic({span: [(10.0, 40.0, MAIN)]}))
        assert value is not None and value >= 0.0, metric


def test_upload_mb_reads_the_pipelines_counter(monkeypatch):
    from renderformer_tpu_torch.pipelines import rendering_pipeline as rp
    read = registry.reader('upload_mb.render')
    monkeypatch.setattr(rp, 'UPLOADS', {'renders': 4, 'bytes': 600_000_000})
    assert read(None) == pytest.approx(150.0)
    monkeypatch.setattr(rp, 'UPLOADS', {'renders': 4, 'bytes': 0})
    assert read(None) is None
    monkeypatch.setattr(rp, 'UPLOADS', {'renders': 0, 'bytes': 0})
    assert read(None) is None
    monkeypatch.delattr(rp, 'UPLOADS')
    assert read(None) is None
