"""The port's spans (``utils/profiling.annotate``) and its upload counter, at
the tiny config on the CPU: a render and a train step under
``utils/profiling.trace`` emit their ranges once each and nested as the
profiling docstring says; with no profiler session ``annotate`` enters no
``record_function``; ``RenderingPipeline``'s ``UPLOADS`` counts calls and
the bytes that cross from host memory to the device."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from renderformer_tpu_torch import RenderFormerConfig, RenderingPipeline
from renderformer_tpu_torch.models.renderformer import RenderFormer
from renderformer_tpu_torch.nn.core import init_weights
from renderformer_tpu_torch.pipelines import rendering_pipeline as rp
from renderformer_tpu_torch.training import state as tstate
from renderformer_tpu_torch.utils import profiling
from renderformer_tpu_torch.utils.profiling import annotate, trace

TINY = dict(latent_dim=72, num_layers=1, num_heads=2, dim_feedforward=144,
            num_register_tokens=4, vertex_pe_num_freqs=4,
            view_transformer_latent_dim=72, view_transformer_ffn_hidden_dim=144,
            view_transformer_n_heads=2, view_transformer_n_layers=4,
            dpt_features=16, dpt_out_channels=[8, 16, 32, 64])
RES, N, V = 16, 6, 2
RENDER_SPANS = ('rf.render', 'rf.render.upload', 'rf.model.encoder', 'rf.model.view',
                'rf.model.dpt')
TRAIN_SPANS = ('rf.train.forward', 'rf.train.backward', 'rf.train.optimizer')


def _scene(chunks=0):
    rng = np.random.default_rng(0)
    c2w = np.tile(np.eye(4, dtype=np.float32), (1, V, 1, 1))
    c2w[..., 2, 3] = 2.0
    fov = np.full((1, V, 1), 40.0, np.float32)
    if chunks:
        c2w, fov = np.stack([c2w] * chunks), np.stack([fov] * chunks)
    return (rng.normal(size=(1, N, 3, 3)).astype(np.float32) * 0.3,
            rng.uniform(0, 1, (1, N, 13, 32, 32)).astype(np.float32),
            np.ones((1, N), bool), rng.normal(size=(1, N, 3, 3)).astype(np.float32), c2w, fov)


def _model():
    return init_weights(RenderFormer(RenderFormerConfig(**TINY)), torch.Generator().manual_seed(0))


def _ranges(log_dir):
    """{name: [(start, end), ...]} of the rf.* ranges in the one trace file."""
    files = glob.glob(os.path.join(str(log_dir), '*.pt.trace.json'))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)['traceEvents']
    out = {}
    for e in events:
        if e.get('cat') == 'user_annotation' and e['name'].startswith('rf.'):
            out.setdefault(e['name'], []).append((e['ts'], e['ts'] + e['dur']))
    return out


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize('chunks', [0, 2], ids=['render', 'render_many'])
def test_a_render_emits_its_spans_once_each_and_nested(tmp_path, chunks):
    pipe = RenderingPipeline(_model(), device='cpu')
    call = pipe.render_many if chunks else pipe.render
    with trace(str(tmp_path)):
        call(*_scene(chunks), resolution=RES, precision='fp32')
    got = _ranges(tmp_path)
    per_model = max(chunks, 1)
    assert {k: len(v) for k, v in got.items()} == {
        'rf.render': 1, 'rf.render.upload': 1, 'rf.model.encoder': per_model,
        'rf.model.view': per_model, 'rf.model.dpt': per_model}
    whole, upload = got['rf.render'][0], got['rf.render.upload'][0]
    assert _inside(upload, whole)
    for enc, view, dpt in zip(got['rf.model.encoder'], got['rf.model.view'],
                              got['rf.model.dpt']):
        assert _inside(enc, whole) and _inside(view, whole) and _inside(dpt, view)
        assert upload[1] <= enc[0] and enc[1] <= view[0]


def test_a_train_step_emits_forward_backward_and_optimizer(tmp_path):
    model = _model()
    tc = tstate.TrainConfig(precision='float32', view_precision='float32', resolution=RES,
                            steps_per_epoch=2, num_epochs=1, remat=True)
    tx = tstate.make_optimizer(tc)
    state = tstate.TrainState.create(model, tx, tc)
    step = tstate.make_train_step(model, tx, tc)[0]
    tris, tex, mask, vn, c2w, fov = _scene()
    gt = np.random.default_rng(1).uniform(0, 1, (1, V, RES, RES, 3)).astype(np.float32)
    batch = {k: torch.from_numpy(v) for k, v in dict(
        triangles=tris, texture=tex, mask=mask, vn=vn, c2w=c2w, fov=fov, gt=gt).items()}
    with trace(str(tmp_path)):
        _, met = step(state, batch)
    assert np.isfinite(met['loss']) and state.opt_state['count'] == 1
    got = _ranges(tmp_path)
    assert {k: len(got.get(k, ())) for k in TRAIN_SPANS} == dict.fromkeys(TRAIN_SPANS, 1)
    fwd, bwd, opt = (got[k][0] for k in TRAIN_SPANS)
    assert fwd[1] <= bwd[0] and bwd[1] <= opt[0]
    # the model's spans run once, inside the forward; remat recomputes blocks only
    for name in ('rf.model.encoder', 'rf.model.view', 'rf.model.dpt'):
        assert len(got[name]) == 1 and _inside(got[name][0], fwd)


def test_annotate_without_a_session_enters_no_record_function(monkeypatch, tmp_path):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)

    def no_nvtx(*a, **kw):
        raise AssertionError('annotate called NVTX')

    monkeypatch.setattr(torch.profiler, 'record_function', counting)
    monkeypatch.setattr(torch.cuda.nvtx, 'range_push', no_nvtx)
    monkeypatch.setattr(torch.cuda.nvtx, 'range_pop', no_nvtx)
    assert annotate('a') is annotate('b') is profiling._NULL
    with annotate('rf.anything'):
        pass
    pipe = RenderingPipeline(_model(), device='cpu')
    pipe.render(*_scene(), resolution=RES, precision='fp32')
    assert entered == []
    with trace(str(tmp_path)):
        with annotate('rf.inside'):
            pass
        pipe.render(*_scene(), resolution=RES, precision='fp32')
    assert entered[0] == 'rf.inside' and set(RENDER_SPANS) <= set(entered)


def test_the_upload_counter_counts_calls_and_host_bytes(monkeypatch):
    monkeypatch.setattr(rp, 'UPLOADS', {'renders': 0, 'bytes': 0})
    pipe = RenderingPipeline(_model(), device='cpu')
    pipe.render(*_scene(), resolution=RES, precision='fp32')
    pipe.render_many(*_scene(2), resolution=RES, precision='fp32')
    # a pipeline on the CPU moves nothing across
    assert rp.UPLOADS == {'renders': 2, 'bytes': 0}
    # a pipeline on another device: numpy arrays and CPU tensors count their
    # own bytes, before the cast; a tensor already there counts nothing
    far = object.__new__(RenderingPipeline)
    far.device = torch.device('meta')
    assert far._arg(np.zeros((3, 5), np.float64), torch.float32).device.type == 'meta'
    far._arg(torch.zeros(4, 4, dtype=torch.bfloat16), torch.float32)
    far._arg([[1.0, 2.0]], torch.float32)
    far._arg(np.ones((2, 7), bool), torch.bool)
    far._arg(torch.zeros(100, device='meta'), torch.float32)
    assert rp.UPLOADS == {'renders': 2, 'bytes': 3 * 5 * 8 + 4 * 4 * 2 + 2 * 8 + 2 * 7}
