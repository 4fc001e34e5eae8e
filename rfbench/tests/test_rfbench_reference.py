"""The plain reference against the port's CPU path, both in float32 on a tiny
preset: the same function, so only summation order separates them.  (The
test may import both; the reference imports nothing of the port.)"""

import dataclasses

import numpy as np
import pytest
import torch

from rfbench import scenes
from rfbench.drivers.train import Driver as TrainDriver
from rfbench.reference import model as ref
from rfbench.reference import train as train_ref
from rfbench.weights import make_weights
from rfbench_tiny import tiny_cell


def port_pipeline(cfg, weights):
    from renderformer_tpu_torch import RenderingPipeline, RuntimeConfig
    from renderformer_tpu_torch.config import RenderFormerConfig
    from renderformer_tpu_torch.models.renderformer import RenderFormer
    with torch.device('meta'):
        model = RenderFormer(RenderFormerConfig.from_dict(cfg))
    model.load_state_dict(weights, strict=True, assign=True)
    return RenderingPipeline(model, RuntimeConfig(compute_dtype='float32', view_dtype='float32'),
                             device='cpu')


@pytest.mark.parametrize('cell', ['v1-base.render', 'v1.1-swin-large.render'])
def test_render_matches_the_port(cell):
    c = tiny_cell(cell)
    weights = make_weights(c.model, 7, 'cpu')
    pipe = port_pipeline(c.model, weights)
    scene = scenes.render_scene(7, c.mix, 0, c.mix['triangles'][1])
    c2w, fov = scenes.request_cameras(7, c.mix, 1)
    res = c.mix['resolution']
    got = pipe.render(scene['triangles'], scene['texture'], scene['mask'], scene['vn'], c2w[0],
                      fov[0], resolution=res)[0]
    t = lambda x: torch.as_tensor(x[0])  # noqa: E731
    want = ref.render(c.model, weights, t(scene['triangles']), t(scene['texture']),
                      t(scene['mask']), t(scene['vn']), t(c2w[0]), t(fov[0])[:, 0], res)
    assert got.shape == want.shape == (c.mix['views'], res, res, 3)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)
    assert float(want.std()) > 1e-3      # not a flat image


def test_padded_triangles_change_nothing():
    """A masked tail of triangles leaves the reference's image as it was."""
    c = tiny_cell('v1-base.render')
    weights = make_weights(c.model, 3, 'cpu')
    scene = scenes.render_scene(3, c.mix, 0, c.mix['triangles'][0])
    c2w, fov = scenes.request_cameras(3, c.mix, 1)
    t = lambda x: torch.as_tensor(x[0])  # noqa: E731
    args = [t(scene['triangles']), t(scene['texture']), t(scene['mask']), t(scene['vn'])]
    pad = [torch.cat([a, torch.full_like(a[:5], 9.0 if a.dtype != torch.bool else 0)])
           for a in args]
    cams = (t(c2w[0]), t(fov[0])[:, 0])
    a = ref.render(c.model, weights, *args, *cams, 64)
    b = ref.render(c.model, weights, *pad, *cams, 64)
    assert torch.allclose(a, b, rtol=1e-5, atol=1e-6)


def test_train_steps_match_the_port():
    """Three of the port's float32 train steps against the reference's:
    losses, each leaf's first gradient and each leaf's change."""
    c = tiny_cell('v1.1-swin-large.train')
    c = dataclasses.replace(c, mix=dict(c.mix, precision='float32', view_precision='float32'))
    drv = TrainDriver(c, 5, 'cpu')
    drv.setup()
    want = drv.reference(ref.FP32)
    np.testing.assert_allclose(drv.checked['losses'], want['losses'], rtol=1e-5)
    np.testing.assert_allclose(drv.checked['norms'], want['norms'], rtol=1e-4)
    readings, _ = drv.readings(drv.checked, want)
    assert readings['grad_gap'] < 1e-4 and readings['change_gap'] < 1e-3, readings
    assert readings['view_grad_gap'] < 1e-4 and readings['stage1_gap'] < 1e-5, readings


def test_view_stage_alone_is_the_whole_steps_view_stage():
    """The reference's view stage fed its own stage-1 tokens gives the view
    leaves the gradients of the whole step (before the clip)."""
    c = tiny_cell('v1.1-swin-large.train')
    batch = {k: torch.as_tensor(v) for k, v in scenes.train_pool(8, c.mix)[0].items()
             if k != 'real'}
    weights = make_weights(c.model, 8, 'cpu')
    model = ref.Model(c.model, weights)
    ps = c.model['texture_encode_patch_size']
    tex = batch['texture_flat'][0][:, :, None, None] * train_ref.patch_mask(ps, 'cpu')
    n = batch['mask'].shape[1]
    with torch.no_grad():
        ctx, _ = model.encode_scene(batch['triangles'][0].reshape(1, n, 9), tex[None],
                                    batch['mask'], batch['vn'][0].reshape(1, n, 9))
    alone = train_ref.view_grads(c.model, weights, batch, ctx, c.mix)
    whole = train_ref.run(c.model, make_weights(c.model, 8, 'cpu'), [batch], c.mix)
    scale = min(1.0, c.mix['max_grad_norm'] / whole['norms'][0])
    assert alone and set(alone) < set(whole['grad'])
    for name, norm in alone.items():
        assert norm * scale == pytest.approx(whole['grad'][name], rel=1e-4, abs=1e-9), name


def test_weights_are_the_seeds():
    cfg = tiny_cell('v1-base.render').model
    a, b, c = (make_weights(cfg, s, 'cpu') for s in (2**31 + 5, 2**31 + 5, 6))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a['tri_token'], c['tri_token'])
    assert torch.equal(a['transformer.rope_emb.freqs'], c['transformer.rope_emb.freqs'])
    w = a['transformer.layers.0.ffn.w1.weight']
    assert float(w.abs().max()) <= 1 / np.sqrt(w.shape[1])


def test_lower_precision_reference_departs_further():
    """The controls' roundings move the reference; bf16 less than fp8."""
    c = tiny_cell('v1-base.render')
    weights = make_weights(c.model, 4, 'cpu')
    scene = scenes.render_scene(4, c.mix, 0, c.mix['triangles'][2])
    c2w, fov = scenes.request_cameras(4, c.mix, 1)
    t = lambda x: torch.as_tensor(x[0])  # noqa: E731
    args = (t(scene['triangles']), t(scene['texture']), t(scene['mask']), t(scene['vn']),
            t(c2w[0]), t(fov[0])[:, 0], 64)
    y = {p: torch.log10(ref.render(c.model, weights, *args, precision=p) + 1)
         for p in (ref.FP32, ref.Precision('bf16', 'bf16'), ref.Precision('fp8', 'fp8'))}
    gap = {p.name: float((v - y[ref.FP32]).pow(2).mean().sqrt()) for p, v in y.items()}
    assert 0 < gap['encoder_bf16.view_bf16'] * 4 < gap['encoder_fp8.view_fp8'], gap
