"""The recorded end-to-end golden through the port: full-size v1-base with
the JAX package's key(0) weights, carried across by convert.py, rendered
by the port on the CPU in fp32 at 128^2 on tools/record_golden.py's scene,
held to tests/test_golden_recorded.py's bars.  Slow tier: one 205M-parameter
JAX init and one full-size fp32 CPU render."""

import os
import sys

import numpy as np
import pytest

GOLDEN = os.path.join(os.path.dirname(__file__), 'data', 'golden_e2e_v1base.npz')


@pytest.mark.slow
def test_port_matches_recorded_golden():
    import jax
    import torch

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from renderformer_tpu.config import V1_BASE as JAX_V1_BASE
    from renderformer_tpu.models.renderformer import RenderFormer as JaxRenderFormer
    from renderformer_tpu_torch import V1_BASE, RenderingPipeline
    from renderformer_tpu_torch.convert import jax_params_to_state_dict
    from renderformer_tpu_torch.models.renderformer import RenderFormer
    from tools.record_golden import golden_scene

    rec = np.load(GOLDEN)
    params = jax.tree.map(np.asarray, JaxRenderFormer(JAX_V1_BASE).init(jax.random.key(0)))
    model = RenderFormer(V1_BASE)
    model.load_state_dict(jax_params_to_state_dict(params))
    del params
    pipe = RenderingPipeline(model, device='cpu')
    s = golden_scene()
    img = pipe.render(s['triangles'], s['texture'], s['mask'], s['vn'], s['c2w'],
                      s['fov'], resolution=int(rec['resolution']), precision='fp32',
                      view_precision='fp32')
    assert isinstance(img, torch.Tensor)
    img = img.numpy()
    ds = img[:, :, ::4, ::4, :].astype(np.float32)
    want = rec['downsampled']
    assert ds.shape == want.shape, (ds.shape, want.shape)
    mse = float(np.mean((ds - want) ** 2))
    peak = float(max(want.max() - want.min(), 1e-9))
    psnr = 10 * np.log10(peak ** 2 / max(mse, 1e-20))
    assert psnr > 55.0, f'recorded-golden PSNR {psnr:.1f} dB'
    np.testing.assert_allclose(float(img.mean()), float(rec['mean']), rtol=2e-3)
    np.testing.assert_allclose(float(img.std()), float(rec['std']), rtol=5e-3)
