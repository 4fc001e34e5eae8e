"""The port's render_many, the video path: K camera chunks of one scene,
against stacked render and against the JAX package's render_many, at the
tiny config on the CPU."""

import jax
import numpy as np
import pytest
import torch

from renderformer_tpu.config import RenderFormerConfig as JaxConfig
from renderformer_tpu.pipelines.rendering_pipeline import RenderingPipeline as JaxPipeline
from renderformer_tpu_torch import RenderFormerConfig, RenderingPipeline
from renderformer_tpu_torch.convert import jax_params_to_state_dict
from renderformer_tpu_torch.models.renderformer import RenderFormer
from renderformer_tpu_torch.pipelines import rendering_pipeline as rp

TINY = dict(latent_dim=72, num_layers=1, num_heads=2, dim_feedforward=144,
            num_register_tokens=4, vertex_pe_num_freqs=4,
            view_transformer_latent_dim=72, view_transformer_ffn_hidden_dim=144,
            view_transformer_n_heads=2, view_transformer_n_layers=4,
            dpt_features=16, dpt_out_channels=[8, 16, 32, 64])
RES, N, V, K = 32, 16, 2, 3


def _scene():
    """tests/test_render_many.py's scene, with emitters and masked rows."""
    rng = np.random.default_rng(0)
    tris = rng.normal(size=(1, N, 3, 3)).astype(np.float32) * 0.3
    tex = rng.uniform(0, 1, (1, N, 13, 32, 32)).astype(np.float32)
    tex[0, :2, 10:] *= 20.0
    mask = np.ones((1, N), bool)
    mask[0, -3:] = False
    vn = rng.normal(size=(1, N, 3, 3)).astype(np.float32)
    c2w = np.tile(np.eye(4, dtype=np.float32), (K, 1, V, 1, 1))
    c2w[..., 2, 3] = 2.0
    c2w[..., 0, 3] = np.linspace(-0.2, 0.2, K)[:, None, None]
    fov = np.full((K, 1, V, 1), 40.0, np.float32)
    fov[:, 0, 1] = 50.0
    return tris, tex, mask, vn, c2w, fov


@pytest.fixture(scope='module')
def pipes():
    jp = JaxPipeline.from_config(JaxConfig(**TINY), seed=0)
    model = RenderFormer(RenderFormerConfig(**TINY))
    model.load_state_dict(jax_params_to_state_dict(jax.tree.map(np.asarray, jp.params)))
    return jp, RenderingPipeline(model, device='cpu')


def test_render_many_matches_stacked_render(pipes):
    _, pipe = pipes
    tris, tex, mask, vn, c2w, fov = _scene()
    many = pipe.render_many(tris, tex, mask, vn, c2w, fov, resolution=RES, precision='fp32')
    assert isinstance(many, torch.Tensor) and many.shape == (K, 1, V, RES, RES, 3)
    assert many.dtype == torch.float32
    for i in range(K):
        one = pipe.render(tris, tex, mask, vn, c2w[i], fov[i], resolution=RES, precision='fp32')
        np.testing.assert_allclose(many[i].numpy(), one.numpy(), rtol=2e-4, atol=2e-5)


def test_render_many_matches_jax_render_many(pipes):
    jp, pipe = pipes
    scene = _scene()
    got = pipe.render_many(*scene, resolution=RES, precision='fp32').numpy()
    want = np.asarray(jp.render_many(*scene, resolution=RES, precision='fp32'))
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 1e-4


@pytest.mark.parametrize('output_dtype', ['float16', 'bfloat16'])
def test_render_many_output_dtype_as_render(pipes, output_dtype):
    _, pipe = pipes
    tris, tex, mask, vn, c2w, fov = _scene()
    tex = tex.copy()
    tex[0, 0, 10:] = 1e6  # an emitter above the float16 maximum
    many = pipe.render_many(tris, tex, mask, vn, c2w, fov, resolution=RES, precision='bf16',
                            output_dtype=output_dtype)
    assert many.dtype == getattr(torch, output_dtype)
    assert torch.isfinite(many).all()
    one = pipe.render(tris, tex, mask, vn, c2w[1], fov[1], resolution=RES, precision='bf16',
                      output_dtype=output_dtype)
    torch.testing.assert_close(many[1].float(), one.float(), rtol=2e-2, atol=2e-3)


def test_render_many_encodes_the_texture_once(pipes, monkeypatch):
    _, pipe = pipes
    calls = []

    def counting(tex):
        calls.append(tex.shape)
        return real(tex)

    real = rp.hdr_encode_texture
    monkeypatch.setattr(rp, 'hdr_encode_texture', counting)
    pipe.render_many(*_scene(), resolution=RES, precision='fp32')
    assert calls == [(1, N, 13, 32, 32)]
    pipe.render(*[x[0] if i >= 4 else x for i, x in enumerate(_scene())],
                resolution=RES, precision='fp32')
    assert len(calls) == 2


def test_render_many_takes_the_scene_as_it_lies_on_the_device(pipes):
    _, pipe = pipes
    tris, tex, mask, vn, c2w, fov = (torch.from_numpy(x) for x in _scene())
    for x, dt in ((tris, torch.float32), (mask, torch.bool)):
        assert pipe._arg(x, dt) is x
    many = pipe.render_many(tris, tex, mask, vn, c2w, fov, resolution=RES, precision='fp32')
    np.testing.assert_array_equal(
        many.numpy(), pipe.render_many(*_scene(), resolution=RES, precision='fp32').numpy())
