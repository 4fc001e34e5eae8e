"""The whole slice at a tiny config: the port's RenderingPipeline on the CPU
against the JAX RenderingPipeline, from the same JAX-initialised weights
carried across by convert.py, on the same numpy scene."""

import jax
import numpy as np
import pytest
import torch

from renderformer_tpu import RenderFormerConfig as JaxConfig
from renderformer_tpu import RenderingPipeline as JaxPipeline
from renderformer_tpu_torch import RenderFormerConfig, RenderingPipeline, RuntimeConfig
from renderformer_tpu_torch.convert import jax_params_to_state_dict
from renderformer_tpu_torch.models.renderformer import RenderFormer

TINY = dict(latent_dim=72, num_layers=2, num_heads=2, dim_feedforward=144,
            num_register_tokens=4, vertex_pe_num_freqs=4,
            view_transformer_latent_dim=72, view_transformer_ffn_hidden_dim=144,
            view_transformer_n_heads=2, view_transformer_n_layers=4,
            dpt_features=16, dpt_out_channels=[8, 16, 32, 64])
RES, N, V = 64, 8, 2


def _scene():
    rng = np.random.default_rng(0)
    ang = np.linspace(0, np.pi, V, endpoint=False)
    c2w = np.tile(np.eye(4, dtype=np.float32), (1, V, 1, 1))
    c2w[0, :, 0, 0] = np.cos(ang)
    c2w[0, :, 0, 2] = np.sin(ang)
    c2w[0, :, 2, 0] = -np.sin(ang)
    c2w[0, :, 2, 2] = np.cos(ang)
    c2w[0, :, :3, 3] = np.stack([2 * np.sin(ang), np.zeros(V), 2 * np.cos(ang)], -1)
    mask = np.ones((1, N), bool)
    mask[0, -2:] = False
    tex = rng.uniform(0, 1, (1, N, 13, 32, 32)).astype(np.float32)
    tex[0, :2, 10:] *= 20.0  # emitters, for HDR range
    return (rng.normal(size=(1, N, 3, 3)).astype(np.float32) * 0.3, tex, mask,
            rng.normal(size=(1, N, 3, 3)).astype(np.float32), c2w,
            np.full((1, V, 1), 40.0, np.float32))


def _psnr(ref, x):
    mse = float(np.mean((ref - x) ** 2))
    return 10 * np.log10(float(ref.max() - ref.min()) ** 2 / max(mse, 1e-30))


@pytest.fixture(scope='module')
def renders():
    """JAX renders and port renders, each with the plain and the default
    composed DPT tail, in fp32 and bf16, shared by the tests of this file:
    the JAX compiles dominate."""
    jp = JaxPipeline.from_config(JaxConfig(**TINY), seed=0)
    model = RenderFormer(RenderFormerConfig(**TINY))
    model.load_state_dict(jax_params_to_state_dict(jax.tree.map(np.asarray, jp.params)))
    scene = _scene()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for tail in ('plain', 'composed'):
            mp.setenv('RFTPU_DPT_TAIL', tail)
            for prec in ('fp32', 'bf16'):
                out[('jax', tail, prec)] = np.asarray(
                    jp.render(*scene, resolution=RES, precision=prec))
    for tail in ('plain', 'composed'):
        tp = RenderingPipeline(model, runtime=RuntimeConfig(dpt_tail=tail), device='cpu')
        for prec in ('fp32', 'bf16'):
            img = tp.render(*scene, resolution=RES, precision=prec)
            assert isinstance(img, torch.Tensor) and img.device.type == 'cpu'
            out[('port', tail, prec)] = img.numpy()
    # the port's default tail is the composed one, as the JAX package's
    default = RenderingPipeline(model, device='cpu').render(
        *scene, resolution=RES, precision='fp32').numpy()
    np.testing.assert_array_equal(default, out[('port', 'composed', 'fp32')])
    return out


def test_fp32_matches_jax_plain_tail(renders):
    got, want = renders[('port', 'plain', 'fp32')], renders[('jax', 'plain', 'fp32')]
    assert got.shape == want.shape == (1, V, RES, RES, 3)
    assert np.isfinite(got).all()
    # fp32 end to end; the same function up to summation order
    assert np.abs(got - want).max() <= 1e-4


def test_fp32_against_jax_default_composed_tail(renders):
    got, want = renders[('port', 'composed', 'fp32')], renders[('jax', 'composed', 'fp32')]
    assert np.isfinite(got).all()
    # both composed 5x5 tails: the same function up to summation order
    assert np.abs(got - want).max() <= 1e-4
    # and within the repo's golden bar of the plain tail
    assert _psnr(renders[('jax', 'plain', 'fp32')], got) >= 55.0


@pytest.mark.parametrize('tail', ['plain', 'composed'])
def test_bf16_bounded_by_psnr(renders, tail):
    got = renders[('port', tail, 'bf16')]
    assert np.isfinite(got).all()
    # bf16 rounds at other points in the two frameworks (fused bias adds,
    # online vs one-pass softmax): held to 40 dB, the chip render's bar
    assert _psnr(renders[('jax', tail, 'bf16')], got) >= 40.0
    # and the bf16 render stays near the fp32 one
    assert _psnr(renders[('port', tail, 'fp32')], got) >= 35.0


def test_output_dtype_and_fp16_clamp():
    from renderformer_tpu_torch.nn.core import init_weights
    model = RenderFormer(RenderFormerConfig(**TINY))
    init_weights(model, torch.Generator().manual_seed(0))
    tp = RenderingPipeline(model, device='cpu')
    scene = _scene()
    img32 = tp.render(*scene, resolution=32, precision='fp32')
    img16 = tp.render(*scene, resolution=32, precision='fp32', output_dtype='float16')
    assert img16.dtype == torch.float16
    # float16 output is the fp32 HDR image clamped to [0, 65504], then cast
    assert torch.equal(img16, torch.clamp(img32, 0.0, 65504.0).half())
    img_bf = tp.render(*scene, resolution=32, precision='fp32', output_dtype='bf16')
    assert img_bf.dtype == torch.bfloat16
    assert torch.equal(img_bf, img32.bfloat16())


def test_mixed_stage_dtypes_keep_fp32_masters():
    from renderformer_tpu_torch.nn.core import init_weights
    model = RenderFormer(RenderFormerConfig(**TINY))
    init_weights(model, torch.Generator().manual_seed(1))
    tp = RenderingPipeline(model, device='cpu')
    scene = _scene()
    ref = tp.render(*scene, resolution=32, precision='fp32').numpy()
    for prec, view in (('fp32', 'bf16'), ('bf16', 'fp32')):
        img = tp.render(*scene, resolution=32, precision=prec, view_precision=view)
        assert _psnr(ref, img.numpy()) >= 35.0  # one stage in bf16
    # the fp32 master weights are untouched by the casts
    assert all(p.dtype == torch.float32 for p in tp.model.parameters())
    np.testing.assert_array_equal(
        tp.render(*scene, resolution=32, precision='fp32').numpy(), ref)
