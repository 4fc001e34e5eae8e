"""The port's Swin path against the JAX package on the CPU: window helpers,
the plain versions of kernels K6 (window attention) and K7 (shifted-window
regroup) against the JAX Pallas kernels in interpret mode, the Swin
attention module, the weight bridge, and a tiny Swin render end to end."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderformer_tpu import RenderFormerConfig as JaxConfig
from renderformer_tpu import RenderingPipeline as JaxPipeline
from renderformer_tpu.config import V1_1_SWIN_LARGE as JAX_SWIN_LARGE
from renderformer_tpu.models.renderformer import RenderFormer as JaxRenderFormer
from renderformer_tpu.nn import attention as jattn
from renderformer_tpu.ops.shifted_regroup import _window_table, shifted_regroup_kernel
from renderformer_tpu.ops.swin_attention import swin_window_attention as jax_swin
from renderformer_tpu_torch import RenderFormerConfig, RenderingPipeline, V1_1_SWIN_LARGE
from renderformer_tpu_torch.convert import (
    jax_params_to_state_dict, state_dict_to_jax_params)
from renderformer_tpu_torch.models.renderformer import RenderFormer
from renderformer_tpu_torch.nn import swin
from renderformer_tpu_torch.nn.attention import SwinSelfAttention, TransformerDecoder
from renderformer_tpu_torch.ops.shifted_regroup import (
    regroup_index, shifted_regroup, window_table)
from renderformer_tpu_torch.ops.swin_attention import region_table, swin_window_attention

SWIN_LARGE_PARAMS = 483_472_079

TINY_SWIN = dict(latent_dim=72, num_layers=1, num_heads=2, dim_feedforward=144,
                 num_register_tokens=4, vertex_pe_num_freqs=4,
                 view_transformer_latent_dim=72, view_transformer_ffn_hidden_dim=144,
                 view_transformer_n_heads=2, view_transformer_n_layers=4,
                 view_transformer_use_swin_attn=True,
                 dpt_features=16, dpt_out_channels=[8, 16, 32, 64])
RES, N, V = 128, 8, 2  # a 16x16 patch grid: 2x2 windows of 8x8 tokens

REGROUP_SHAPES = [  # (h, w, ws, b, c)
    (16, 16, 8, 2, 16),   # 2x2 window grid: every quadrant wraps
    (32, 32, 8, 1, 8),
    (64, 64, 8, 2, 4),    # the 512^2 grid
    (16, 32, 8, 1, 8),    # non-square
    (8, 8, 4, 2, 8),      # 4x4 windows, shift 2
]


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


@pytest.mark.parametrize('h,w,ws', [(16, 16, 8), (16, 32, 8), (8, 8, 4)])
def test_window_helpers_match_jax(h, w, ws):
    rng = np.random.default_rng(h + w)
    x = rng.normal(size=(2, h * w, 6)).astype(np.float32)
    t = torch.from_numpy(x)
    got = swin.seq_to_window_order(t, h, w, ws)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jattn.seq_to_window_order(jnp.asarray(x), h, w, ws)))
    np.testing.assert_array_equal(swin.seq_from_window_order(got, h, w, ws).numpy(), x)
    np.testing.assert_array_equal(swin.window_order_indices(h, w, ws),
                                  jattn.window_order_indices(h, w, ws))
    np.testing.assert_array_equal(got.numpy(), x[:, swin.window_order_indices(h, w, ws)])
    img = t.reshape(2, h, w, 6)
    np.testing.assert_array_equal(
        swin.window_reverse(swin.window_partition(img, ws), ws, h, w).numpy(), img.numpy())
    np.testing.assert_array_equal(swin.swin_attn_mask(h, w, ws, ws // 2),
                                  jattn.swin_attn_mask(h, w, ws, ws // 2))


@pytest.mark.parametrize('h,w,ws,b,c', REGROUP_SHAPES)
@pytest.mark.parametrize('inverse', [False, True])
def test_regroup_plain_matches_jax_kernel(h, w, ws, b, c, inverse):
    x = np.random.default_rng(0).normal(size=(b, h * w, c)).astype(np.float32)
    got = shifted_regroup(torch.from_numpy(x), (h, w), ws, inverse=inverse)
    want = shifted_regroup_kernel(jnp.asarray(x), (h, w), ws, inverse, True)
    # a permutation: equal exactly
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(window_table(h // ws, w // ws, inverse),
                                  _window_table(h // ws, w // ws, inverse))


@pytest.mark.parametrize('h,w,ws,b,c', REGROUP_SHAPES)
@pytest.mark.parametrize('inverse', [False, True])
def test_regroup_index_gathers_the_regroup(h, w, ws, b, c, inverse):
    x = np.random.default_rng(2).normal(size=(b, h * w, c)).astype(np.float32)
    idx = regroup_index(h, w, ws, inverse)
    assert idx.dtype == np.int64 and np.array_equal(np.sort(idx), np.arange(h * w))
    want = shifted_regroup(torch.from_numpy(x), (h, w), ws, inverse=inverse)
    # a permutation: equal exactly
    got = torch.from_numpy(x).index_select(1, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_regroup_round_trip_and_refusals():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 256, 8)).astype(np.float32))
    y = shifted_regroup(x, (16, 16), 8)
    assert torch.equal(shifted_regroup(y, (16, 16), 8, inverse=True), x)
    assert not torch.equal(y, x)
    with pytest.raises(ValueError):
        shifted_regroup(x, (16, 12), 8)        # not whole windows
    with pytest.raises(ValueError):
        shifted_regroup(x[:, :200], (16, 16), 8)


def _swin_inputs(dtype, seed=0, b=2, h=16, w=16, c=256):
    rng = np.random.default_rng(seed)
    bw = b * (h // 8) * (w // 8)
    return [rng.normal(size=(bw, 64, c)).astype(np.float32).astype(dtype)
            for _ in range(3)]


@pytest.mark.parametrize('shift', [0, 4])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_swin_attention_plain_matches_jax_kernel(shift, dtype):
    """2 views x a 16x16 grid (4 windows each), C = 256 = 2 heads of 128
    (the JAX kernel's head dim)."""
    h = w = 16
    jdt = jnp.float32 if dtype == 'float32' else jnp.bfloat16
    tdt = torch.float32 if dtype == 'float32' else torch.bfloat16
    q, k, v = (jnp.asarray(a, jdt) for a in _swin_inputs(np.float32, seed=shift))
    want = jax_swin(q, k, v, n_windows=4, grid_hw=(h, w), window_size=8,
                    shift_size=shift, interpret=True)
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
                  for a in (q, k, v))
    regions = region_table(h, w, 8, shift, torch.device('cpu')) if shift else None
    got = swin_window_attention(tq, tk, tv, num_heads=2, regions=regions)
    assert got.dtype == tdt and got.shape == tq.shape
    want, got = _np(want), _np(got)
    amax = np.abs(want).max()
    if dtype == 'float32':
        # same fp32 arithmetic, the products summed in another order
        np.testing.assert_allclose(got, want, atol=2.0 ** -16 * amax, rtol=0)
    else:
        # q and P round to bf16 in both; the sums of e and P.V may round to
        # a neighbouring bf16 value: 4 bf16 ulps of max|ref|, as on the card
        np.testing.assert_allclose(got, want, atol=4 * 2.0 ** -8 * amax, rtol=0)
    if shift:
        # the mask matters: unshifted attention differs
        plain = swin_window_attention(tq, tk, tv, num_heads=2)
        assert np.abs(_np(plain) - got).max() > 10 * 2.0 ** -8 * amax


def test_swin_attention_plain_any_head_dim():
    """The plain version takes any head dim; it equals masked SDPA."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(8, 64, 72)).astype(np.float32))
               for _ in range(3))
    regions = region_table(16, 16, 8, 4, torch.device('cpu'))
    got = swin_window_attention(q, k, v, num_heads=2, regions=regions)
    mask = torch.from_numpy(swin.swin_attn_mask(16, 16, 8, 4)).repeat(2, 1, 1)
    qh, kh, vh = (t.reshape(8, 64, 2, 36).transpose(1, 2) for t in (q, k, v))
    want = torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask[:, None]).transpose(1, 2).reshape(8, 64, 72)
    # exp2 with a log2(e)-scaled q vs exp: fp32 rounding only
    torch.testing.assert_close(got, want, atol=2e-6, rtol=0)


@pytest.mark.parametrize('shift', [0, 4])
def test_swin_module_matches_jax(shift):
    """SwinSelfAttention on a window-ordered stream, fp32, weights carried
    across from a JAX init (the XLA windowed-SDPA path on the JAX side)."""
    dim, heads, h, w = 64, 2, 16, 16
    jmod = jattn.SwinSelfAttention(dim=dim, num_heads=heads, window_size=8,
                                   shift_size=shift, qk_norm=True)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.key(shift)))
    x = np.random.default_rng(5).normal(size=(2, h * w, dim)).astype(np.float32)
    want = np.asarray(jmod(params, jnp.asarray(x), impl='xla', grid=(h, w)))
    tmod = SwinSelfAttention(dim, heads, 8, shift, qk_norm=True)
    tmod.load_state_dict(jax_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), (h, w)).numpy()
    # fp32 throughout: summation order and exp2 vs exp
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_decoder_alternates_shifts():
    dec = TransformerDecoder(4, 2, 72, 144, 72, 4, use_swin_attn=True)
    assert [layer.self_attn.shift_size for layer in dec.layers] == [0, 4, 0, 4]
    assert all(isinstance(layer.self_attn, SwinSelfAttention) for layer in dec.layers)


def test_swin_weight_bridge_round_trip():
    tree = jax.tree.map(np.asarray,
                        JaxRenderFormer(JaxConfig(**TINY_SWIN)).init(jax.random.key(0)))
    sd = jax_params_to_state_dict(tree)
    model = RenderFormer(RenderFormerConfig(**TINY_SWIN))
    assert set(sd) == set(model.state_dict())
    assert 'view_transformer.transformer.layers.1.self_attn.in_proj.weight' in sd
    model.load_state_dict(sd, strict=True)
    back = state_dict_to_jax_params(model.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_swin_large_parameter_count_matches_jax():
    shapes = jax.eval_shape(JaxRenderFormer(JAX_SWIN_LARGE).init, jax.random.key(0))
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes)) == SWIN_LARGE_PARAMS
    with torch.device('meta'):
        model = RenderFormer(V1_1_SWIN_LARGE)
    assert sum(t.numel() for t in model.state_dict().values()) == SWIN_LARGE_PARAMS


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
def swin_renders():
    """The tiny Swin render through both packages (default composed DPT
    tail), fp32 and bf16, from one JAX init carried across."""
    jp = JaxPipeline.from_config(JaxConfig(**TINY_SWIN), seed=0)
    model = RenderFormer(RenderFormerConfig(**TINY_SWIN))
    model.load_state_dict(jax_params_to_state_dict(jax.tree.map(np.asarray, jp.params)))
    tp = RenderingPipeline(model, device='cpu')
    scene = _scene()
    out = {}
    for prec in ('fp32', 'bf16'):
        out[('jax', prec)] = np.asarray(jp.render(*scene, resolution=RES, precision=prec))
        out[('port', prec)] = tp.render(*scene, resolution=RES, precision=prec).numpy()
    return out


def test_swin_render_fp32_matches_jax(swin_renders):
    got, want = swin_renders[('port', 'fp32')], swin_renders[('jax', 'fp32')]
    assert got.shape == want.shape == (1, V, RES, RES, 3)
    assert np.isfinite(got).all()
    # fp32 end to end: the same function up to summation order
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_swin_render_bf16_bounded_by_psnr(swin_renders):
    got = swin_renders[('port', 'bf16')]
    assert np.isfinite(got).all()
    # bf16 rounds at other points in the two packages: the chip render's bar
    assert _psnr(swin_renders[('jax', 'bf16')], got) >= 40.0
    assert _psnr(swin_renders[('port', 'fp32')], got) >= 35.0
