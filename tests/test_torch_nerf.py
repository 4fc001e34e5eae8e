"""The ``pe_type='nerf'`` slice at a tiny config on the CPU: the weight bridge
on the nerf parameter tree, the port's fp32 render against the JAX
RenderingPipeline (``impl='xla'``), two fp32 train steps against JAX's
``make_train_step(..., impl='xla')``, and the fused RMSNorm (K11's plain
versions on the CPU) against the torch-op norm, in the render and in a train
step with remat."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderformer_tpu import RenderFormerConfig as JaxConfig
from renderformer_tpu import RenderingPipeline as JaxPipeline
from renderformer_tpu.models.renderformer import RenderFormer as JaxRenderFormer
from renderformer_tpu.training import state as jstate
from renderformer_tpu_torch import (
    V1_BASE, V1_BASE_NERF, RenderFormerConfig, RenderingPipeline, RuntimeConfig)
from renderformer_tpu_torch.convert import jax_params_to_state_dict, state_dict_to_jax_params
from renderformer_tpu_torch.models.renderformer import RenderFormer
from renderformer_tpu_torch.nn.core import init_weights
from renderformer_tpu_torch.ops import fused_norm
from renderformer_tpu_torch.training import state as tstate
from test_torch_convert import _assert_trees_equal
from test_torch_pipeline import _psnr, _scene
from test_torch_train import FP32, LR, _batch, _leaves, _torch, assert_same_update

TINY = dict(latent_dim=72, num_layers=2, num_heads=2, dim_feedforward=144,
            num_register_tokens=4, vertex_pe_num_freqs=4,
            view_transformer_latent_dim=72, view_transformer_ffn_hidden_dim=144,
            view_transformer_n_heads=2, view_transformer_n_layers=4,
            dpt_features=16, dpt_out_channels=[8, 16, 32, 64], pe_type='nerf')
RES = 64
NEW_LEAVES = {'tri_encoding_proj', 'tri_encoding_norm', 'view_transformer.pe_token_proj',
              'view_transformer.token_pos_pe_norm'}


@pytest.fixture(scope='module')
def tiny_tree():
    params = jax.jit(JaxRenderFormer(JaxConfig(**TINY)).init)(jax.random.key(0))
    return jax.tree.map(np.asarray, params)


def test_v1_base_nerf_is_v1_base_with_nerf_positions():
    assert dataclasses.replace(V1_BASE_NERF, pe_type='rope') == V1_BASE
    assert V1_BASE_NERF.rope_dim is None and V1_BASE_NERF.view_rope_dim is None


def test_bridge_round_trips_the_nerf_tree(tiny_tree):
    assert 'rope_freqs' not in tiny_tree['transformer']
    assert 'rope_freqs' not in tiny_tree['view_transformer']['transformer']
    sd = jax_params_to_state_dict(tiny_tree)
    assert not any('rope_emb' in k for k in sd)
    assert {k.rsplit('.', 1)[0] for k in sd} >= NEW_LEAVES
    model = RenderFormer(RenderFormerConfig(**TINY))
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    _assert_trees_equal(tiny_tree, state_dict_to_jax_params(sd))
    _assert_trees_equal(tiny_tree, state_dict_to_jax_params(model.state_dict()))


@pytest.fixture(scope='module')
def renders(tiny_tree):
    jp = JaxPipeline(JaxRenderFormer(JaxConfig(**TINY)), tiny_tree)
    model = RenderFormer(RenderFormerConfig(**TINY))
    model.load_state_dict(jax_params_to_state_dict(tiny_tree))
    tp = RenderingPipeline(model, device='cpu')
    scene = _scene()
    return {(who, prec): np.asarray(p.render(*scene, resolution=RES, precision=prec))
            for who, p in (('jax', jp), ('port', tp)) for prec in ('fp32', 'bf16')}


def test_fp32_render_matches_jax(renders):
    got, want = renders[('port', 'fp32')], renders[('jax', 'fp32')]
    assert got.shape == want.shape == (1, 2, RES, RES, 3)
    assert np.isfinite(got).all()
    # fp32 end to end; the same function up to summation order (the rope
    # renders' bar)
    assert np.abs(got - want).max() <= 1e-4


def test_swin_view_stage_render_matches_jax():
    """NeRF positions with the Swin view stage: the cross attention runs K10
    on the window-ordered ray tokens, with no RoPE tables to reorder."""
    cfg = dict(TINY, view_transformer_use_swin_attn=True)
    params = jax.tree.map(np.asarray, jax.jit(JaxRenderFormer(JaxConfig(**cfg)).init)(
        jax.random.key(1)))
    jp = JaxPipeline(JaxRenderFormer(JaxConfig(**cfg)), params)
    model = RenderFormer(RenderFormerConfig(**cfg))
    model.load_state_dict(jax_params_to_state_dict(params))
    scene = _scene()
    want = np.asarray(jp.render(*scene, resolution=128, precision='fp32'))
    got = RenderingPipeline(model, device='cpu').render(*scene, resolution=128,
                                                          precision='fp32').numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4  # fp32, summation order


def test_bf16_render_bounded_by_psnr(renders):
    got = renders[('port', 'bf16')]
    assert np.isfinite(got).all()
    # bf16 rounds at other points in the two frameworks: the chip render's bar
    assert _psnr(renders[('jax', 'bf16')], got) >= 40.0


@pytest.fixture(scope='module')
def two_steps(tiny_tree):
    jm = JaxRenderFormer(JaxConfig(**TINY))
    jtc = jstate.TrainConfig(**FP32)
    jtx = jstate.make_optimizer(jtc)
    js = jstate.TrainState.create(jax.tree.map(jnp.asarray, tiny_tree), jtx)
    jstep = jax.jit(jstate.make_train_step(jm, jtx, jtc, impl='xla')[0])
    batch = _batch()
    jmetrics = []
    for _ in range(2):
        js, m = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        jmetrics.append({k: float(v) for k, v in m.items()})
    model = RenderFormer(RenderFormerConfig(**TINY))
    model.load_state_dict(jax_params_to_state_dict(tiny_tree))
    tc = tstate.TrainConfig(**FP32, remat=True)
    tx = tstate.make_optimizer(tc)
    state = tstate.TrainState.create(model, tx, tc)
    step, _ = tstate.make_train_step(model, tx, tc)
    tmetrics = [step(state, _torch(batch))[1] for _ in range(2)]
    return (dict(_leaves(tiny_tree)), dict(_leaves(jax.tree.map(np.asarray, js.params))),
            jmetrics, dict(_leaves(state_dict_to_jax_params(state.model.state_dict()))),
            tmetrics)


def test_train_steps_match_jax(two_steps):
    p0, jp, jm, tp, tm = two_steps
    for j, t in zip(jm, tm):
        # fp32 end to end; the same function up to summation order
        assert abs(t['loss'] - j['loss']) <= 1e-5 * j['loss']
        assert abs(t['grad_norm'] - j['grad_norm']) <= 1e-5 * j['grad_norm']
    assert tm[1]['loss'] < tm[0]['loss']
    moved = np.concatenate([np.abs(w - p0[n]).ravel() for n, w in jp.items()])
    assert np.median(moved) > 0.5 * LR  # the steps moved the parameters
    assert_same_update(tp, jp, p0)


# width and counts at which every RMSNorm passes the K11 gate (D % 128 == 0,
# >= 256 rows): 256 triangles + 4 registers, 2 views of 16 x 16 ray tokens
WIDE = dict(TINY, latent_dim=128, dim_feedforward=128, view_transformer_latent_dim=128,
            view_transformer_ffn_hidden_dim=128, view_transformer_n_layers=4)
N_WIDE, V_WIDE, RES_WIDE = 256, 2, 128
# RMSNorm sites: 3 stage-1 embeddings, 4 a self-attention block, the ray
# encoder and the two position encodings of the view stage, 8 a decoder block
N_NORMS = 3 + 4 * WIDE['num_layers'] + 3 + 8 * WIDE['view_transformer_n_layers']
N_BLOCK_NORMS = 4 * WIDE['num_layers'] + 8 * WIDE['view_transformer_n_layers']


def _wide_batch():
    rng = np.random.default_rng(7)
    return {'triangles': rng.normal(size=(1, N_WIDE, 3, 3)).astype(np.float32) * 0.3,
            'texture': rng.uniform(0, 1, (1, N_WIDE, 13, 32, 32)).astype(np.float32),
            'mask': np.arange(N_WIDE)[None] < N_WIDE - 9,
            'vn': rng.normal(size=(1, N_WIDE, 3, 3)).astype(np.float32),
            'c2w': np.tile(np.eye(4, dtype=np.float32), (1, V_WIDE, 1, 1)),
            'fov': np.full((1, V_WIDE, 1), 40.0, np.float32),
            'gt': rng.uniform(0, 1, (1, V_WIDE, RES_WIDE, RES_WIDE, 3)).astype(np.float32)}


@pytest.fixture
def norm_calls(monkeypatch):
    """Calls of K11's plain versions, which its wrappers take on the CPU."""
    calls = {'fwd': 0, 'bwd': 0}

    def counted(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(fused_norm, 'rms_norm_fwd_plain',
                        counted('fwd', fused_norm.rms_norm_fwd_plain))
    monkeypatch.setattr(fused_norm, 'rms_norm_bwd_plain',
                        counted('bwd', fused_norm.rms_norm_bwd_plain))
    return calls


@pytest.mark.parametrize('precision,default', [
    pytest.param(p, default, id=p + ('-default' if default else ''))
    for default in (False, True) for p in ('fp32', 'bf16')])
def test_fused_norm_render_equals_torch_op_norm(norm_calls, precision, default):
    """With ``default`` the fused pipeline is the default runtime's, which
    sends the norms through K11."""
    model = init_weights(RenderFormer(RenderFormerConfig(**WIDE)),
                         torch.Generator().manual_seed(0))
    b = _wide_batch()
    scene = [b[k] for k in ('triangles', 'texture', 'mask', 'vn', 'c2w', 'fov')]
    assert RuntimeConfig().fused_norm
    imgs, pipes = {}, {}
    for fused in (False, True, False):  # two pipelines on one model, in turn
        runtime = RuntimeConfig() if fused and default else RuntimeConfig(fused_norm=fused)
        pipe = pipes.setdefault(fused, RenderingPipeline(model, runtime, device='cpu'))
        before = norm_calls['fwd']
        imgs[fused] = pipe.render(*scene, resolution=RES_WIDE, precision=precision)
        assert norm_calls['fwd'] - before == (N_NORMS if fused else 0)
    assert torch.isfinite(imgs[True]).all()
    # K11's plain forward is the torch-op norm's arithmetic: bit for bit
    assert torch.equal(imgs[True], imgs[False])


def test_fused_norm_train_step_matches_torch_op_norm(norm_calls):
    """With remat, each block's norms run twice in the forward (the step and
    the recomputation) and once in the backward; the others once each."""
    batch = _torch(_wide_batch())
    runs = []
    for fused in (False, True):
        model = init_weights(RenderFormer(RenderFormerConfig(**WIDE)),
                             torch.Generator().manual_seed(0))
        tc = tstate.TrainConfig(**dict(FP32, resolution=RES_WIDE), remat=True, fused_norm=fused)
        tx = tstate.make_optimizer(tc)
        state = tstate.TrainState.create(model, tx, tc)
        step, _ = tstate.make_train_step(model, tx, tc)
        before = dict(norm_calls)
        metrics = [step(state, batch)[1]]
        if fused:
            assert norm_calls['fwd'] - before['fwd'] == N_NORMS + N_BLOCK_NORMS
            assert norm_calls['bwd'] - before['bwd'] == N_NORMS
        runs.append(({n: p.detach().clone() for n, p in model.named_parameters()}, metrics))
    start = {n: p.detach().clone() for n, p in init_weights(
        RenderFormer(RenderFormerConfig(**WIDE)), torch.Generator().manual_seed(0)
    ).named_parameters()}
    # the fused backward's formula against autograd of the torch ops, fp32
    for g, w in zip(runs[1][1], runs[0][1]):
        for k in ('loss', 'grad_norm'):
            assert g[k] == pytest.approx(w[k], rel=1e-5), k
    assert_same_update(runs[1][0], runs[0][0], start)
