"""Swin training in the port against the JAX package on the CPU: the plain
version of K6's backward (K6^T) against ``jax.vjp`` of the JAX window
attention (interpret mode) and against autograd of K6's plain forward, the
autograd Functions of K6 and K7 (the regroup's VJP against ``jax.grad``
through the JAX Pallas kernel), the Swin attention module's gradients, two
fp32 steps of the tiny Swin model against JAX's ``make_train_step(...,
impl='xla')``, remat, and ``TrainConfig.deterministic``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from renderformer_tpu import RenderFormerConfig as JaxConfig
from renderformer_tpu.models.renderformer import RenderFormer as JaxRenderFormer
from renderformer_tpu.nn import attention as jattn
from renderformer_tpu.ops.shifted_regroup import shifted_regroup_kernel
from renderformer_tpu.ops.swin_attention import swin_window_attention as jax_swin
from renderformer_tpu.training import state as jstate
from renderformer_tpu_torch import RenderFormerConfig
from renderformer_tpu_torch.convert import jax_params_to_state_dict, state_dict_to_jax_params
from renderformer_tpu_torch.models.renderformer import RenderFormer
from renderformer_tpu_torch.nn import swin
from renderformer_tpu_torch.nn.attention import SwinSelfAttention
from renderformer_tpu_torch.nn.core import init_weights
from renderformer_tpu_torch.ops import flash_attention as fa
from renderformer_tpu_torch.ops.shifted_regroup import shifted_regroup
from renderformer_tpu_torch.ops.swin_attention import (
    region_table, swin_window_attention, swin_window_attention_bwd,
    swin_window_attention_bwd_plain, swin_window_attention_plain)
from renderformer_tpu_torch.training import state as tstate
from test_torch_swin import REGROUP_SHAPES, TINY_SWIN
from test_torch_train import _leaves, _params, assert_same_metrics, assert_same_update

RES, N, V = 128, 8, 2  # a 16x16 patch grid: 2x2 windows of 8x8 tokens
LR = 1e-3
FP32 = dict(precision='float32', view_precision='float32', resolution=RES,
            learning_rate=LR, steps_per_epoch=10, num_epochs=1)
CPU = torch.device('cpu')


def _inputs(seed, shape=(8, 64, 256)):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]


def _bar(ref, dtype):
    amax = float(np.abs(ref).max())
    if dtype == 'float32':
        return 2.0 ** -16 * amax  # fp32 sums in another order
    # P and dS round to bf16 in both; a sum in another order may round them
    # to a neighbouring bf16 value: 4 bf16 ulps of max|ref|
    return 4 * 2.0 ** -8 * amax


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


@pytest.mark.parametrize('shift', [0, 4])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_swin_bwd_plain_matches_jax_vjp_and_autograd(shift, dtype):
    """2 views x a 16x16 grid (4 windows each), 2 heads of 128: K6^T's plain
    version against jax.vjp of the JAX window attention (its custom VJP,
    the forward in interpret mode) and against torch autograd of K6's plain
    forward."""
    h = w = 16
    jdt = jnp.float32 if dtype == 'float32' else jnp.bfloat16
    tdt = torch.float32 if dtype == 'float32' else torch.bfloat16
    q, k, v, g = (jnp.asarray(a, jdt) for a in _inputs(shift))
    _, vjp = jax.vjp(lambda a, b, c: jax_swin(a, b, c, n_windows=4, grid_hw=(h, w),
                                              window_size=8, shift_size=shift,
                                              interpret=True), q, k, v)
    want_jax = vjp(g)
    tq, tk, tv, tg = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
                      for a in (q, k, v, g))
    regions = region_table(h, w, 8, shift, CPU) if shift else None
    got = swin_window_attention_bwd(tq, tk, tv, tg, num_heads=2, regions=regions)
    assert all(t.dtype == tdt and t.shape == tq.shape for t in got)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    want_torch = torch.autograd.grad(
        swin_window_attention_plain(*leaves, 2, regions), leaves, tg)
    for name, a, j, t in zip('qkv', got, want_jax, want_torch):
        a, j, t = _f32(a), _f32(j), _f32(t)
        assert np.abs(a - j).max() <= _bar(j, dtype), f'd{name} against jax.vjp'
        assert np.abs(a - t).max() <= _bar(t, dtype), f'd{name} against autograd'


@pytest.mark.parametrize('shift', [0, 4])
def test_swin_bwd_plain_is_the_kernel_wrapper_on_cpu(shift):
    """The wrapper and the Function's backward take the plain version on the
    CPU, the same bits."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(7))
    regions = region_table(16, 16, 8, shift, CPU) if shift else None
    want = swin_window_attention_bwd_plain(q, k, v, g, 2, regions)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = swin_window_attention(*leaves, num_heads=2, regions=regions)
    assert torch.equal(out, swin_window_attention_plain(q, k, v, 2, regions))
    got = torch.autograd.grad(out, leaves, g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_swin_function_grads_any_head_dim():
    """The Function's gradients at head dim 36 against autograd of masked
    SDPA, as the forward is held to it."""
    rng = np.random.default_rng(3)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(8, 64, 72)).astype(np.float32))
                  for _ in range(4))
    regions = region_table(16, 16, 8, 4, CPU)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(swin_window_attention(*leaves, num_heads=2, regions=regions),
                              leaves, g)
    mask = torch.from_numpy(swin.swin_attn_mask(16, 16, 8, 4)).repeat(2, 1, 1)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    qh, kh, vh = (t.reshape(8, 64, 2, 36).transpose(1, 2) for t in leaves)
    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask[:, None])
    want = torch.autograd.grad(out.transpose(1, 2).reshape(8, 64, 72), leaves, g)
    for a, b in zip(got, want):
        # exp2 with a log2(e)-scaled q vs exp, and ln 2 back: fp32 rounding only
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.mark.parametrize('h,w,ws,b,c', REGROUP_SHAPES)
@pytest.mark.parametrize('inverse', [False, True])
def test_regroup_vjp_matches_jax_grad(h, w, ws, b, c, inverse):
    """K7's VJP (the regroup with ``inverse`` flipped) against jax.grad
    through the JAX Pallas kernel in interpret mode: a permutation, exact."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(b, h * w, c)).astype(np.float32)
    g = rng.normal(size=(b, h * w, c)).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(
        shifted_regroup_kernel(a, (h, w), ws, inverse, True) * g))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    got, = torch.autograd.grad(shifted_regroup(tx, (h, w), ws, inverse=inverse), tx,
                               torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('shift', [0, 4])
def test_swin_module_grads_match_jax(shift):
    """SwinSelfAttention's input and parameter gradients on a window-ordered
    stream, fp32, weights carried across from a JAX init, against jax.vjp
    of the JAX module (the XLA windowed-SDPA path)."""
    dim, heads, h, w = 64, 2, 16, 16
    jmod = jattn.SwinSelfAttention(dim=dim, num_heads=heads, window_size=8,
                                   shift_size=shift, qk_norm=True)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.key(shift)))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, h * w, dim)).astype(np.float32)
    g = rng.normal(size=(2, h * w, dim)).astype(np.float32)
    _, vjp = jax.vjp(lambda p, a: jmod(p, a, impl='xla', grid=(h, w)),
                     jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(g))
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, jgp))
    tmod = SwinSelfAttention(dim, heads, 8, shift, qk_norm=True)
    tmod.load_state_dict(jax_params_to_state_dict(params), strict=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    names = [n for n, _ in tmod.named_parameters()]
    grads = torch.autograd.grad(tmod(tx, (h, w)), [tx, *tmod.parameters()],
                                torch.from_numpy(g))
    assert set(names) == set(want)
    # fp32 throughout: summation order and exp2 vs exp
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), atol=1e-5, rtol=1e-5)
    for name, got in zip(names, grads[1:]):
        np.testing.assert_allclose(got.numpy(), want[name], atol=1e-5, rtol=1e-5,
                                   err_msg=name)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    mask = np.ones((1, N), bool)
    mask[:, -2:] = False
    return {'triangles': rng.normal(size=(1, N, 3, 3)).astype(np.float32) * 0.3,
            'texture': rng.uniform(0, 1, (1, N, 13, 32, 32)).astype(np.float32),
            'mask': mask, 'vn': rng.normal(size=(1, N, 3, 3)).astype(np.float32),
            'c2w': np.tile(np.eye(4, dtype=np.float32), (1, V, 1, 1)),
            'fov': np.full((1, V, 1), 40.0, np.float32),
            'gt': rng.uniform(0, 1, (1, V, RES, RES, 3)).astype(np.float32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _model(seed=0):
    return init_weights(RenderFormer(RenderFormerConfig(**TINY_SWIN)),
                        torch.Generator().manual_seed(seed))


def _run(model, tc, batches):
    tx = tstate.make_optimizer(tc)
    state = tstate.TrainState.create(model, tx, tc)
    step, _ = tstate.make_train_step(model, tx, tc)
    return state, [step(state, b)[1] for b in batches]


@pytest.fixture(scope='module')
def two_swin_steps():
    """Two fp32 steps of the tiny Swin model in each framework from one JAX
    init, with remat on in the port (the workload's setting)."""
    jm = JaxRenderFormer(JaxConfig(**TINY_SWIN))
    params = jm.init(jax.random.key(0))
    jtc = jstate.TrainConfig(**FP32)
    jtx = jstate.make_optimizer(jtc)
    js = jstate.TrainState.create(params, jtx)
    jstep = jax.jit(jstate.make_train_step(jm, jtx, jtc, impl='xla')[0])
    batch = _batch()
    jmetrics = []
    for _ in range(2):
        js, m = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        jmetrics.append({k: float(v) for k, v in m.items()})
    model = RenderFormer(RenderFormerConfig(**TINY_SWIN))
    model.load_state_dict(jax_params_to_state_dict(jax.tree.map(np.asarray, params)))
    state, tmetrics = _run(model, tstate.TrainConfig(**FP32, remat=True), [_torch(batch)] * 2)
    return (dict(_leaves(jax.tree.map(np.asarray, params))),
            dict(_leaves(jax.tree.map(np.asarray, js.params))), jmetrics,
            dict(_leaves(state_dict_to_jax_params(state.model.state_dict()))), tmetrics)


def test_swin_step_loss_and_grad_norm_match_jax(two_swin_steps):
    _, _, jm, _, tm = two_swin_steps
    for j, t in zip(jm, tm):
        # fp32 end to end; the same function up to summation order
        assert abs(t['loss'] - j['loss']) <= 1e-5 * j['loss']
        assert abs(t['grad_norm'] - j['grad_norm']) <= 1e-5 * j['grad_norm']
    assert tm[1]['loss'] < tm[0]['loss']


def test_swin_step_updated_params_match_jax(two_swin_steps):
    p0, jp, _, tp, _ = two_swin_steps
    # the RoPE base frequencies: the port decays them alone, as optax does
    # on the flash path's zero gradient (tests/test_torch_train.py holds it)
    jp = {n: w for n, w in jp.items() if not n.endswith('rope_freqs')}
    swin_names = [n for n in jp if '.self_attn.' in n and n.startswith('.view_transformer')]
    assert swin_names
    moved = np.concatenate([np.abs(w - p0[n]).ravel() for n, w in jp.items()])
    assert np.median(moved) > 0.5 * LR  # the steps moved the parameters
    assert all(not np.array_equal(tp[n], p0[n]) for n in swin_names)
    assert_same_update(tp, jp, p0)


def test_swin_remat_matches_no_remat():
    batches = [_torch(_batch(0)), _torch(_batch(1))]
    runs = []
    for remat in (False, True):
        state, metrics = _run(_model(), tstate.TrainConfig(**FP32, remat=remat), batches)
        runs.append((_params(state.model), metrics))
    # the recomputed forward is the same computation
    assert_same_metrics(runs[1][1], runs[0][1])
    assert_same_update(runs[1][0], runs[0][0], _params(_model()))


def test_deterministic_selects_the_two_kernel_backward(monkeypatch):
    """deterministic=True runs K9 ('twokernel') at every attention site,
    with flash_bwd '' or 'twokernel', and refuses an explicit 'fused'."""
    seen = []
    real = fa.flash_bwd

    def spy(*args):
        seen.append(args[-1])
        return real(*args)

    monkeypatch.setattr(fa, 'flash_bwd', spy)
    for flash_bwd, deterministic, want in (('', False, 'fused'), ('', True, 'twokernel'),
                                           ('twokernel', True, 'twokernel')):
        seen.clear()
        tc = tstate.TrainConfig(**FP32, flash_bwd=flash_bwd, deterministic=deterministic)
        assert tstate.flash_bwd_variant(tc) == want
        _, metrics = _run(_model(), tc, [_torch(_batch())])
        assert np.isfinite(metrics[0]['loss'])
        # 1 encoder self-attention and 4 decoder cross-attentions
        assert seen == [want] * 5
    tc = tstate.TrainConfig(**FP32, flash_bwd='fused', deterministic=True)
    with pytest.raises(ValueError, match='deterministic'):
        tstate.make_train_step(_model(), tstate.make_optimizer(tc), tc)
    assert not torch.backends.cudnn.deterministic  # the flag is set for a step only
