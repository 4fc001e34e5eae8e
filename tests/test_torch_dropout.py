"""Dropout in the port at the tiny config on the CPU: inverted-dropout
statistics and the eval identity; its placement against the JAX package,
with both frameworks taking their keep masks, in call order, from one
numpy-seeded list (a render, and a train step's loss and grad norm); remat
drawing the same masks in the backward's recomputation; and the same masks
after a checkpoint resume.

The model is the tiny config with one encoder and two decoder blocks and
the linear head: dropout sits in the blocks, and the DPT head would
triple the JAX compile.  The weights are the port's seeded init carried
to the JAX tree by convert.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import renderformer_tpu.nn.attention as jattention
import renderformer_tpu_torch.nn.attention as tattention
from renderformer_tpu import RenderFormerConfig as JaxConfig
from renderformer_tpu.models.renderformer import RenderFormer as JaxRenderFormer
from renderformer_tpu.pipelines.rendering_pipeline import render_fn as jax_render_fn
from renderformer_tpu.training import state as jstate
from renderformer_tpu_torch import RenderFormerConfig
from renderformer_tpu_torch.convert import state_dict_to_jax_params
from renderformer_tpu_torch.models.renderformer import RenderFormer
from renderformer_tpu_torch.nn import core
from renderformer_tpu_torch.nn.core import DropoutKey, dropout, init_weights
from renderformer_tpu_torch.pipelines.rendering_pipeline import render_fn
from renderformer_tpu_torch.training import state as tstate
from renderformer_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint

TINY = dict(latent_dim=72, num_layers=1, num_heads=2, dim_feedforward=144,
            num_register_tokens=4, vertex_pe_num_freqs=4,
            view_transformer_latent_dim=72, view_transformer_ffn_hidden_dim=144,
            view_transformer_n_heads=2, view_transformer_n_layers=2,
            use_dpt_decoder=False, dropout=0.3)
RES, N, V = 32, 8, 2
FP32 = dict(precision='float32', view_precision='float32', resolution=RES,
            learning_rate=1e-3, steps_per_epoch=10, num_epochs=1)
SITES = 4 * 1 + 5 * 2  # 4 sites an encoder block (1), 5 a decoder block (2)


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


def test_dropout_statistics_and_eval_identity():
    x = torch.ones(4, 1024)
    y = dropout(x, 0.5, DropoutKey(0, 0))
    assert 0.4 < float((y == 0).float().mean()) < 0.6    # ~rate of the units dropped
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 2.0))  # 1 / keep
    # the same key, the same mask; another key, another
    assert torch.equal(y, dropout(x, 0.5, DropoutKey(0, 0)))
    assert not torch.equal(y, dropout(x, 0.5, DropoutKey(0, 1)))
    # eval: x itself, no operation
    assert dropout(x, 0.5, None) is x and dropout(x, 0.0, DropoutKey(0, 0)) is x
    # keep rounded to x's dtype before the division, as the JAX package
    xb = torch.ones(8, 512, dtype=torch.bfloat16)
    yb = dropout(xb, 0.3, DropoutKey(1))
    keep = torch.tensor(0.7, dtype=torch.bfloat16)
    assert torch.equal(yb[yb != 0], (xb / keep)[yb != 0])


class SharedMasks:
    """Both frameworks' ``dropout`` drawing keep masks in call order from one
    list: the JAX run appends numpy-seeded masks, the port's run replays
    them and checks each shape."""

    def __init__(self, seed=0):
        self.rng = np.random.default_rng(seed)
        self.masks, self.at = [], 0

    def jax(self, x, rate, rng):
        if rng is None or rate <= 0.0:
            return x
        m = self.rng.uniform(size=x.shape) < 1.0 - rate
        self.masks.append(m)
        return jnp.where(m, x / jnp.asarray(1.0 - rate, x.dtype), 0).astype(x.dtype)

    def port(self, x, rate, key):
        if key is None or rate <= 0.0:
            return x
        m = self.masks[self.at]
        self.at += 1
        assert m.shape == tuple(x.shape)
        return torch.where(torch.from_numpy(m), x / (1.0 - rate), 0.0)


def _model(seed=0):
    return init_weights(RenderFormer(RenderFormerConfig(**TINY)),
                        torch.Generator().manual_seed(seed))


@pytest.fixture
def jax_init():
    """The JAX model and the port's seeded weights as its tree (copies, which
    the port's in-place updates cannot reach)."""
    params = jax.tree.map(lambda a: jnp.asarray(np.array(a)),
                          state_dict_to_jax_params(_model().state_dict()))
    return JaxRenderFormer(JaxConfig(**TINY)), params


def test_placement_matches_jax_render(jax_init, monkeypatch):
    jm, params = jax_init
    shared = SharedMasks()
    monkeypatch.setattr(jattention, 'dropout', shared.jax)
    monkeypatch.setattr(tattention, 'dropout', shared.port)
    b = _batch()
    args = [b[k] for k in ('triangles', 'texture', 'mask', 'vn', 'c2w', 'fov')]
    fn = jax.jit(functools.partial(jax_render_fn, model=jm, resolution=RES, dtype=jnp.float32,
                                   view_dtype=jnp.float32, impl='xla'))
    want = np.asarray(fn(params, *args, dropout_rng=jax.random.key(0)))
    assert len(shared.masks) == SITES
    with torch.no_grad():
        got = render_fn(_model(), *(torch.from_numpy(a) for a in args),
                        resolution=RES, dropout_key=DropoutKey(0, 0)).numpy()
    assert shared.at == SITES

    def err(a):  # tests/test_torch_variants.py's bar for the linear head
        return (np.abs(a - want) / np.maximum(1.0, np.abs(want))).max()

    assert err(got) <= 1e-4  # fp32, summation order
    # the masks matter: without them the render moves far past the bar
    assert err(np.asarray(fn(params, *args))) > 1e-2


def test_placement_matches_jax_train_step(jax_init, monkeypatch):
    jm, params = jax_init
    shared = SharedMasks(1)
    monkeypatch.setattr(jattention, 'dropout', shared.jax)
    monkeypatch.setattr(tattention, 'dropout', shared.port)
    jtc = jstate.TrainConfig(**FP32)
    jtx = jstate.make_optimizer(jtc)
    jstep = jax.jit(jstate.make_train_step(jm, jtx, jtc, impl='xla')[0])
    b = _batch(1)
    _, jm_ = jstep(jstate.TrainState.create(params, jtx),
                   {k: jnp.asarray(v) for k, v in b.items()})
    loss, gnorm = float(jm_['loss']), float(jm_['grad_norm'])
    assert len(shared.masks) == SITES
    model = _model()
    tc = tstate.TrainConfig(**FP32)
    tx = tstate.make_optimizer(tc)
    step, _ = tstate.make_train_step(model, tx, tc)
    _, tm = step(tstate.TrainState.create(model, tx, tc), _torch(b))
    assert shared.at == SITES
    # test_loss_and_grad_norm_match_jax's bar: fp32, summation order
    assert tm['loss'] == pytest.approx(loss, rel=1e-5)
    assert tm['grad_norm'] == pytest.approx(gnorm, rel=1e-5)


def _grads(remat):
    model = _model()
    tc = tstate.TrainConfig(**FP32, remat=remat)
    state = tstate.TrainState.create(model, tstate.make_optimizer(tc), tc)
    state.step = 3
    return tstate.make_loss_fns(model, tc)[1](state, _torch(_batch(2)))


def _worst(a, b):
    return max(float((x - y).norm() / y.norm().clamp_min(1e-30)) for x, y in zip(a, b))


def test_remat_recomputes_the_same_masks(monkeypatch):
    (l0, g0), (l1, g1) = _grads(False), _grads(True)
    assert float(l0) == pytest.approx(float(l1), rel=1e-6)
    # the recomputation is the same computation: summation order alone
    assert _worst(g1, g0) <= 1e-4
    # the control: one generator made once and consumed site after site, so
    # the recomputation draws other masks, gives other gradients
    shared = torch.Generator().manual_seed(0)
    monkeypatch.setattr(core.DropoutKey, 'generator', lambda self, device: shared)
    (_, c0), (_, c1) = _grads(False), _grads(True)
    assert _worst(c1, c0) > 1e-2


def test_resume_draws_the_same_masks(tmp_path, monkeypatch):
    seen = []
    real = core.DropoutKey.generator

    def record(self, device):
        seen.append(self.path)
        return real(self, device)

    monkeypatch.setattr(core.DropoutKey, 'generator', record)
    tc = tstate.TrainConfig(**FP32)
    batches = [_torch(_batch(3)), _torch(_batch(4))]

    def fresh(seed=0):
        model = _model(seed)
        tx = tstate.make_optimizer(tc)
        return model, tx, tstate.TrainState.create(model, tx, tc)

    model, tx, state = fresh()
    step = tstate.make_train_step(model, tx, tc)[0]
    step(state, batches[0])
    path = save_checkpoint(str(tmp_path), 'mid', state, model.config)
    seen.clear()
    _, m_full = step(state, batches[1])
    full_keys, seen[:] = list(seen), []
    model2, tx2, state2 = fresh(seed=5)
    state2, _ = load_checkpoint(path, state2)
    _, m_resumed = tstate.make_train_step(model2, tx2, tc)[0](state2, batches[1])
    assert seen == full_keys and len(seen) == SITES
    assert all(p[:2] == (tc.seed, 1) for p in seen)  # (seed, step) of the second step
    for k in ('loss', 'grad_norm'):
        assert m_resumed[k] == pytest.approx(m_full[k], rel=1e-6), k
    for (n, p), p2 in zip(model.named_parameters(), model2.parameters()):
        torch.testing.assert_close(p2, p, rtol=0, atol=1e-4 * 1e-3, msg=n)
