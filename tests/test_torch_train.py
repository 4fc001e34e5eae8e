"""The port's train step at the tiny config on the CPU: two fp32 steps
against the JAX package's ``make_train_step(..., impl='xla')`` from the same
init (carried across by convert.py), the optimizer against optax, and the
step's own contracts: the NaN skip, remat, the stage casts, checkpoints,
``eval_step``'s weighting and the trainer."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from renderformer_tpu import RenderFormerConfig as JaxConfig
from renderformer_tpu.models.renderformer import RenderFormer as JaxRenderFormer
from renderformer_tpu.training import state as jstate
from renderformer_tpu_torch import RenderFormerConfig
from renderformer_tpu_torch.convert import jax_params_to_state_dict, state_dict_to_jax_params
from renderformer_tpu_torch.models.renderformer import RenderFormer
from renderformer_tpu_torch.nn.core import init_weights
from renderformer_tpu_torch.training import state as tstate
from renderformer_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from renderformer_tpu_torch.training.trainer import RenderFormerTrainer, TrainerConfig

TINY = dict(latent_dim=72, num_layers=2, num_heads=2, dim_feedforward=144,
            num_register_tokens=4, vertex_pe_num_freqs=4,
            view_transformer_latent_dim=72, view_transformer_ffn_hidden_dim=144,
            view_transformer_n_heads=2, view_transformer_n_layers=4,
            dpt_features=16, dpt_out_channels=[8, 16, 32, 64])
RES, N, V = 32, 8, 2
LR = 1e-3  # large enough that two steps move every parameter visibly
FP32 = dict(precision='float32', view_precision='float32', resolution=RES,
            learning_rate=LR, steps_per_epoch=10, num_epochs=1)


def _batch(seed=0, b=1):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, N), bool)
    mask[:, -2:] = False
    return {'triangles': rng.normal(size=(b, N, 3, 3)).astype(np.float32) * 0.3,
            'texture': rng.uniform(0, 1, (b, N, 13, 32, 32)).astype(np.float32),
            'mask': mask, 'vn': rng.normal(size=(b, N, 3, 3)).astype(np.float32),
            'c2w': np.tile(np.eye(4, dtype=np.float32), (b, V, 1, 1)),
            'fov': np.full((b, V, 1), 40.0, np.float32),
            'gt': rng.uniform(0, 1, (b, V, RES, RES, 3)).astype(np.float32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _model(seed=0):
    model = RenderFormer(RenderFormerConfig(**TINY))
    return init_weights(model, torch.Generator().manual_seed(seed))


def _run(model, tc, batches):
    tx = tstate.make_optimizer(tc)
    state = tstate.TrainState.create(model, tx, tc)
    step, _ = tstate.make_train_step(model, tx, tc)
    metrics = [step(state, b)[1] for b in batches]
    return state, metrics


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def assert_same_update(got, want, start, lr=LR):
    """Parameters ``got`` and ``want`` (name -> array), both moved from
    ``start`` by Adam steps, agree.  Adam divides each gradient entry by its
    own running magnitude, so an entry whose gradient is near the fp32 noise
    of its sum (a reduction in another order, or CPU kernels whose threads
    add in a run-dependent order) can move by a share of lr either way:
    every entry within 10% of lr, 99.9% of them within 0.1% of lr, and the
    difference 1e-3 of the update in L2."""
    d = np.concatenate([np.abs(np.asarray(got[n]) - np.asarray(w)).ravel()
                        for n, w in want.items()])
    moved = np.concatenate([(np.asarray(w) - np.asarray(start[n])).ravel()
                            for n, w in want.items()])
    assert d.max() <= 0.1 * lr
    assert (d <= 1e-3 * lr).mean() >= 0.999
    assert np.linalg.norm(d) <= 1e-3 * np.linalg.norm(moved)


def assert_same_metrics(got, want):
    for g, w in zip(got, want):
        for k in ('loss', 'grad_norm'):
            assert g[k] == pytest.approx(w[k], rel=1e-5), k


def _leaves(tree, prefix=''):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f'{prefix}.{k}')
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f'{prefix}.{i}')
    else:
        yield prefix, np.asarray(tree)


@pytest.fixture(scope='module')
def two_steps():
    """Two fp32 steps of each framework from the JAX init, with remat on in
    the port (the workload's setting)."""
    jm = JaxRenderFormer(JaxConfig(**TINY))
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
    model = RenderFormer(RenderFormerConfig(**TINY))
    model.load_state_dict(jax_params_to_state_dict(jax.tree.map(np.asarray, params)))
    state, tmetrics = _run(model, tstate.TrainConfig(**FP32, remat=True), [_torch(batch)] * 2)
    return (dict(_leaves(jax.tree.map(np.asarray, params))),
            dict(_leaves(jax.tree.map(np.asarray, js.params))), jmetrics,
            dict(_leaves(state_dict_to_jax_params(state.model.state_dict()))), tmetrics)


def test_loss_and_grad_norm_match_jax(two_steps):
    _, _, jm, _, tm = two_steps
    for j, t in zip(jm, tm):
        # fp32 end to end; the same function up to summation order
        assert abs(t['loss'] - j['loss']) <= 1e-5 * j['loss']
        assert abs(t['grad_norm'] - j['grad_norm']) <= 1e-5 * j['grad_norm']
    assert tm[1]['loss'] < tm[0]['loss']


def test_updated_params_match_jax(two_steps):
    p0, jp, _, tp, _ = two_steps
    jp = dict(jp)
    freqs = [n for n in jp if n.endswith('rope_freqs')]
    assert freqs
    # no gradient reaches the RoPE frequencies on JAX's flash path (the
    # tables are no-grad, as in the reference), but its optax.adamw has no
    # mask and decays them every step; its xla attention, run here, also
    # lets a gradient reach them.  The port keeps the flash path's
    # semantics: the decay alone, which optax gives on zero gradients
    otx = jstate.make_optimizer(jstate.TrainConfig(**FP32))
    want = {n: jnp.asarray(p0[n]) for n in freqs}
    ostate = otx.init(want)
    for _ in range(2):
        upd, ostate = otx.update(jax.tree.map(jnp.zeros_like, want), ostate, want)
        want = optax.apply_updates(want, upd)
    for name in freqs:
        assert not np.array_equal(tp[name], p0[name])
        # the same fp32 products p - lr*(wd*p) in both
        np.testing.assert_allclose(tp[name], np.asarray(want[name]), rtol=2.0 ** -23, atol=0)
        del jp[name]
    moved = np.concatenate([np.abs(w - p0[n]).ravel() for n, w in jp.items()])
    assert np.median(moved) > 0.5 * LR  # the steps moved the parameters
    assert_same_update(tp, jp, p0)


@pytest.mark.parametrize('warmup', [0, 3])
def test_schedule_matches_optax(warmup):
    tc = tstate.TrainConfig(learning_rate=2e-4, warmup_steps=warmup, steps_per_epoch=7,
                            num_epochs=2, min_lr_scale=0.1)
    ours = tstate.make_optimizer(tc).schedule
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0 if warmup else 2e-4, peak_value=2e-4, warmup_steps=warmup,
        decay_steps=14, end_value=2e-5)
    for count in range(18):
        # fp32 cos and products in both
        assert ours(count) == pytest.approx(float(want(count)), rel=1e-6, abs=1e-12)


def test_adamw_and_clip_match_optax():
    """Three updates, one of them clipped, against optax's chain."""
    rng = np.random.default_rng(3)
    shapes = {'a': (4, 5), 'b': (7,), 'c': (2, 3, 2)}
    params = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    tc = tstate.TrainConfig(learning_rate=1e-2, weight_decay=0.1, max_grad_norm=1.0,
                            steps_per_epoch=5, num_epochs=1)
    tx = tstate.make_optimizer(tc)
    ours = {n: torch.from_numpy(p.copy()) for n, p in params.items()}
    state = tx.init(ours)
    otx = jstate.make_optimizer(jstate.TrainConfig(
        learning_rate=1e-2, weight_decay=0.1, max_grad_norm=1.0, steps_per_epoch=5,
        num_epochs=1))
    oparams = {n: jnp.asarray(p) for n, p in params.items()}
    ostate = otx.init(oparams)
    for scale in (0.05, 3.0, 0.2):  # norms below, above and below max_grad_norm
        grads = {n: (rng.normal(size=s) * scale).astype(np.float32) for n, s in shapes.items()}
        tg = [torch.from_numpy(grads[n].copy()) for n in ours]
        gnorm = float(tstate.global_norm(tg))
        assert gnorm == pytest.approx(float(optax.global_norm(grads)), rel=1e-6)
        tx.update(tg, state, ours, gnorm)
        upd, ostate = otx.update({n: jnp.asarray(g) for n, g in grads.items()}, ostate, oparams)
        oparams = optax.apply_updates(oparams, upd)
    assert state['count'] == 3
    for n in shapes:
        # fp32 elementwise arithmetic in another grouping
        np.testing.assert_allclose(ours[n].numpy(), np.asarray(oparams[n]), rtol=1e-6,
                                   atol=1e-7)


def test_nonfinite_loss_skips_the_update():
    model = _model()
    tc = tstate.TrainConfig(**FP32)
    tx = tstate.make_optimizer(tc)
    state = tstate.TrainState.create(model, tx, tc)
    step, _ = tstate.make_train_step(model, tx, tc)
    state, m = step(state, _torch(_batch()))
    before = _params(model)
    mu = {n: t.clone() for n, t in state.opt_state['mu'].items()}
    bad = _batch(seed=1)
    bad['gt'][0, 0, 0, 0, 0] = np.nan
    state, m = step(state, _torch(bad))
    assert not np.isfinite(m['loss'])
    assert state.step == 2 and state.opt_state['count'] == 1
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]), n
        assert torch.equal(state.opt_state['mu'][n], mu[n]), n


def test_remat_matches_no_remat():
    batches = [_torch(_batch(0)), _torch(_batch(1))]
    runs = []
    for remat in (False, True):
        state, metrics = _run(_model(), tstate.TrainConfig(**FP32, remat=remat), batches)
        runs.append((_params(state.model), metrics))
    # the recomputed forward is the same computation
    assert_same_metrics(runs[1][1], runs[0][1])
    assert_same_update(runs[1][0], runs[0][0], _params(_model()))


def test_bf16_stage_one_and_shadow_params():
    """The workload's arrangement (bf16 stage 1, fp32 view stage): the
    in-graph casts reach the fp32 masters, and a bf16 shadow copy gives the
    same step."""
    tc = dict(FP32, precision='bfloat16', view_precision='', remat=True)
    assert tstate.resolve_dtypes(tstate.TrainConfig(**tc)) == (torch.bfloat16, torch.float32)
    runs = []
    for shadow in (False, True):
        state, metrics = _run(_model(), tstate.TrainConfig(**tc, bf16_shadow_params=shadow),
                              [_torch(_batch())] * 2)
        assert all(np.isfinite(m['loss']) and np.isfinite(m['grad_norm']) for m in metrics)
        assert all(p.dtype == torch.float32 for p in state.model.parameters())
        assert (state.shadow is not None) == shadow
        runs.append((_params(state.model), metrics))
    start = _params(_model())
    assert all(not torch.equal(p, start[n]) for n, p in runs[0][0].items())
    # the same bf16 products and the same fp32 update
    assert_same_metrics(runs[1][1], runs[0][1])
    assert_same_update(runs[1][0], runs[0][0], start)


def test_checkpoint_resume_equals_uninterrupted(tmp_path):
    batches = [_torch(_batch(0)), _torch(_batch(1))]
    tc = tstate.TrainConfig(**FP32)
    full, _ = _run(_model(), tc, batches)

    model = _model()
    tx = tstate.make_optimizer(tc)
    state = tstate.TrainState.create(model, tx, tc)
    step, _ = tstate.make_train_step(model, tx, tc)
    step(state, batches[0])
    path = save_checkpoint(str(tmp_path), 'mid', state, model.config, {'epoch': 0})

    model2 = _model(seed=5)
    tx2 = tstate.make_optimizer(tc)
    state2 = tstate.TrainState.create(model2, tx2, tc)
    state2, meta = load_checkpoint(path, state2)
    assert meta['extra'] == {'epoch': 0}
    assert RenderFormerConfig.from_dict(meta['model_config']) == model.config
    assert state2.step == 1 and state2.opt_state['count'] == 1
    step2, _ = tstate.make_train_step(model2, tx2, tc)
    step2(state2, batches[1])
    assert_same_update(_params(model2), _params(full.model), _params(_model()))


def test_eval_step_weights_by_valid():
    model = _model()
    tc = tstate.TrainConfig(**FP32)
    tx = tstate.make_optimizer(tc)
    state = tstate.TrainState.create(model, tx, tc)
    _, eval_step = tstate.make_train_step(model, tx, tc)
    both = _batch(seed=2, b=2)
    one = {k: v[:1] for k, v in both.items()}
    want = eval_step(state, _torch(one))
    both['valid'] = np.array([1.0, 0.0], np.float32)
    got = eval_step(state, _torch(both))
    assert got['n'] == 1.0
    # the padded second sample counts for nothing
    assert got['loss'] == pytest.approx(want['loss'], rel=1e-6)
    assert got['loss_sum'] == pytest.approx(want['loss_sum'], rel=1e-6)


def test_trainer_fits_saves_and_resumes(tmp_path):
    cfg = TrainerConfig(train=tstate.TrainConfig(**dict(FP32, num_epochs=2)),
                        checkpoint_dir=str(tmp_path), save_interval=1, log_every=1)
    lines = []
    tr = RenderFormerTrainer(_model(), cfg, steps_per_epoch=1, device='cpu',
                             log=lines.append)
    hist = tr.fit([_batch(0)], [_batch(1)])
    assert len(hist['train_losses']) == 2 and len(hist['val_losses']) == 2
    assert tr.state.step == 2 and tr.tc.steps_per_epoch == 1
    for tag in ('best', 'epoch_0', 'epoch_1', 'final'):
        assert (tmp_path / tag / 'state.pt').exists(), tag
    assert any('epoch 1: train=' in line for line in lines)
    resumed = RenderFormerTrainer(
        _model(seed=9), dataclasses.replace(cfg, resume_from=str(tmp_path / 'epoch_0')),
        steps_per_epoch=1, device='cpu', log=lines.append)
    assert resumed.start_epoch == 1 and resumed.state.step == 1
    assert resumed.train_losses == hist['train_losses'][:1]


def test_unported_training_options_raise():
    """Dropout and debug_nans, once refused, now build and run a step; an
    unknown backward and K8 under deterministic still raise."""
    model = init_weights(RenderFormer(RenderFormerConfig(**dict(TINY, dropout=0.1))),
                         torch.Generator().manual_seed(0))
    for m, tc in ((model, tstate.TrainConfig(**FP32)),
                  (_model(), tstate.TrainConfig(**FP32, debug_nans=True))):
        _, metrics = _run(m, tc, [_torch(_batch())])
        assert np.isfinite(metrics[0]['loss']) and np.isfinite(metrics[0]['grad_norm'])
    # an unknown backward, and K8 (dQ by atomics) under deterministic
    for bad in ({'flash_bwd': 'atomic'}, {'flash_bwd': 'fused', 'deterministic': True}):
        tcb = tstate.TrainConfig(**FP32, **bad)
        with pytest.raises(ValueError):
            tstate.make_train_step(_model(), tstate.make_optimizer(tcb), tcb)


def test_twokernel_backward_is_the_same_step_on_cpu():
    """Both backward variants share the plain version on the CPU."""
    runs = []
    for variant in ('fused', 'twokernel'):
        state, metrics = _run(_model(), tstate.TrainConfig(**FP32, flash_bwd=variant),
                              [_torch(_batch())])
        runs.append((_params(state.model), metrics))
    assert_same_metrics(runs[1][1], runs[0][1])
    assert_same_update(runs[1][0], runs[0][0], _params(_model()))


def test_train_after_an_inference_render():
    """Tables that a render caches on the device under inference mode are
    then used by a train step's autograd graph."""
    from renderformer_tpu_torch import RenderingPipeline
    b = _batch(seed=3)
    RenderingPipeline(_model(seed=1), device='cpu').render(
        b['triangles'], b['texture'], b['mask'], b['vn'], b['c2w'], b['fov'],
        resolution=RES, precision='fp32')
    _, metrics = _run(_model(), tstate.TrainConfig(**FP32), [_torch(b)])
    assert np.isfinite(metrics[0]['loss'])
