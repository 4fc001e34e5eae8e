"""``python -m renderformer_tpu_torch.train`` at the tiny config on the CPU:
two epochs from a YAML file on a dataset of H5 scenes, with the losses of
the JAX package's ``RenderFormerTrainer`` on the same weights and scenes;
and the trainer's contracts around it: the compact texture, ``debug_nans``
and the SIGTERM checkpoint.

The weights are the port's seeded init, which convert.py carries to the
JAX tree (a JAX init compiles every random op of the tree on its first
call)."""

import functools
import importlib.util
import json
import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from renderformer_tpu import RenderFormerConfig as JaxConfig
from renderformer_tpu.models.renderformer import RenderFormer as JaxRenderFormer
from renderformer_tpu.training import state as jstate
from renderformer_tpu.training.dataset import RenderFormerDataset as JaxDataset
import renderformer_tpu.training.trainer as jtrainer
from renderformer_tpu.training.trainer import RenderFormerTrainer as JaxTrainer
from renderformer_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from renderformer_tpu_torch import RenderFormerConfig, train
from renderformer_tpu_torch.convert import state_dict_to_jax_params
from renderformer_tpu_torch.models.renderformer import RenderFormer
from renderformer_tpu_torch.nn.core import init_weights
from renderformer_tpu_torch.training import state as tstate
from renderformer_tpu_torch.training.checkpoint import export_params
from renderformer_tpu_torch.training.dataset import RenderFormerDataset, expand_texture_flat
from renderformer_tpu_torch.training.trainer import RenderFormerTrainer, TrainerConfig
from tests.test_torch_dataset import write_scenes

TINY = dict(latent_dim=72, num_layers=2, num_heads=2, dim_feedforward=144,
            num_register_tokens=4, vertex_pe_num_freqs=4,
            view_transformer_latent_dim=72, view_transformer_ffn_hidden_dim=144,
            view_transformer_n_heads=2, view_transformer_n_layers=4,
            dpt_features=16, dpt_out_channels=[8, 16, 32, 64])
RES = 32
# Adam moves an entry whose gradient is at the fp32 noise of its sum by up to
# lr either way (tests/test_torch_train.py, assert_same_update): at 1e-3 four
# steps put 3e-5 between the two frameworks' epoch means, at 1e-4 under 1e-5
LR = 1e-4
# five compact one-view scenes (one train signature), one of them without GT
SCENES = [(6, 1, True, 48), (10, 1, True, 32), (8, 1, True, None), (12, 1, True, 16),
          (9, 1, True, 40)]


def _config(tmp_path, model_dir, data):
    return {'training': {'num_epochs': 2, 'learning_rate': LR, 'weight_decay': 1e-4,
                         'max_grad_norm': 1.0, 'batch_size': 1},
            'data': {'h5_dir': data, 'gt_dir': data, 'max_resolution': RES,
                     'train_val_split': 0.8},
            'model': {'model_id': model_dir},
            'output': {'checkpoint_dir': str(tmp_path / 'ckpt'),
                       'log_dir': str(tmp_path / 'runs'), 'save_interval': 1},
            'memory': {'autocast_dtype': 'float32', 'use_gradient_checkpointing': False},
            'distributed': {'backend': 'nccl'}}


def test_cli_trains_two_epochs_as_the_jax_trainer(tmp_path, monkeypatch, capsys):
    data = str(tmp_path / 'data')
    os.makedirs(data)
    write_scenes(data, SCENES, seed=3)
    model = _model()
    params = jax.tree.map(lambda a: jnp.asarray(np.array(a)),
                          state_dict_to_jax_params(model.state_dict()))
    model_dir = str(tmp_path / 'model')
    export_params(model_dir, model, model.config)
    cfg = _config(tmp_path, model_dir, data)
    with open(tmp_path / 'config.yml', 'w') as f:
        yaml.safe_dump(cfg, f)
    # the YAML's float32 keeps the reference's bf16 view stage; both trainers
    # run it in fp32 here, so that the two agree to fp32 summation order
    monkeypatch.setattr(train, 'TrainConfig',
                        functools.partial(tstate.TrainConfig, view_precision='float32'))
    assert train.main(['-c', str(tmp_path / 'config.yml'), '--cpu']) == 0
    out = capsys.readouterr().out
    assert 'distributed' in out and 'final train losses' in out
    for tag in ('best', 'epoch_0', 'epoch_1', 'final'):
        assert (tmp_path / 'ckpt' / tag / 'state.pt').exists(), tag
    assert ((tmp_path / 'runs' / 'training_losses.png').exists()
            or 'loss plot skipped' in out)
    # TensorBoard scalars, where it imports (the card's machine has none)
    tb = importlib.util.find_spec('tensorboard') is not None
    assert not tb or any(f.startswith('events.') for f in os.listdir(tmp_path / 'runs'))
    with open(tmp_path / 'ckpt' / 'final' / 'renderformer_meta.json') as f:
        got = json.load(f)['extra']

    jcfg = JaxTrainerConfig(
        train=jstate.TrainConfig(learning_rate=LR, weight_decay=1e-4, max_grad_norm=1.0,
                                 num_epochs=2, precision='float32', view_precision='float32',
                                 resolution=RES),
        batch_size=1, train_val_split=0.8, checkpoint_dir=str(tmp_path / 'jax_ckpt'),
        log_dir=str(tmp_path / 'jax_runs'), save_interval=1000, attn_impl='xla')
    # the reference's losses alone are compared: its orbax checkpoints
    # (~35 s here) are not written
    monkeypatch.setattr(jtrainer, 'save_checkpoint', lambda *a, **k: None)
    want = JaxTrainer(JaxRenderFormer(JaxConfig(**TINY)), params, JaxDataset(h5_dir=data, gt_dir=data, max_resolution=RES),
                      jcfg).fit()
    assert len(got['train_losses']) == len(got['val_losses']) == 2
    for k in ('train_losses', 'val_losses'):
        # fp32, the same steps up to summation order (the JAX run's 8 CPU
        # devices split the ray tokens)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert got['train_losses'][1] < got['train_losses'][0]


def _model(seed=0, **kw):
    return init_weights(RenderFormer(RenderFormerConfig(**{**TINY, **kw})),
                        torch.Generator().manual_seed(seed))


def _scene_batch(tmp_path, scenes):
    data = str(tmp_path / 'data')
    os.makedirs(data)
    write_scenes(data, scenes, seed=4)
    ds = RenderFormerDataset(h5_dir=data, gt_dir=data, max_resolution=RES)
    return ds, {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in next(ds.batches([0], 1, shuffle=False)).items()}


def test_compact_texture_step_equals_full(tmp_path):
    _, batch = _scene_batch(tmp_path, [(7, 1, True, 32)])
    full = dict(batch)
    flat = full.pop('texture_flat')
    full['texture'] = torch.from_numpy(expand_texture_flat(flat.numpy(), 32))
    model = _model()
    tc = tstate.TrainConfig(precision='float32', view_precision='float32', resolution=RES)
    state = tstate.TrainState.create(model, tstate.make_optimizer(tc), tc)
    loss_and_grads = tstate.make_loss_fns(model, tc)[1]
    (la, ga), (lb, gb) = loss_and_grads(state, batch), loss_and_grads(state, full)
    assert torch.equal(la, lb)
    # the same computation; the CPU's threaded sums alone move the gradients
    for a, b in zip(ga, gb):
        assert float((a - b).norm()) <= 1e-5 * float(b.norm())


def test_patch_size_mismatch_raises(tmp_path):
    ds, _ = _scene_batch(tmp_path, [(7, 1, True, 32)])
    with pytest.raises(ValueError, match='texture_encode_patch_size'):
        RenderFormerTrainer(_model(texture_encode_patch_size=16), TrainerConfig(),
                            device='cpu', dataset=ds)


def test_debug_nans_raises_in_forward_and_backward(tmp_path):
    _, batch = _scene_batch(tmp_path, [(7, 1, True, 32)])
    batch['gt'] = batch['gt'].clone()
    batch['gt'][0, 0, 3, 4, 1] = float('nan')
    for debug in (True, False):
        model = _model()
        tc = tstate.TrainConfig(precision='float32', view_precision='float32',
                                resolution=RES, debug_nans=debug)
        state = tstate.TrainState.create(model, tstate.make_optimizer(tc), tc)
        before = [p.detach().clone() for p in model.parameters()]
        step = tstate.make_train_step(model, tstate.make_optimizer(tc), tc)[0]
        if debug:
            with pytest.raises(FloatingPointError, match='nan'):
                step(state, batch)
        else:
            _, m = step(state, batch)  # the NaN skip: no update
            assert not np.isfinite(m['loss'])
            assert all(torch.equal(a, p) for a, p in zip(before, model.parameters()))
    # a NaN that only the backward makes: d(x sqrt x)/dx at 0 is 0 * inf
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(FloatingPointError):
        with tstate.nan_check(True):
            torch.autograd.grad((x * torch.sqrt(x)).sum(), x)
    # and no mode is left on after the block
    assert torch.isnan(torch.autograd.grad((x * torch.sqrt(x)).sum(), x)[0]).all()


def test_sigterm_saves_preempted_and_restores_the_handler(tmp_path):
    assert threading.current_thread() is threading.main_thread()
    calls = []

    def previous(signum, frame):
        calls.append(signum)

    old = signal.signal(signal.SIGTERM, previous)
    try:
        _, batch = _scene_batch(tmp_path, [(7, 1, True, 32)])
        cfg = TrainerConfig(train=tstate.TrainConfig(
            precision='float32', view_precision='float32', resolution=RES, num_epochs=3),
            checkpoint_dir=str(tmp_path / 'ckpt'), save_interval=100)
        tr = RenderFormerTrainer(_model(), cfg, steps_per_epoch=1, device='cpu',
                                 log=lambda *a: None)

        def batches(epoch):
            if epoch == 1:
                # the handler fit() installed, as a SIGTERM would run it
                signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
            return [batch]

        with pytest.raises(SystemExit) as e:
            tr.fit(batches)
        assert e.value.code == 143
        assert (tmp_path / 'ckpt' / 'preempted' / 'state.pt').exists()
        with open(tmp_path / 'ckpt' / 'preempted' / 'renderformer_meta.json') as f:
            assert json.load(f)['extra']['epoch'] == 0
        assert signal.getsignal(signal.SIGTERM) is previous and not calls
    finally:
        signal.signal(signal.SIGTERM, old)
