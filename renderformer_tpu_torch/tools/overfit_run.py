"""Convergence run on the card (the JAX package's ``tools/overfit_run.py``,
the hardware twin of ``tests/test_convergence.py``): fine-tuning must
LEARN, not only stay finite.

Protocol: self-generated ground truth, no renderer outside the repo and no
trained weights needed.

  1. N camera-orbit frames of an example scene (``make_video_frames``:
     real geometry inside the trained envelope);
  2. the TEACHER, the seeded init, renders each frame's ground truth in
     fp32 through the kernels' plain versions (``ops.reference_kernels``,
     the numerical reference path), written as uint8 PNGs;
  3. the STUDENT is the teacher plus relative noise (sigma 0.1), drawn by
     ``np.random.default_rng(7)`` leaf by leaf in the JAX tree's order and
     shapes, so that for the same teacher it is the JAX tool's student;
  4. the student fine-tunes on the MSE objective (batch 1, lr 3e-5, no
     warm-up) through the port's trainer and dataset, and the loss must
     collapse: all finite, the last epoch below half the first, and every
     epoch from the third on below the first.

    python -m renderformer_tpu_torch.tools.overfit_run [--res 256] [--scenes 8] \
        [--epochs 8] [--preset v1-base] [--precision bfloat16] [--workdir DIR] \
        [--artifacts] [--cpu]
    python -m renderformer_tpu_torch.tools.overfit_run --res 64 --scenes 2 --epochs 2 \
        --preset tiny --cpu            # a CPU smoke

On the card unless given ``--cpu`` (then batch 2, as the JAX tool's CPU
run).  The frames stay in memory (``training.dataset.InMemoryDataset``:
the items are those of their H5 files, so no ``h5py`` is needed); the
ground truth PNGs go to ``WORKDIR/data``.
``--artifacts`` writes ``training_losses.png`` and ``overfit_run.json``
into ``--workdir`` (default: under the system's temporary directory).
Prints one JSON line of the run, then the verdict; exit code 1 when the
loss did not converge.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the JAX tool's 'tiny' preset
TINY = dict(latent_dim=72, num_layers=2, num_heads=2, dim_feedforward=144,
            num_register_tokens=4, vertex_pe_num_freqs=4, view_transformer_latent_dim=72,
            view_transformer_ffn_hidden_dim=144, view_transformer_n_heads=2,
            view_transformer_n_layers=4, dpt_features=16, dpt_out_channels=[8, 16, 32, 64])


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--preset', default='v1-base',
                    help="'v1-base' | 'v1.1-swin-large' | 'tiny'")
    ap.add_argument('--res', type=int, default=256)
    ap.add_argument('--scenes', type=int, default=8)
    ap.add_argument('--epochs', type=int, default=8)
    ap.add_argument('--lr', type=float, default=3e-5)
    ap.add_argument('--sigma', type=float, default=0.1)
    ap.add_argument('--workdir', default=os.path.join(tempfile.gettempdir(), 'rf_overfit'))
    ap.add_argument('--scene', default=os.path.join(REPO, 'examples', 'cbox.json'))
    ap.add_argument('--cpu', action='store_true')
    ap.add_argument('--precision', default='bfloat16', choices=['bfloat16', 'float32'])
    ap.add_argument('--artifacts', action='store_true',
                    help='write training_losses.png and overfit_run.json into --workdir')
    return ap


def model_config(preset: str):
    from renderformer_tpu_torch.config import PRESETS, RenderFormerConfig
    return RenderFormerConfig(**TINY) if preset == 'tiny' else PRESETS[preset]


def seeded_model(cfg, state_dict=None):
    """A model of ``cfg`` on the CPU: the seeded init (seed 0), or
    ``state_dict`` loaded."""
    import torch
    from renderformer_tpu_torch.models.renderformer import RenderFormer
    from renderformer_tpu_torch.nn.core import init_weights
    with torch.device('meta'):
        model = RenderFormer(cfg)
    if state_dict is None:
        return init_weights(model.to_empty(device='cpu'), torch.Generator().manual_seed(0))
    model.load_state_dict({k: v.detach().float().cpu() for k, v in state_dict.items()},
                          strict=True, assign=True)
    return model


def _jax_leaves(tree, path=()):
    """(path, leaf) of a JAX parameter tree in jax.tree's order: a dict's
    keys sorted, a list's items by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jax_leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _jax_leaves(v, path + (i,))
    else:
        yield path, tree


def _set_leaf(tree, path, value):
    for p in path[:-1]:
        tree = tree[p]
    tree[path[-1]] = value


def perturb(state_dict, sigma: float, seed: int = 7):
    """The student's state_dict: every leaf p of the JAX tree of
    ``state_dict`` plus N(0, 1) * sigma * (std(p) + 1e-3), drawn by
    ``np.random.default_rng(seed)`` leaf by leaf in jax.tree's order and
    shape, the noise rounded to fp32 before the fp32 add (the JAX tool's
    ``jax.tree.map(perturb, w_teacher)``)."""
    from renderformer_tpu_torch.convert import (
        jax_params_to_state_dict, state_dict_to_jax_params)
    tree = state_dict_to_jax_params(state_dict)
    rng = np.random.default_rng(seed)
    for path, p in list(_jax_leaves(tree)):
        p = np.asarray(p)
        scale = sigma * float(np.std(p) + 1e-3)
        _set_leaf(tree, path, p + (rng.normal(size=p.shape) * scale).astype(p.dtype))
    return jax_params_to_state_dict(tree)


def scene_dataset(frames, data_dir: str, res: int):
    """The frames as the trainer's dataset, in memory, their ground truth
    PNGs in ``data_dir``."""
    from renderformer_tpu_torch.tools.make_video_frames import frame_name
    from renderformer_tpu_torch.training.dataset import InMemoryDataset
    os.makedirs(data_dir, exist_ok=True)
    return InMemoryDataset({frame_name(i): fr for i, fr in enumerate(frames)}, data_dir, res)


def teacher_gt(model, dataset, res: int, device):
    """Each item of ``dataset`` rendered by ``model`` in fp32 through the
    kernels' plain versions, written as ``<gt_dir>/<stem>.png`` (clipped
    to [0, 1], uint8); returns the HDR images [res, res, 3]."""
    import torch
    from renderformer_tpu_torch.io.image import write_png
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.pipelines.rendering_pipeline import render_fn
    from renderformer_tpu_torch.training.dataset import expand_texture_flat
    model = model.to(device).float().eval()
    images = []
    for i in range(len(dataset)):
        item = dataset[i]
        if 'texture_flat' in item:  # the compact per-face form
            item['texture'] = expand_texture_flat(item.pop('texture_flat'))
        args = [torch.from_numpy(np.asarray(item[k])).to(device)[None]
                for k in ('triangles', 'texture', 'mask', 'vn', 'c2w', 'fov')]
        args[1] = args[1].float()
        with torch.inference_mode(), reference_kernels():
            img = render_fn(model, *args, resolution=res)[0, 0].float().cpu().numpy()
        images.append(img)
        stem = os.path.splitext(os.path.basename(dataset.h5_files[i]))[0]
        write_png(os.path.join(dataset.gt_dir, f'{stem}.png'),
                  (np.clip(img, 0, 1) * 255).astype(np.uint8))
    return images


def converged(losses) -> bool:
    """The JAX tool's pass condition."""
    return bool(np.all(np.isfinite(losses)) and losses[-1] < 0.5 * losses[0]
                and (len(losses) < 3 or max(losses[2:]) < losses[0]))


def run(args, frames=None, trainer_hook=None, log=print):
    """The protocol of the module docstring for parsed ``args``; returns a
    dict: ``out`` (the JSON line's fields, the JAX tool's keys),
    ``teacher_images``, ``student`` (its state_dict before the fit),
    ``step_losses``, ``trainer``, ``fit_s`` and ``ok``.  ``frames``: the
    orbit frames instead of ``make_video_frames.orbit_frames(args.scene,
    args.scenes)``; ``trainer_hook(trainer)`` runs before the fit."""
    import torch
    from renderformer_tpu_torch.pipelines.rendering_pipeline import resolve_device
    from renderformer_tpu_torch.tools.make_video_frames import orbit_frames
    from renderformer_tpu_torch.training.state import TrainConfig
    from renderformer_tpu_torch.training.trainer import RenderFormerTrainer, TrainerConfig

    device = resolve_device('cpu' if args.cpu else None)
    t_start = time.perf_counter()
    data_dir = os.path.join(args.workdir, 'data')
    if os.path.isdir(data_dir):
        shutil.rmtree(data_dir)
    if frames is None:
        frames = orbit_frames(args.scene, args.scenes, 360.0)
    dataset = scene_dataset(frames, data_dir, args.res)

    cfg = model_config(args.preset)
    teacher_model = seeded_model(cfg)
    images = teacher_gt(teacher_model, dataset, args.res, device)
    log(f'teacher GT: {len(dataset)} frames at {args.res}^2')
    w_student = perturb(teacher_model.state_dict(), args.sigma)
    del teacher_model
    if device.type == 'cuda':
        torch.cuda.empty_cache()

    dataset = scene_dataset(frames, data_dir, args.res)  # the GT read afresh
    tcfg = TrainerConfig(
        train=TrainConfig(num_epochs=args.epochs, precision=args.precision,
                          resolution=args.res, learning_rate=args.lr, warmup_steps=0),
        batch_size=2 if args.cpu else 1,  # the reference fine-tunes at batch 1
        train_val_split=1.0,
        checkpoint_dir=os.path.join(args.workdir, 'ckpt'),
        log_dir=os.path.join(args.workdir, 'tb'),
        save_interval=10 ** 6,
        log_every=1)
    # the trainer updates its parameters in place: w_student stays as drawn
    student = seeded_model(cfg, {k: v.clone() for k, v in w_student.items()})
    trainer = RenderFormerTrainer(student, tcfg, device=device,
                                  log=log, dataset=dataset)
    if trainer_hook is not None:
        trainer_hook(trainer)

    t_fit = time.perf_counter()
    result = trainer.fit()
    fit_s = time.perf_counter() - t_fit

    losses = [float(x) for x in result['train_losses']]
    steps_total = args.epochs * (len(dataset) // tcfg.batch_size)
    recovery = losses[-1] / losses[0] if losses[0] else float('nan')
    out = {
        'preset': args.preset,
        'platform': device.type,
        'resolution': args.res,
        'scenes': len(dataset),
        'padding_length': dataset.padding_length,
        'epochs': args.epochs,
        'batch_size': tcfg.batch_size,
        'precision': args.precision,
        'lr': args.lr,
        'sigma': args.sigma,
        'loss_first_epoch': losses[0],
        'loss_last_epoch': losses[-1],
        'recovery_ratio': recovery,
        'losses': losses,
        'fit_wall_s': round(fit_s, 2),
        'steps_total': steps_total,
        'wall_s_total': round(time.perf_counter() - t_start, 2),
    }
    return {'out': out, 'teacher_images': images, 'student': w_student,
            'step_losses': [m['loss'] for m in trainer.step_metrics], 'trainer': trainer,
            'ok': converged(losses), 'fit_s': fit_s}


def main(argv=None):
    args = build_parser().parse_args(argv)
    res = run(args, log=lambda *a: print(*a, flush=True))
    out, losses = res['out'], res['out']['losses']
    print(json.dumps(out), flush=True)
    if args.artifacts:
        src = os.path.join(args.workdir, 'tb', 'training_losses.png')
        if os.path.exists(src):
            shutil.copy(src, os.path.join(args.workdir, 'training_losses.png'))
        with open(os.path.join(args.workdir, 'overfit_run.json'), 'w') as f:
            json.dump(out, f, indent=1)
    if not res['ok']:
        print('CONVERGENCE CHECK FAILED', file=sys.stderr)
        return 1
    print(f'converged: loss {losses[0]:.5f} -> {losses[-1]:.5f} '
          f'({out["recovery_ratio"]:.3f}x) over {args.epochs} epochs x {out["scenes"]} '
          f'steps on {out["platform"]}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
