"""Fine-tuning command line of the port:

    python -m renderformer_tpu_torch.train -c configs/config.yml [--resume DIR] [--cpu]
    torchrun --nproc_per_node=N -m renderformer_tpu_torch.train -c configs/config.yml

It reads the YAML schema of the JAX package's ``train.py`` with the same
defaults: ``training`` (epochs, learning rate, weight decay, grad clip,
batch size), ``data`` (``h5_dir``, ``gt_dir``, ``max_resolution``,
``train_val_split``), ``model.model_id`` (a local checkpoint directory or
a preset), ``output`` (``checkpoint_dir``, ``log_dir``, ``save_interval``)
and ``memory`` (``autocast_dtype``, where float16 means bfloat16;
``use_gradient_checkpointing``, which is remat; ``bf16_shadow_params``).
``distributed.*`` keys are read and ignored: torchrun's environment, not
the YAML, sets the process group.  Under torchrun each process drives the
GPU of its ``LOCAL_RANK`` (NCCL; gloo with ``--cpu``), and the trainer
trains data-parallel on the ranks (``training/trainer.py``); rank 0 prints
and writes.  It runs on ``cuda`` unless given ``--cpu``.  The YAML is read
by the port's ``utils/yaml_config`` and the H5 scenes by its ``io/hdf5``:
neither PyYAML nor h5py is needed.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

from renderformer_tpu_torch.parallel.distributed import (
    process_info, rank_and_world, setup_distributed, teardown_distributed)
from renderformer_tpu_torch.pipelines.rendering_pipeline import RenderingPipeline
from renderformer_tpu_torch.training.dataset import RenderFormerDataset
from renderformer_tpu_torch.training.state import TrainConfig
from renderformer_tpu_torch.training.trainer import RenderFormerTrainer, TrainerConfig
from renderformer_tpu_torch.utils import yaml_config


def load_config(path: str) -> dict:
    return yaml_config.load_file(path) or {}


def make_dataset(cfg: dict) -> RenderFormerDataset:
    d = cfg.get('data', {})
    return RenderFormerDataset(h5_dir=d.get('h5_dir', 'datasets/h5'),
                               gt_dir=d.get('gt_dir', 'datasets/gt'),
                               max_resolution=int(d.get('max_resolution', 256)))


def build(cfg: dict, resume: Optional[str] = None, device=None,
          dataset: Optional[RenderFormerDataset] = None, log=print) -> RenderFormerTrainer:
    """The trainer that ``cfg`` (the YAML as a dict) describes, on
    ``dataset`` or the one its ``data`` section names."""
    t, d, m = cfg.get('training', {}), cfg.get('data', {}), cfg.get('model', {})
    o, mem = cfg.get('output', {}), cfg.get('memory', {})
    if cfg.get('distributed'):
        log(f'distributed: {sorted(cfg["distributed"])} ignored: torchrun\'s environment, '
            f'not the YAML, sets the process group')
    precision = mem.get('autocast_dtype', 'bfloat16')
    if precision == 'float16':
        precision = 'bfloat16'
    train_cfg = TrainConfig(
        learning_rate=float(t.get('learning_rate', 5e-6)),
        weight_decay=float(t.get('weight_decay', 1e-4)),
        max_grad_norm=float(t.get('max_grad_norm', 1.0)),
        num_epochs=int(t.get('num_epochs', 3)),
        precision=precision,
        resolution=int(d.get('max_resolution', 256)),
        remat=bool(mem.get('use_gradient_checkpointing', False)),
        bf16_shadow_params=bool(mem.get('bf16_shadow_params', False)))
    trainer_cfg = TrainerConfig(
        train=train_cfg,
        batch_size=int(t.get('batch_size', 1)),
        train_val_split=float(d.get('train_val_split', 0.8)),
        checkpoint_dir=o.get('checkpoint_dir', 'checkpoints'),
        log_dir=o.get('log_dir', 'runs/renderformer_tpu'),
        save_interval=int(o.get('save_interval', 5)),
        resume_from=resume)
    pipeline = RenderingPipeline.from_pretrained(m.get('model_id', 'v1-base'), device=device)
    if dataset is None:
        dataset = make_dataset(cfg)
    return RenderFormerTrainer(pipeline.model, trainer_cfg, device=device, log=log,
                               dataset=dataset)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description='Fine-tune RenderFormer (PyTorch/CUDA)')
    parser.add_argument('-c', '--config', type=str, default='configs/config.yml')
    parser.add_argument('--resume', type=str, default=None,
                        help='a checkpoint directory to resume from')
    parser.add_argument('--cpu', action='store_true',
                        help='run on the CPU (the plain PyTorch versions of the kernels)')
    args = parser.parse_args(argv)
    device = 'cpu' if args.cpu else None
    distributed = setup_distributed(device=device)
    try:
        is_main = rank_and_world()[0] == 0
        log = print if is_main else (lambda *a, **k: None)
        if distributed:
            log(f'distributed: {process_info()}')
        cfg = load_config(args.config)
        dataset = make_dataset(cfg)
        if len(dataset) == 0:
            log('no training scenes found; check data.h5_dir')
            return 1
        trainer = build(cfg, args.resume, device, dataset, log=log)
        result = trainer.fit()
        log('final train losses:', [round(x, 6) for x in result['train_losses']])
        return 0
    finally:
        if distributed:
            teardown_distributed()


if __name__ == '__main__':
    sys.exit(main())
