"""Training loop on one device: epochs, validation, metrics, checkpoints.

The single-process counterpart of ``renderformer_tpu/training/trainer.py``'s
``RenderFormerTrainer``.  It takes any iterable of batch dicts (numpy
arrays or tensors, the keys of :func:`training.state.make_train_step`), so
the data plane stays outside.  Multi-host, TensorBoard and SIGTERM handling
are not ported.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import numpy as np
import torch

from renderformer_tpu_torch.pipelines.rendering_pipeline import resolve_device
from renderformer_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from renderformer_tpu_torch.training.state import (
    TrainConfig, TrainState, make_optimizer, make_train_step)

Batches = Union[Iterable[Dict[str, Any]], Callable[[int], Iterable[Dict[str, Any]]]]


@dataclasses.dataclass
class TrainerConfig:
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    checkpoint_dir: str = 'checkpoints'
    save_interval: int = 5
    resume_from: Optional[str] = None
    log_every: int = 10   # steps between printed metrics


class RenderFormerTrainer:
    """Trains ``model`` (fp32 masters, moved to ``device``) with the train
    step of ``cfg.train``; ``steps_per_epoch`` sets the schedule's length.
    Runs on ``cuda`` unless given ``device='cpu'``."""

    def __init__(self, model, cfg: TrainerConfig, steps_per_epoch: int, device=None,
                 log=print):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.log = log
        self.model = model.to(self.device).train()
        self.tc = dataclasses.replace(cfg.train, steps_per_epoch=max(1, steps_per_epoch))
        self.tx = make_optimizer(self.tc)
        self.state = TrainState.create(self.model, self.tx, self.tc)
        self._train_step, self._eval_step = make_train_step(self.model, self.tx, self.tc)
        self.train_losses: List[float] = []
        self.val_losses: List[float] = []
        self.step_metrics: List[Dict[str, float]] = []
        self.start_epoch = 0
        if cfg.resume_from:
            self.state, meta = load_checkpoint(cfg.resume_from, self.state)
            extra = meta.get('extra', {})
            self.start_epoch = int(extra.get('epoch', -1)) + 1
            self.train_losses = list(extra.get('train_losses', []))
            self.val_losses = list(extra.get('val_losses', []))
            self.log(f'resumed from {cfg.resume_from} at epoch {self.start_epoch}')

    def _put(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                                   device=self.device) for k, v in batch.items()}

    def train_epoch(self, epoch: int, batches: Iterable[Dict[str, Any]]) -> float:
        """One pass over ``batches``; returns the mean finite loss."""
        t0 = time.time()
        every = max(1, self.cfg.log_every)
        total, n = 0.0, 0
        for i, batch in enumerate(batches):
            self.state, m = self._train_step(self.state, self._put(batch))
            self.step_metrics.append(m)
            if math.isfinite(m['loss']):
                total += m['loss']
                n += 1
            if i % every == 0:
                self.log(f'  epoch {epoch} batch {i}: loss={m["loss"]:.6f} '
                         f'gnorm={m["grad_norm"]:.4f} ({time.time() - t0:.1f}s)')
        avg = total / n if n else float('inf')
        self.train_losses.append(avg)
        return avg

    def validate(self, epoch: int, batches: Iterable[Dict[str, Any]]) -> float:
        """Mean per-sample loss over ``batches``, each sample weighted by the
        batch's optional ``valid`` mask."""
        total, n = 0.0, 0.0
        for batch in batches:
            m = self._eval_step(self.state, self._put(batch))
            if math.isfinite(m['loss_sum']):
                total += m['loss_sum']
                n += m['n']
        avg = total / n if n else float('inf')
        self.val_losses.append(avg)
        return avg

    def _extra(self, epoch: int) -> Dict[str, Any]:
        return {'epoch': epoch, 'train_losses': list(self.train_losses),
                'val_losses': list(self.val_losses)}

    def save(self, tag: str, epoch: int) -> str:
        return save_checkpoint(self.cfg.checkpoint_dir, tag, self.state,
                               self.model.config, self._extra(epoch))

    def fit(self, train_batches: Batches, val_batches: Optional[Batches] = None
            ) -> Dict[str, List[float]]:
        """Epochs ``start_epoch .. num_epochs - 1``.  A batches argument is a
        re-iterable (a list) or a callable of the epoch that returns an
        iterable.  Saves 'best' on a new best validation loss, 'epoch_<e>'
        every ``save_interval`` epochs and 'final' at the end."""
        def epoch_iter(src, epoch):
            return src(epoch) if callable(src) else src

        best = min(self.val_losses, default=float('inf'))
        for epoch in range(self.start_epoch, self.tc.num_epochs):
            train_loss = self.train_epoch(epoch, epoch_iter(train_batches, epoch))
            val_loss = (self.validate(epoch, epoch_iter(val_batches, epoch))
                        if val_batches is not None else float('inf'))
            self.log(f'epoch {epoch}: train={train_loss:.6f} val={val_loss:.6f}')
            if val_loss < best:
                best = val_loss
                self.save('best', epoch)
            if (epoch + 1) % self.cfg.save_interval == 0:
                self.save(f'epoch_{epoch}', epoch)
        self.save('final', self.tc.num_epochs - 1)
        return {'train_losses': self.train_losses, 'val_losses': self.val_losses}
