"""Training loop: epochs, validation, metrics, checkpoints.

The counterpart of ``renderformer_tpu/training/trainer.py``'s
``RenderFormerTrainer``.  Given a :class:`~renderformer_tpu_torch.training.
dataset.RenderFormerDataset`, ``fit()`` splits it, trains each epoch on its
shuffled batches (decoded and pinned on a background thread two batches
ahead, then copied to the device without blocking the host), validates on
batches padded to the batch size, and writes TensorBoard scalars (where
``torch.utils.tensorboard`` imports), the checkpoints 'best', 'epoch_<e>'
and 'final', and ``training_losses.png``.  ``fit(train_batches,
val_batches)`` takes batch dicts from the caller instead, and writes the
checkpoints alone.

Checkpoints are written on a background thread from a snapshot of host
copies taken before the next step, since the step updates the parameters
and the moments in place.  SIGTERM (a preemption) saves 'preempted' and
exits with 143; a SIGTERM during a step lets the step finish first.

In a process group (``parallel.distributed.setup_distributed``, one process
a GPU) rank and world come from the group, and the trainer steps on a
(data, seq) mesh, by default (gcd(batch_size, world), world // data): each
data rank trains on its slice of every global batch (the dataset's
``batches(rank, world)``), the step all-reduces the gradients and the
validation sums over the data ranks, and the seq ranks split the attention
sites.  Prints, TensorBoard, the loss plot and checkpoints are rank 0's,
with a barrier on both sides of a save; the state is the same on every
rank.  SIGTERM ends every rank after its step, rank 0 writing 'preempted'.
"""

from __future__ import annotations

import dataclasses
import math
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from renderformer_tpu_torch.parallel.distributed import rank_and_world
from renderformer_tpu_torch.parallel.sharding import axis_index, axis_size, make_mesh
from renderformer_tpu_torch.pipelines.rendering_pipeline import resolve_device
from renderformer_tpu_torch.training.checkpoint import (
    load_checkpoint, snapshot, write_checkpoint)
from renderformer_tpu_torch.training.state import (
    TrainConfig, TrainState, make_optimizer, make_train_step)
from renderformer_tpu_torch.utils.prefetch import AsyncWriter, prefetch

Batches = Union[Iterable[Dict[str, Any]], Callable[[int], Iterable[Dict[str, Any]]]]


@dataclasses.dataclass
class TrainerConfig:
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    checkpoint_dir: str = 'checkpoints'
    save_interval: int = 5
    resume_from: Optional[str] = None
    log_every: int = 10   # steps between printed and logged metrics
    batch_size: int = 1
    train_val_split: float = 0.8
    log_dir: str = 'runs/renderformer_tpu'   # TensorBoard and the loss plot
    seed: int = 42        # the split, and the shuffle of epoch e by seed + e
    mesh_shape: Optional[tuple] = None   # (data, seq); None -> (gcd(batch, world), rest)


def _quiet(*args, **kwargs):
    pass


class _NullWriter:
    def add_scalar(self, *args, **kwargs):
        pass

    def close(self):
        pass


class RenderFormerTrainer:
    """Trains ``model`` (fp32 masters, moved to ``device``) with the train
    step of ``cfg.train``: on ``dataset``, whose length sets the schedule's
    steps per epoch and whose ``max_resolution`` the resolution, or on
    batches given to :meth:`fit`, with ``steps_per_epoch`` given here.
    Runs on ``cuda`` unless given ``device='cpu'``; in a process group, on
    the mesh of ``cfg.mesh_shape`` (the module docstring)."""

    def __init__(self, model, cfg: TrainerConfig, steps_per_epoch: Optional[int] = None,
                 device=None, log=print, dataset=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.rank, self.world = rank_and_world()
        self.is_main = self.rank == 0
        self.log = log if self.is_main else _quiet
        self.dataset = dataset
        self.mesh = None
        if dist.is_initialized():
            data = math.gcd(cfg.batch_size, self.world)
            self.mesh = make_mesh(cfg.mesh_shape or (data, self.world // data))
        elif cfg.mesh_shape is not None and math.prod(cfg.mesh_shape) != 1:
            raise ValueError(f'mesh_shape {cfg.mesh_shape} needs a process group of '
                             f'{math.prod(cfg.mesh_shape)} ranks')
        self.data_rank, self.data_world = ((axis_index(self.mesh, 'data'),
                                            axis_size(self.mesh, 'data'))
                                           if self.mesh is not None else (0, 1))
        tc = cfg.train
        if dataset is not None:
            ps = model.config.texture_encode_patch_size
            if dataset.texture_patch_size not in (None, ps):
                raise ValueError(f'the dataset\'s texture patches are {dataset.texture_patch_size}'
                                 f'^2, the model encodes {ps}^2 (texture_encode_patch_size)')
            steps_per_epoch = len(dataset) // max(cfg.batch_size, 1)
            tc = dataclasses.replace(tc, resolution=dataset.max_resolution)
        elif steps_per_epoch is None:
            raise ValueError('steps_per_epoch is needed without a dataset')
        self.model = model.to(self.device).train()
        self.tc = dataclasses.replace(tc, steps_per_epoch=max(1, steps_per_epoch))
        self.tx = make_optimizer(self.tc)
        self.state = TrainState.create(self.model, self.tx, self.tc)
        self._train_step, self._eval_step = make_train_step(self.model, self.tx, self.tc,
                                                            self.mesh)
        self.train_losses: List[float] = []
        self.val_losses: List[float] = []
        self.step_metrics: List[Dict[str, float]] = []
        self.start_epoch = 0
        self._writer = None
        self._ckpt_writer: Optional[AsyncWriter] = None
        self._in_step = False
        self._preempt = False
        if cfg.resume_from:
            self.state, meta = load_checkpoint(cfg.resume_from, self.state)
            extra = meta.get('extra', {})
            self.start_epoch = int(extra.get('epoch', -1)) + 1
            self.train_losses = list(extra.get('train_losses', []))
            self.val_losses = list(extra.get('val_losses', []))
            self.log(f'resumed from {cfg.resume_from} at epoch {self.start_epoch}')

    @property
    def writer(self):
        """TensorBoard's SummaryWriter on ``log_dir``, or a writer that
        drops everything where ``torch.utils.tensorboard`` does not import
        and on every rank but 0."""
        if self._writer is None:
            if not self.is_main:
                self._writer = _NullWriter()
                return self._writer
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._writer = SummaryWriter(self.cfg.log_dir)
            except Exception:
                self._writer = _NullWriter()
        return self._writer

    # --- batches to the device ---------------------------------------------
    def _host(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """CPU tensors of a batch, in pinned memory when the device is CUDA."""
        out = {}
        for k, v in batch.items():
            t = v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))
            pin = self.device.type == 'cuda' and t.is_cpu and not t.is_pinned()
            out[k] = t.pin_memory() if pin else t
        return out

    def _put(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: v.to(self.device, non_blocking=True) for k, v in batch.items()}

    def _dataset_batches(self, indices, **kw):
        """The dataset's batches of ``indices``, decoded and pinned on a
        background thread two batches ahead."""
        return prefetch((self._host(b) for b in self.dataset.batches(
            indices, self.cfg.batch_size, rank=self.data_rank, world=self.data_world,
            **kw)), depth=2)

    # --- epochs --------------------------------------------------------------
    def train_epoch(self, epoch: int, indices) -> float:
        """One epoch over the dataset's ``indices``, shuffled by
        ``seed + epoch``; returns the mean finite loss."""
        return self.run_epoch(epoch, self._dataset_batches(
            indices, shuffle=True, seed=self.cfg.seed + epoch))

    def validate(self, epoch: int, indices) -> float:
        """The mean loss of the dataset's ``indices``, every item counted
        once (the last batch padded, its padding weighted 0)."""
        return self.evaluate(epoch, self._dataset_batches(indices, shuffle=False,
                                                          pad_last=True))

    def run_epoch(self, epoch: int, batches: Iterable[Dict[str, Any]]) -> float:
        """One pass over ``batches``; returns the mean finite loss."""
        t0 = time.time()
        every = max(1, self.cfg.log_every)
        total, n = 0.0, 0
        for i, batch in enumerate(batches):
            batch = self._put(self._host(batch))
            self._in_step = True
            try:
                self.state, m = self._train_step(self.state, batch)
            finally:
                self._in_step = False
            if self._preempt:
                self._save_preempted()
            self.step_metrics.append(m)
            if math.isfinite(m['loss']):
                total += m['loss']
                n += 1
            if i % every == 0:
                self.log(f'  epoch {epoch} batch {i}: loss={m["loss"]:.6f} '
                         f'gnorm={m["grad_norm"]:.4f} ({time.time() - t0:.1f}s)')
                self.writer.add_scalar('Loss/Train_Batch', m['loss'], self.state.step)
                self.writer.add_scalar('Grad_Norm/Train', m['grad_norm'], self.state.step)
        avg = total / n if n else float('inf')
        self.train_losses.append(avg)
        self.writer.add_scalar('Loss/Train_Epoch', avg, epoch)
        return avg

    def evaluate(self, epoch: int, batches: Iterable[Dict[str, Any]]) -> float:
        """Mean per-sample loss over ``batches``, each sample weighted by the
        batch's optional ``valid`` mask."""
        total, n = 0.0, 0.0
        for batch in batches:
            m = self._eval_step(self.state, self._put(self._host(batch)))
            if math.isfinite(m['loss_sum']):
                total += m['loss_sum']
                n += m['n']
        avg = total / n if n else float('inf')
        self.val_losses.append(avg)
        self.writer.add_scalar('Loss/Val_Epoch', avg, epoch)
        return avg

    # --- checkpoints -----------------------------------------------------------
    def _extra(self, epoch: int) -> Dict[str, Any]:
        return {'epoch': epoch, 'train_losses': list(self.train_losses),
                'val_losses': list(self.val_losses)}

    def save(self, tag: str, epoch: int) -> Optional[str]:
        """Save now, on this thread, on rank 0; returns the path (None on
        the other ranks)."""
        if not self.is_main:
            return None
        return write_checkpoint(self.cfg.checkpoint_dir, tag, snapshot(self.state),
                                self.model.config, self._extra(epoch))

    def _save_async(self, tag: str, epoch: int) -> None:
        """Snapshot now, write on the background writer; in a group of more
        than one rank, rank 0 writes on this thread between two barriers."""
        if self.world > 1:
            dist.barrier()
            self.save(tag, epoch)
            dist.barrier()
            return
        self._ckpt_writer.submit(write_checkpoint, self.cfg.checkpoint_dir, tag,
                                 snapshot(self.state), self.model.config, self._extra(epoch))

    def _save_preempted(self):
        self.log('SIGTERM: saving preemption checkpoint...')
        try:
            self.save('preempted', len(self.train_losses) - 1)
        finally:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
        raise SystemExit(143)

    def _on_sigterm(self, signum, frame):
        if self._in_step:
            self._preempt = True  # saved once the step's in-place update is whole
            return
        self._save_preempted()

    # --- the loop --------------------------------------------------------------
    def fit(self, train_batches: Optional[Batches] = None,
            val_batches: Optional[Batches] = None) -> Dict[str, List[float]]:
        """Epochs ``start_epoch .. num_epochs - 1`` on the dataset, or on
        ``train_batches`` and ``val_batches``: each a re-iterable (a list)
        or a callable of the epoch that returns an iterable.  Saves 'best'
        on a new best validation loss, 'epoch_<e>' every ``save_interval``
        epochs and 'final' at the end; on SIGTERM (in the main thread) it
        saves 'preempted' and exits with 143."""
        prev = None
        if threading.current_thread() is threading.main_thread():
            prev = signal.signal(signal.SIGTERM, self._on_sigterm)
        self._ckpt_writer = AsyncWriter(max_workers=1, max_pending=2)
        # TensorBoard and the loss plot come with the dataset form
        self._writer = None if self.dataset is not None else _NullWriter()
        try:
            return self._fit(train_batches, val_batches)
        finally:
            self._ckpt_writer.close()
            if self.dataset is not None:
                self.dataset.close()
            if prev is not None:
                signal.signal(signal.SIGTERM, prev)

    def _fit(self, train_batches, val_batches) -> Dict[str, List[float]]:
        if self.dataset is not None:
            if train_batches is not None or val_batches is not None:
                raise ValueError('a trainer with a dataset takes no batches')
            train_idx, val_idx = self.dataset.split(self.cfg.train_val_split, self.cfg.seed)
            self.log(f'training on {len(train_idx)} scenes, validating on {len(val_idx)}'
                     + (f' across {self.world} processes, mesh {tuple(self.mesh.shape)}'
                        if self.world > 1 else ''))

            def train(epoch):
                return self.train_epoch(epoch, train_idx)

            def val(epoch):
                return self.validate(epoch, val_idx) if val_idx else float('inf')
        else:
            def pick(src, epoch):
                return src(epoch) if callable(src) else src

            def train(epoch):
                return self.run_epoch(epoch, pick(train_batches, epoch))

            def val(epoch):
                return (self.evaluate(epoch, pick(val_batches, epoch))
                        if val_batches is not None else float('inf'))

        best = min(self.val_losses, default=float('inf'))
        for epoch in range(self.start_epoch, self.tc.num_epochs):
            train_loss = train(epoch)
            val_loss = val(epoch)
            self.log(f'epoch {epoch}: train={train_loss:.6f} val={val_loss:.6f}')
            if val_loss < best:
                best = val_loss
                self._save_async('best', epoch)
            if (epoch + 1) % self.cfg.save_interval == 0:
                self._save_async(f'epoch_{epoch}', epoch)
        self._save_async('final', self.tc.num_epochs - 1)
        self._ckpt_writer.drain()
        if self.dataset is not None and self.is_main:
            self.plot_losses()
        self.writer.close()
        return {'train_losses': self.train_losses, 'val_losses': self.val_losses}

    def plot_losses(self) -> None:
        """``training_losses.png`` in ``log_dir``: train and validation loss
        by epoch; a note instead where matplotlib is missing."""
        try:
            import matplotlib
            matplotlib.use('Agg')
            import matplotlib.pyplot as plt
            fig, ax = plt.subplots()
            ax.plot(self.train_losses, label='train')
            if self.val_losses:
                ax.plot(self.val_losses, label='val')
            ax.set_xlabel('epoch')
            ax.set_ylabel('MSE loss')
            ax.legend()
            os.makedirs(self.cfg.log_dir, exist_ok=True)
            fig.savefig(os.path.join(self.cfg.log_dir, 'training_losses.png'), dpi=100)
            plt.close(fig)
        except Exception as e:
            self.log(f'loss plot skipped: {e}')
