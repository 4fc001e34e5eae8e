"""Tracing and throughput counters (the JAX package's ``utils/profiling.py``).

* :func:`trace`: a ``torch.profiler`` session around a block (the CPU, and
  CUDA where there is a card) that writes a Chrome/TensorBoard trace,
  ``<host>_<pid>.<time>.pt.trace.json``, into its directory;
* :func:`annotate`: a named range in that trace (``record_function``),
  on the clock of the device events, while a profiler session is on; with
  none on it costs one read of the profiler's flag and enters nothing.
  The port's spans: ``rf.render`` (``RenderingPipeline.render`` and
  ``render_many``) around ``rf.render.upload`` (the inputs to the device);
  ``rf.model.encoder`` (stage 1), ``rf.model.view`` (stage 2) around
  ``rf.model.dpt`` (the DPT head); and a train step's ``rf.train.forward``,
  ``rf.train.backward`` (``autograd.grad`` and the fp32 gradients) and
  ``rf.train.optimizer`` (all-reduce, norm, NaN skip, clip, AdamW);
* :class:`ThroughputMeter`: rays/s and tokens/s of the inference CLIs from
  host-clock windows.  A window is what the caller puts between ``start``
  and ``stop``; the meter synchronises nothing, so a window measures the
  device only where the caller's work ends in a fetch or a synchronise.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str = 'runs/trace'):
    """Profile the block and write its trace into ``log_dir``; yields the
    ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as p:
        yield p
        if torch.cuda.is_available():
            torch.cuda.synchronize()


_NULL = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def annotate(name: str):
    """A context manager: a named range of the block in the profiler's trace
    while a session is on, else a shared null context."""
    if not _profiler_enabled():
        return _NULL
    return torch.profiler.record_function(name)


@dataclass
class ThroughputMeter:
    """Accumulates per-step timings and derives rays/s + tokens/s."""

    resolution: int = 512
    views_per_step: int = 1
    batch_size: int = 1
    triangle_tokens: int = 0
    _times: List[float] = field(default_factory=list)
    _t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is None:
            raise RuntimeError('stop() without start()')
        self._times.append(time.perf_counter() - self._t0)
        self._t0 = None

    @property
    def rays_per_step(self) -> int:
        return self.batch_size * self.views_per_step * self.resolution ** 2

    @property
    def ray_tokens_per_step(self) -> int:
        return self.batch_size * self.views_per_step * (self.resolution // 8) ** 2

    def summary(self, warmup: int = 1) -> Dict[str, float]:
        times = self._times[warmup:] if len(self._times) > warmup else self._times
        if not times:
            return {}
        dt = sum(times) / len(times)
        # the median is robust to one-time tails the fixed warm-up cannot
        # know about; statistics.median averages the two middle samples of
        # an even count (a 3-batch run has 2 windows after the warm-up)
        med = statistics.median(times)
        return {
            'steps': len(times),
            'mean_step_s': dt,
            'median_step_s': med,
            'rays_per_s': self.rays_per_step / dt,
            'rays_per_s_median': self.rays_per_step / med,
            'ray_tokens_per_s': self.ray_tokens_per_step / dt,
            'triangle_tokens_per_s': self.batch_size * self.triangle_tokens / dt,
        }
