"""Train state and the train step of the port.

The counterpart of ``renderformer_tpu/training/state.py``: MSE between the
render and the ground-truth images, AdamW with a warmup-cosine schedule and
clipping by global norm, written out so that they compute optax's functions
(``clip_by_global_norm``, ``scale_by_adam``, ``add_decayed_weights``,
``scale_by_learning_rate`` of ``warmup_cosine_decay_schedule``), and the
NaN/Inf skip, which leaves the parameters and the optimizer state (its
count too) as they were while the step counter moves on.

optax's ``adamw`` has no mask, so the JAX package decays every leaf of its
parameter tree, the RoPE base frequencies (``rope_freqs``) too, though no
gradient reaches them on its flash path.  The port keeps them as buffers,
out of autograd and out of the stage casts (:func:`decayed_buffers`), and
its AdamW decays them as optax does a parameter whose gradient is zero.

The fp32 master weights stay in the model.  A step casts them to each
stage's compute dtype inside the autograd graph (``functional_call``), so
the gradients reach the masters; with ``bf16_shadow_params`` it instead
differentiates a copy kept in the compute dtypes and casts the gradients.
Updates run in place on the masters, the optimizer moments and the shadow:
no second copy of the 205M parameters is made.

``TrainConfig.deterministic`` makes a step give the same bits on every run
on one card: the attention backward runs K9 (``'twokernel'``, no atomics)
in place of K8, whose dQ sums by atomics, and cuDNN takes deterministic
algorithms for the DPT convs (its default input gradient sums in a
run-dependent order).  The rest of the step gives the same bits anyway:
the hand-written kernels write each output once in a fixed order, and the
DPT tail's border lerp has a VJP by one matrix product
(``ops/fused_resize.py:resize_axis``).

Dropout (a model config with ``dropout > 0``) draws its masks from
``DropoutKey(TrainConfig.seed, step)``, as the JAX package folds the step
into ``key(seed)``: a step draws the same masks after a resume, and a
recomputed remat block the masks of its forward.  A batch may carry the
compact texture ``texture_flat`` [B, N, 13] in place of ``texture``; the
step broadcasts it on the device with the patch mask.  ``debug_nans``
raises ``FloatingPointError`` at the first operation of a step's forward
or backward that makes a NaN, as ``jax_debug_nans`` does, and only inside
the step.

Data-parallel steps (a ``mesh`` of the process group's ranks): each data
rank renders its own slice of the global batch; before the global norm the
step all-reduces the gradients and the loss as one flat fp32 bucket, their
mean over the mesh's ``data`` axis, so every rank reads the same loss and
norm and takes the same NaN-skip and clip decision (the JAX step reads them
of the global batch).  The attention sites split over the ``seq`` axis
(sequence-split attention), whose ranks then hold the same gradients.
A group of one rank still runs the all-reduce; without a mesh there is none.

On the card a step replays CUDA graphs of its forward and its backward
(``TrainConfig.cuda_graphs``, where :func:`graphs_apply` passes): the
first step of each batch signature (:func:`batch_signature`) runs them
once eagerly on a side stream, captures each as a graph, both in one
memory pool, and replays them, as every later step of that signature
does after copying its batch into the graphs' static inputs.  Autograd's
thread and remat's recomputation then launch nothing from Python.  The
graphs read the masters, the buffers and the cached device tables where
they lie: AdamW updates them in place.  The global norm, the one read of
the loss and the norm, the NaN skip, the clip and AdamW stay eager.

Under a profiler session a step is three ranges: ``rf.train.forward`` (the
render and the loss), ``rf.train.backward`` (``autograd.grad``, whose
launches and remat's recomputation run on autograd's own thread inside it,
and the fp32 casts of the gradients) and ``rf.train.optimizer`` (the
all-reduce, the global norm, the one read of the loss and the norm, the
NaN skip, the clip, AdamW and the shadow's copy).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch.func import functional_call
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from renderformer_tpu_torch.nn.core import DropoutKey, RopeFreqs
from renderformer_tpu_torch.ops import LAUNCHES, use_plain
from renderformer_tpu_torch.ops.flash_attention import BWD_VARIANTS, flash_backward
from renderformer_tpu_torch.parallel.sharding import axis_group, axis_size, use_sharding
from renderformer_tpu_torch.pipelines.rendering_pipeline import render_fn
from renderformer_tpu_torch.training.dataset import texture_patch_mask
from renderformer_tpu_torch.utils.profiling import annotate

VIEW_PREFIX = 'view_transformer.'


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 5e-6
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    num_epochs: int = 3
    steps_per_epoch: int = 1000
    warmup_steps: int = 0
    resolution: int = 256
    precision: str = 'bfloat16'
    view_precision: str = ''   # '' -> fp32 view stage under bf16, bf16 under fp32
    min_lr_scale: float = 0.0  # cosine floor (end value / peak)
    remat: bool = False        # gradient checkpointing of every transformer block
    bf16_shadow_params: bool = False  # differentiate a compute-dtype copy
    seed: int = 0              # dropout masks from DropoutKey(seed, step)
    skip_nonfinite: bool = True
    debug_nans: bool = False       # raise at the first op of a step that makes a NaN
    deterministic: bool = False    # the same bits every run: K9 and deterministic cuDNN
    flash_bwd: str = ''        # attention backward: K8 'fused' or K9 'twokernel';
    #                            '' -> 'fused', or 'twokernel' under deterministic
    fused_norm: bool = False   # RMSNorms through K11 (forward and backward) where the gate passes
    cuda_graphs: bool = True   # replay the forward and backward as CUDA graphs where
    #                            graphs_apply passes; False: every step eager


def _dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name in ('bfloat16', 'bf16') else torch.float32


def resolve_dtypes(tc: TrainConfig) -> Tuple[torch.dtype, torch.dtype]:
    """(stage-1 dtype, view-stage dtype); an empty ``view_precision`` gives
    the reference's fp32 island under bf16 and bf16 under fp32."""
    dtype = _dtype(tc.precision)
    if tc.view_precision:
        return dtype, _dtype(tc.view_precision)
    return dtype, (torch.float32 if dtype == torch.bfloat16 else torch.bfloat16)


def _f32(x) -> np.float32:
    return np.float32(x)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule, in fp32 as JAX evaluates it: a
    linear ramp init -> peak over ``warmup_steps``, then a cosine from peak
    to ``end_value`` over the remaining ``decay_steps - warmup_steps``."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError('the cosine decay needs decay_steps > warmup_steps, got '
                         f'{decay_steps} and {warmup_steps}')
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            c = _f32(min(max(count, 0), warmup_steps))
            frac = _f32(1) - c / _f32(warmup_steps)
            return float(_f32(init_value - peak_value) * frac + _f32(peak_value))
        c = _f32(min(count - warmup_steps, cos_steps))
        cosine = _f32(0.5) * (_f32(1) + np.cos(_f32(np.pi) * c / _f32(cos_steps)))
        return float(_f32(peak_value) * (_f32(1 - alpha) * cosine + _f32(alpha)))

    return schedule


class AdamW:
    """optax.chain(clip_by_global_norm(max_norm), adamw(schedule, weight_decay))
    on name -> tensor dicts, updating the parameters and the moments in place.

    The state is ``{'count': int, 'mu': {name: fp32}, 'nu': {name: fp32}}``;
    the learning rate of an update is ``schedule(count)`` before the count
    moves, as optax's ``scale_by_schedule`` reads it."""

    def __init__(self, schedule: Callable[[int], float], weight_decay: float,
                 max_grad_norm: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Dict[str, torch.Tensor]) -> Dict:
        return {'count': 0,
                'mu': {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
                'nu': {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}}

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: Dict,
               params: Dict[str, torch.Tensor], grad_norm: float,
               decayed: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """One step on ``params`` (in place) from ``grads`` (in the order of
        ``params``, fp32, consumed) and their global norm, and on the
        tensors of ``decayed`` (in place), which take no gradient: with a
        zero gradient Adam's moments stay 0 and its update is 0 / (0 + eps),
        so optax moves them by the weight decay alone, p - lr*(wd*p)."""
        names = list(params)
        p = [params[n] for n in names]
        mu = [state['mu'][n] for n in names]
        nu = [state['nu'][n] for n in names]
        if not grad_norm < self.max_grad_norm:
            # optax: (t / g_norm) * max_norm
            torch._foreach_div_(grads, grad_norm)
            torch._foreach_mul_(grads, self.max_grad_norm)
        count_inc = state['count'] + 1
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.b2)
        del grads
        bc1 = float(_f32(1) - np.power(_f32(self.b1), _f32(count_inc)))
        bc2 = float(_f32(1) - np.power(_f32(self.b2), _f32(count_inc)))
        upd = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(upd, den)
        del den
        torch._foreach_add_(upd, p, alpha=self.weight_decay)
        neg_lr = -self.schedule(state['count'])
        torch._foreach_mul_(upd, neg_lr)
        torch._foreach_add_(p, upd)
        if decayed:
            d = list(decayed.values())
            upd = torch._foreach_mul(d, self.weight_decay)
            torch._foreach_mul_(upd, neg_lr)
            torch._foreach_add_(d, upd)
        state['count'] = count_inc


def make_optimizer(tc: TrainConfig) -> AdamW:
    """AdamW + cosine schedule + global-norm clip, as the JAX package's."""
    total_steps = max(1, tc.num_epochs * tc.steps_per_epoch)
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0 if tc.warmup_steps else tc.learning_rate,
        peak_value=tc.learning_rate, warmup_steps=tc.warmup_steps,
        decay_steps=total_steps, end_value=tc.learning_rate * tc.min_lr_scale)
    return AdamW(schedule, tc.weight_decay, tc.max_grad_norm)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), fp32.
    On the CPU each tensor's sum runs in fp64: the CPU's fp32 norm reads a
    1M-element gradient 2.7e-5 low."""
    if tensors and not tensors[0].is_cuda:
        norms = [torch.linalg.vector_norm(t, dtype=torch.float64) for t in tensors]
        return torch.linalg.vector_norm(torch.stack(norms)).float()
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def stage_dtype(name: str, dtype: torch.dtype, view_dtype: torch.dtype) -> torch.dtype:
    return view_dtype if name.startswith(VIEW_PREFIX) else dtype


def decayed_buffers(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The buffers that AdamW decays like parameters: every RoPE base
    frequency table (``...rope_emb.freqs``, the JAX package's
    ``rope_freqs`` leaves), fp32, by name."""
    return {f'{n}.freqs': m.freqs for n, m in model.named_modules()
            if isinstance(m, RopeFreqs)}


@torch.no_grad()
def sync_shadow(state: 'TrainState') -> None:
    """Copy the masters and the decayed buffers into the shadow."""
    for s, m in zip(state.shadow.parameters(), state.model.parameters()):
        s.copy_(m)
    masters = decayed_buffers(state.model)
    for n, b in decayed_buffers(state.shadow).items():
        b.copy_(masters[n])


def make_shadow(model: nn.Module, tc: TrainConfig) -> nn.Module:
    """A copy of ``model`` with each stage's parameters in its compute dtype
    (the JAX package's ``make_shadow_tree``)."""
    dtype, view_dtype = resolve_dtypes(tc)
    shadow = copy.deepcopy(model)
    with torch.no_grad():
        for n, p in shadow.named_parameters():
            p.data = p.data.to(stage_dtype(n, dtype, view_dtype))
    shadow.remat = tc.remat
    shadow.fused_norm = tc.fused_norm
    return shadow.requires_grad_(True)


@dataclasses.dataclass
class TrainState:
    model: nn.Module             # fp32 master weights
    opt_state: Dict
    step: int = 0
    shadow: Optional[nn.Module] = None   # compute-dtype copy; not checkpointed

    @classmethod
    def create(cls, model: nn.Module, tx: AdamW, tc: Optional[TrainConfig] = None):
        model.requires_grad_(True)
        state = cls(model=model, opt_state=tx.init(dict(model.named_parameters())))
        if tc is not None and _uses_shadow(tc):
            state.shadow = make_shadow(model, tc)
        return state


def _uses_shadow(tc: TrainConfig) -> bool:
    dtype, view_dtype = resolve_dtypes(tc)
    return tc.bf16_shadow_params and torch.bfloat16 in (dtype, view_dtype)


_MASKS: Dict[Tuple, torch.Tensor] = {}


def batch_texture(batch, patch_size: int) -> torch.Tensor:
    """The batch's texture patches: ``texture`` as it is, or the compact
    ``texture_flat`` [B, N, 13] broadcast on its device into
    [B, N, 13, ps, ps] with the lower-triangle patch mask of ``patch_size``
    (the JAX package's ``batch_texture``), in the flat form's dtype."""
    if 'texture' in batch:
        return batch['texture']
    flat = batch['texture_flat']
    key = (patch_size, flat.dtype, flat.device)
    if key not in _MASKS:
        _MASKS[key] = torch.from_numpy(texture_patch_mask(patch_size)).to(flat.device,
                                                                           flat.dtype)
    return flat[..., None, None] * _MASKS[key]


class _RenderStep(nn.Module):
    """render_fn as a module, so that ``functional_call`` can put the
    stage casts in place of the model's parameters."""

    def __init__(self, model: nn.Module, resolution: int):
        super().__init__()
        self.model = model
        self.resolution = resolution

    def forward(self, batch, key: Optional[DropoutKey] = None):
        texture = batch_texture(batch, self.model.config.texture_encode_patch_size)
        return render_fn(self.model, batch['triangles'], texture, batch['mask'],
                         batch['vn'], batch['c2w'], batch['fov'],
                         resolution=self.resolution, dropout_key=key)


# factory ops whose output holds memory no one has written yet
_UNWRITTEN = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
              torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
              torch.ops.aten.new_empty_strided.default}


def _has_nan(t) -> bool:
    return (isinstance(t, torch.Tensor) and t.is_floating_point()
            and bool(torch.isnan(t).any()))


class NaNCheck(TorchDispatchMode):
    """Raises ``FloatingPointError`` at the first operation whose output
    holds a NaN (``jax_debug_nans``), in the forward and in the backward,
    which autograd runs under the modes of the thread that called it.
    Views and allocations are not checked.  A hand-written kernel's launch
    is no torch operation: a NaN it makes raises at the first operation
    that reads it, and the message then says that the NaN came in."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func in _UNWRITTEN:
            return out
        if any(_has_nan(t) for t in tree_leaves(out)):
            came_in = any(_has_nan(t) for t in tree_leaves((args, kwargs)))
            raise FloatingPointError(
                f'invalid value (nan) encountered in {func}'
                + (': a NaN among its inputs, from a kernel launch or the batch'
                   if came_in else ''))
        return out


def nan_check(on: bool):
    """:class:`NaNCheck` inside the block when ``on``; nothing otherwise."""
    return NaNCheck() if on else contextlib.nullcontext()


def flash_bwd_variant(tc: TrainConfig) -> str:
    """The attention backward a step of ``tc`` runs: ``tc.flash_bwd``, or
    when it is empty K8 (``'fused'``), K9 (``'twokernel'``) under
    ``deterministic``.  Raises for a name that is neither, and for
    ``'fused'`` under ``deterministic``: K8 sums dQ by atomics."""
    if tc.flash_bwd and tc.flash_bwd not in BWD_VARIANTS:
        raise ValueError(f'flash_bwd {tc.flash_bwd!r} is not one of {BWD_VARIANTS}')
    if tc.deterministic:
        if tc.flash_bwd == 'fused':
            raise ValueError("deterministic=True takes flash_bwd='twokernel' (or ''): the "
                             "fused backward K8 sums dQ by atomics in a run-dependent order")
        return 'twokernel'
    return tc.flash_bwd or 'fused'


@contextlib.contextmanager
def cudnn_deterministic(on: bool):
    """cuDNN's deterministic algorithms, and no benchmarking, inside the
    block when ``on``; the flags as they were after it."""
    if not on:
        yield
        return
    flags = torch.backends.cudnn
    prev = flags.deterministic, flags.benchmark
    flags.deterministic, flags.benchmark = True, False
    try:
        yield
    finally:
        flags.deterministic, flags.benchmark = prev


@contextlib.contextmanager
def step_kernels(tc: TrainConfig):
    """The attention backward (:func:`flash_bwd_variant`) and cuDNN's
    algorithms of a step of ``tc``, inside the block."""
    with flash_backward(flash_bwd_variant(tc)), cudnn_deterministic(tc.deterministic):
        yield


def make_loss_fns(model: nn.Module, tc: TrainConfig, mesh=None):
    """Build ``images(state, batch)``, the render of the batch in the
    stages' compute dtypes (in-graph casts of the masters, or the shadow),
    and ``loss_and_grads(state, batch) -> (loss, grads)``: the MSE loss and
    its fp32 gradients in the order of ``state.model.parameters()``, eager.
    With the config's dropout on, ``loss_and_grads`` draws the masks of
    ``DropoutKey(tc.seed, state.step)``; ``images`` takes a key or none.
    With a ``mesh``, ``images`` splits the attention sites over its seq
    axis (``parallel.sharding.use_sharding``).  The model's ``remat`` and
    ``fused_norm`` are set from ``tc`` here, once."""
    return _loss_fns(model, tc, mesh)[:2]


def _loss_fns(model: nn.Module, tc: TrainConfig, mesh=None):
    """:func:`make_loss_fns`'s two functions and the phases of
    ``loss_and_grads``: ``forward(state, batch, key)``, the loss with its
    autograd graph, and ``backward(state, loss)``, the fp32 gradients."""
    flash_bwd_variant(tc)  # raises for a backward the config cannot take
    dtype, view_dtype = resolve_dtypes(tc)
    use_shadow = _uses_shadow(tc)
    step_module = _RenderStep(model, tc.resolution)
    use_dropout = model.config.dropout > 0.0
    model.remat = tc.remat
    model.fused_norm = tc.fused_norm

    def images(state: TrainState, batch, key: Optional[DropoutKey] = None):
        with contextlib.nullcontext() if mesh is None else use_sharding(mesh):
            return _images(state, batch, key)

    def _images(state: TrainState, batch, key: Optional[DropoutKey] = None):
        if use_shadow:
            if state.shadow is None:
                state.shadow = make_shadow(state.model, tc)
            return _RenderStep(state.shadow, tc.resolution)(batch, key)
        cast = {f'model.{n}': p.to(stage_dtype(n, dtype, view_dtype))
                for n, p in state.model.named_parameters()}
        return functional_call(step_module, cast, (batch, key))

    def forward(state: TrainState, batch, key: Optional[DropoutKey] = None):
        imgs = images(state, batch, key)
        return torch.mean(torch.square(imgs - batch['gt'].to(imgs.dtype)))

    def backward(state: TrainState, loss: torch.Tensor) -> List[torch.Tensor]:
        wrt = list((state.shadow if use_shadow else state.model).parameters())
        with nan_check(tc.debug_nans):
            grads = torch.autograd.grad(loss, wrt, allow_unused=True, materialize_grads=True)
        return [g.float() for g in grads]

    def loss_and_grads(state: TrainState, batch):
        key = DropoutKey(tc.seed, state.step) if use_dropout else None
        with step_kernels(tc):
            with annotate('rf.train.forward'), nan_check(tc.debug_nans):
                loss = forward(state, batch, key)
            with annotate('rf.train.backward'):
                grads = backward(state, loss)
        return loss.detach(), grads

    return images, loss_and_grads, forward, backward


MAX_SIGNATURES = 2  # batch signatures a step captures; a further one runs eager


def graphs_apply(tc: TrainConfig, model: nn.Module, mesh, batch) -> bool:
    """Whether a step of ``tc`` replays CUDA graphs for ``batch``: graphs
    on (``tc.cuda_graphs``), every tensor of the batch on CUDA, no mesh
    (the all-reduce and the split attention sites stay eager), no dropout
    (a graph would keep the first step's masks), no ``debug_nans`` (its
    checks read each output on the host), no bf16 shadow, and the kernels,
    not their plain versions (``ops.reference_kernels``, a check whose
    plain versions copy tables from the host at every call)."""
    return (tc.cuda_graphs and mesh is None and model.config.dropout == 0.0
            and not tc.debug_nans and not _uses_shadow(tc)
            and all(v.is_cuda for v in batch.values()) and not use_plain(batch['gt']))


def batch_signature(batch) -> Tuple:
    """What a captured step is good for: the batch's keys, shapes, dtypes
    and devices, and the settings a graph keeps from its capture (TF32 in
    cuBLAS and cuDNN)."""
    return (tuple((k, tuple(v.shape), v.dtype, v.device) for k, v in sorted(batch.items())),
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The one side stream of a device that every step's warm-up and
    capture run on: cuBLAS keeps a workspace for each stream it ran on, as
    long as the process lives."""
    return torch.cuda.Stream(device)


def capture_graphs(phases, device: torch.device):
    """Run each of ``phases`` (functions of no arguments) once in turn on a
    side stream of ``device``, the warm-up, then capture each in turn as a
    CUDA graph on that stream, all in one memory pool.  Returns, a phase,
    its capture's outputs, which each replay writes again, and the graph's
    ``replay``."""
    side = _capture_stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for fn in phases:
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    pool = torch.cuda.graph_pool_handle()
    captured = []
    for fn in phases:
        graph = torch.cuda.CUDAGraph()
        # thread_local: other threads (the trainer's, pinning the next batch) may go on
        with torch.cuda.graph(graph, pool=pool, stream=side, capture_error_mode='thread_local'):
            out = fn()
        captured.append((out, graph.replay))
    return captured


class StepGraphs:
    """A step's ``loss_and_grads`` from CUDA graphs (:func:`capture_graphs`):
    for each batch signature, up to ``MAX_SIGNATURES``, a forward graph (the
    stage casts, the render, the loss) and a backward graph
    (``autograd.grad`` with remat's recomputation, the fp32 casts), captured
    at the signature's first step.  A step copies its batch into the static
    inputs and replays the two, each inside its span.  Launches: the
    warm-up and the capture count nothing, a replay the capture's, so a
    step counts one step's launches either way.  A step whose masters or
    buffers no longer lie where the graphs read them captures anew."""

    def __init__(self, tc: TrainConfig, forward, backward):
        self.tc, self.forward, self.backward = tc, forward, backward
        self.captured: Dict[Tuple, Tuple] = {}
        self.addresses: Optional[List[int]] = None

    def __call__(self, state: TrainState, batch):
        """(loss, grads) as ``loss_and_grads`` gives them, or None for a new
        signature past ``MAX_SIGNATURES``."""
        addresses = [t.data_ptr() for t in (*state.model.parameters(),
                                             *state.model.buffers())]
        if addresses != self.addresses:
            self.captured.clear()
            self.addresses = addresses
        sig = batch_signature(batch)
        if sig not in self.captured:
            if len(self.captured) >= MAX_SIGNATURES:
                return None
            self.captured[sig] = self._capture(state, batch)
        static, (loss, forward), (grads, backward), counts = self.captured[sig]
        with annotate('rf.train.forward'):
            for k, v in batch.items():
                static[k].copy_(v, non_blocking=True)
            forward()
        with annotate('rf.train.backward'):
            backward()
        for k, n in counts.items():
            LAUNCHES[k] += n
        return loss, grads

    def _capture(self, state: TrainState, batch):
        static = {k: v.clone() for k, v in batch.items()}
        held = {}
        deltas = []

        def counted(fn):
            def run():
                before = dict(LAUNCHES)
                out = fn()
                deltas.append({k: LAUNCHES[k] - before[k] for k in LAUNCHES})
                return out
            return run

        def forward():
            held['loss'] = self.forward(state, static)
            return held['loss'].detach()

        def backward():
            return self.backward(state, held.pop('loss'))

        start = dict(LAUNCHES)
        with step_kernels(self.tc):
            fwd, bwd = capture_graphs([counted(forward), counted(backward)],
                                      batch['gt'].device)
        counts = {k: deltas[-2][k] + deltas[-1][k] for k in LAUNCHES}
        LAUNCHES.update(start)
        return static, fwd, bwd, {k: n for k, n in counts.items() if n}


def all_reduce_mean(grads: List[torch.Tensor], loss: torch.Tensor, mesh) -> torch.Tensor:
    """The gradients (fp32, in place) and the loss averaged over ``mesh``'s
    data ranks by one all-reduce of a flat fp32 bucket; returns the loss."""
    bucket = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1).float()])
    dist.all_reduce(bucket, group=axis_group(mesh, 'data'))
    bucket.div_(axis_size(mesh, 'data'))
    # copied back, so the norm and the update read the gradients' own storage
    offset = 0
    for g in grads:
        g.copy_(bucket[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return bucket[-1]


def make_train_step(model: nn.Module, tx: AdamW, tc: TrainConfig, mesh=None):
    """Build ``train_step(state, batch) -> (state, metrics)`` and
    ``eval_step(state, batch) -> metrics`` for ``model`` (the module that
    holds the masters, ``state.model``).  With a ``mesh`` the batch is this
    data rank's slice: the gradients, the loss and the validation sums are
    reduced over the mesh's data ranks (:func:`all_reduce_mean`).

    batch: dict of tensors on the model's device: triangles [B, N, 3, 3],
    texture [B, N, 13, ps, ps] or texture_flat [B, N, 13], mask [B, N]
    bool, vn [B, N, 3, 3], c2w [B, V, 4, 4], fov [B, V, 1], gt
    [B, V, H, W, 3], optional valid [B].
    Metrics are Python floats: the step reads the loss and the grad norm
    once, to decide the NaN skip and the clip."""
    images, loss_and_grads, forward, backward = _loss_fns(model, tc, mesh)
    use_shadow = _uses_shadow(tc)
    decayed = decayed_buffers(model)
    graphs = StepGraphs(tc, forward, backward)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, float]]:
        out = graphs(state, batch) if graphs_apply(tc, model, mesh, batch) else None
        loss, grads = out if out is not None else loss_and_grads(state, batch)
        with annotate('rf.train.optimizer'):
            if mesh is not None:
                loss = all_reduce_mean(grads, loss, mesh)
            gnorm = global_norm(grads)
            loss_f, gnorm_f = torch.stack([loss.float(), gnorm]).tolist()
            if not tc.skip_nonfinite or (math.isfinite(loss_f) and math.isfinite(gnorm_f)):
                tx.update(grads, state.opt_state, dict(state.model.named_parameters()),
                          gnorm_f, decayed)
                if use_shadow:
                    sync_shadow(state)
        state.step += 1
        return state, {'loss': loss_f, 'grad_norm': gnorm_f}

    @torch.no_grad()
    def eval_step(state: TrainState, batch) -> Dict[str, float]:
        """Per-sample MSE weighted by the optional ``valid`` mask, as the sum,
        the count and their ratio."""
        with nan_check(tc.debug_nans):
            imgs = images(state, batch)
        sq = torch.square(imgs - batch['gt'].to(imgs.dtype))
        per_sample = sq.reshape(sq.shape[0], -1).mean(dim=-1)
        valid = batch.get('valid')
        valid = (torch.ones_like(per_sample) if valid is None
                 else valid.to(per_sample.dtype))
        sums = torch.stack([(per_sample * valid).sum(), valid.sum()]).float()
        if mesh is not None:
            dist.all_reduce(sums, group=axis_group(mesh, 'data'))
        loss_sum, n = sums.tolist()
        return {'loss_sum': loss_sum, 'n': n, 'loss': loss_sum / max(n, 1.0)}

    return train_step, eval_step
