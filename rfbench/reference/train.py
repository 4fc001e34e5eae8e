"""Fine-tuning steps in plain PyTorch: the yardstick's copy of the step's math.

A step renders the batch's one scene (its compact per-triangle materials
times the lower-triangle patch mask), takes the MSE against the ground
truth over every pixel, differentiates it with autograd, clips the
gradient by its global norm and applies AdamW as optax's
``chain(clip_by_global_norm, adamw)`` defines it, at a cosine learning
rate from the peak to zero over ``schedule_steps``.  Everything in
float32 with TF32 off unless a control precision says otherwise.  The
RoPE base frequencies are fixed here (the program also decays them, by a
factor 1 - lr * wd ~ 1 - 5e-10 a step: far below any reading).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from rfbench.reference.model import FP32, Model, Precision, tf32_mode

B1, B2, EPS = 0.9, 0.999, 1e-8
VIEW_PREFIX = 'view_transformer.'


def patch_mask(size: int, device) -> torch.Tensor:
    x, y = torch.meshgrid(torch.arange(size), torch.arange(size), indexing='ij')
    return ((x + y) <= size).float().to(device)


def loss(model: Model, batch: Dict[str, torch.Tensor], resolution: int,
         ctx: Optional[torch.Tensor] = None) -> torch.Tensor:
    ps = model.cfg['texture_encode_patch_size']
    tex = batch['texture_flat'][0][:, :, None, None] * patch_mask(ps, batch['gt'].device)
    y = model.log_radiance(batch['triangles'][0], tex, batch['mask'][0], batch['vn'][0],
                           batch['c2w'][0], batch['fov'][0, :, 0], resolution, view_chunk=1,
                           ctx=ctx)
    img = torch.pow(10.0, y) - 1.0
    return torch.mean(torch.square(img - batch['gt'][0]))


def cosine_lr(peak: float, count: int, steps: int) -> float:
    return peak * 0.5 * (1.0 + math.cos(math.pi * min(count, steps) / steps))


def run(cfg: dict, weights: Dict[str, torch.Tensor], batches: List[Dict[str, torch.Tensor]],
        mix: dict, precision: Precision = FP32) -> Dict:
    """The steps on ``batches`` from ``weights`` (float32, updated in
    place).  Returns each step's loss and global gradient norm, the first
    step's gradient per leaf after the clip (what the optimizer takes), and
    each leaf's change over all the steps, as norms by name."""
    names = [n for n in weights if not n.endswith('rope_emb.freqs')]
    params = [weights[n].requires_grad_(True) for n in names]
    start = [p.detach().clone() for p in params]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    model = Model(cfg, weights, precision)
    losses, norms, first = [], [], None
    with tf32_mode(precision.tf32):
        for count, batch in enumerate(batches):
            value = loss(model, batch, mix['resolution'])
            grads = torch.autograd.grad(value, params)
            losses.append(float(value.detach()))
            norm = math.sqrt(sum(float(g.double().pow(2).sum()) for g in grads))
            norms.append(norm)
            scale = 1.0 if norm < mix['max_grad_norm'] else mix['max_grad_norm'] / norm
            grads = [g * scale for g in grads]
            if first is None:
                first = {n: float(g.double().norm()) for n, g in zip(names, grads)}
            lr = cosine_lr(mix['learning_rate'], count, mix['schedule_steps'])
            t = count + 1
            with torch.no_grad():
                for p, g, m, v in zip(params, grads, mu, nu):
                    m.mul_(B1).add_(g, alpha=1 - B1)
                    v.mul_(B2).addcmul_(g, g, value=1 - B2)
                    upd = (m / (1 - B1 ** t)) / ((v / (1 - B2 ** t)).sqrt() + EPS)
                    p.add_(upd + mix['weight_decay'] * p, alpha=-lr)
            del grads
    change = {n: float((p.detach() - s).double().norm())
              for n, p, s in zip(names, params, start)}
    return dict(losses=losses, norms=norms, grad=first, change=change)


def stage_one(cfg: dict, weights: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
              precision: Precision = FP32):
    """Stage 1's tokens [1, R+N, D] of the batch's scene, as the view stage
    takes them, and their mask [1, R+N] (registers and real triangles)."""
    model = Model(cfg, weights, precision)
    ps = cfg['texture_encode_patch_size']
    tex = batch['texture_flat'][0][:, :, None, None] * patch_mask(ps, batch['gt'].device)
    n = tex.shape[0]
    with torch.no_grad(), tf32_mode(precision.tf32):
        return model.encode_scene(batch['triangles'][0].reshape(1, n, 9), tex[None],
                                  batch['mask'], batch['vn'][0].reshape(1, n, 9))


def view_grads(cfg: dict, weights: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
               ctx: torch.Tensor, mix: dict, precision: Precision = FP32) -> Dict[str, float]:
    """The first step's gradient of every view-stage leaf, unclipped, as
    norms by name, with the view stage fed ``ctx`` [1, R+N, D] in place of
    stage 1's tokens: the view stage and DPT head alone, on tokens the
    caller hands over (``weights`` are not changed)."""
    names = [n for n in weights
             if n.startswith(VIEW_PREFIX) and not n.endswith('rope_emb.freqs')]
    params = [weights[n].detach().requires_grad_(True) for n in names]
    model = Model(cfg, dict(weights, **dict(zip(names, params))), precision)
    with tf32_mode(precision.tf32):
        value = loss(model, batch, mix['resolution'], ctx=ctx.float())
        grads = torch.autograd.grad(value, params)
    return {n: float(g.double().norm()) for n, g in zip(names, grads)}
