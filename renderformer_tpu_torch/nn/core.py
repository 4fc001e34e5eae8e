"""Norms, activations, the seeded init and the compute-dtype cast.

Numerics match the JAX package:
  * torch ``nn.LayerNorm``'s default eps is 1e-5 and ``nn.RMSNorm``'s is
    ``finfo(float32).eps``; the attention stack uses an explicit 1e-6;
  * norm statistics are fp32 whatever the compute dtype, and on a
    low-precision input the rescale runs in that dtype, in the order
    ``x * inv.to(dt) * scale.to(dt)``.

``RMSNorm.fused`` (the JAX package's ``RFTPU_FUSE_NORM``; a render sets it
from ``RuntimeConfig.fused_norm``, on by default, a train step from
``TrainConfig.fused_norm``, off by default) sends a norm whose shape passes
``fused_rms_norm_supported`` through kernel K11 (``ops/fused_norm.py``);
otherwise the norm is the torch ops below, the counterpart of the JAX
package's jnp ``rms_norm``.

Every linear of the port goes through :func:`linear` (:class:`Linear` is
``nn.Linear`` calling it): a CUDA float32 product with TF32 off in cuBLAS
takes the split-TF32 kernel (``ops/gemm_tf32x3.py``), forward and backward;
anything else is ``F.linear`` as it is.
"""

from __future__ import annotations

import copy
import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from renderformer_tpu_torch.ops.fused_norm import fused_rms_norm, fused_rms_norm_supported
from renderformer_tpu_torch.ops.gemm_tf32x3 import tf32x3_linear, tf32x3_linear_supported

TORCH_DEFAULT_RMS_EPS = float(np.finfo(np.float32).eps)
TORCH_DEFAULT_LN_EPS = 1e-5
ATTN_EPS = 1e-6


def linear(x, weight, bias=None):
    """``F.linear(x, weight, bias)``; in split TF32 on the tensor cores where
    the operands are CUDA float32, TF32 is off and the widths suit the
    kernel (``tf32x3_linear_supported``)."""
    if tf32x3_linear_supported(x, weight, bias):
        return tf32x3_linear(x, weight, bias)
    return F.linear(x, weight, bias)


class Linear(nn.Linear):
    """``nn.Linear`` (the same parameters and state-dict keys) through
    :func:`linear`."""

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = TORCH_DEFAULT_RMS_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.fused = False

    def forward(self, x):
        if self.fused and fused_rms_norm_supported(x, self.weight):
            return fused_rms_norm(x, self.weight, self.eps)
        x32 = x.float()
        ss = torch.sum(x32 * x32, dim=-1, keepdim=True)
        inv = torch.rsqrt(ss / x.shape[-1] + self.eps)
        if x.dtype == torch.float32:
            return x * inv * self.weight.float()
        return x * inv.to(x.dtype) * self.weight.to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = TORCH_DEFAULT_LN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        d = x.shape[-1]
        x32 = x.float()
        mean = x32.sum(dim=-1, keepdim=True) / d
        var = (x32 * x32).sum(dim=-1, keepdim=True) / d - mean * mean
        inv = torch.rsqrt(torch.clamp(var, min=0.0) + self.eps)
        if x.dtype == torch.float32:
            return (x - mean) * inv * self.weight.float() + self.bias.float()
        dt = x.dtype
        return ((x - mean.to(dt)) * inv.to(dt) * self.weight.to(dt)
                + self.bias.to(dt))


def make_norm(norm_type: str, dim: int, eps: Optional[float] = None) -> nn.Module:
    """Norm of ``norm_type`` with the per-site eps default of torch."""
    if norm_type == 'none':
        return nn.Identity()
    if norm_type == 'rms_norm':
        return RMSNorm(dim, TORCH_DEFAULT_RMS_EPS if eps is None else eps)
    if norm_type == 'layer_norm':
        return LayerNorm(dim, TORCH_DEFAULT_LN_EPS if eps is None else eps)
    raise ValueError(f'Unsupported norm type: {norm_type}')


def silu(x):
    return F.silu(x)


def gelu(x):
    """Exact (erf) GeLU."""
    return F.gelu(x)


def elu(x, alpha: float = 1.0):
    """x if x > 0 else alpha * (exp(x) - 1)."""
    safe = torch.where(x > 0, torch.zeros_like(x), x)
    return torch.where(x > 0, x, alpha * (torch.exp(safe) - 1.0))


class DropoutKey:
    """The seed of the dropout masks below a point of the model: a path of
    non-negative ints, from a train step's ``(seed, step)`` down to one
    site.  ``fold`` extends the path, as ``jax.random.fold_in`` and
    ``split`` derive keys in the JAX package.  A mask is a function of the
    path alone, so a block that ``torch.utils.checkpoint`` recomputes in
    the backward draws the masks of its forward again: the checkpoint
    restores the global RNG states only, and a generator made once and
    consumed would hand the recomputation other masks."""

    __slots__ = ('path',)

    def __init__(self, *path: int):
        self.path = tuple(int(p) for p in path)

    def fold(self, *ids: int) -> 'DropoutKey':
        return DropoutKey(*self.path, *ids)

    def generator(self, device) -> torch.Generator:
        """A generator on ``device`` seeded from the path (63 bits)."""
        hi, lo = np.random.SeedSequence(self.path).generate_state(2, np.uint32)
        g = torch.Generator(device=device)
        g.manual_seed((int(hi) & 0x7FFFFFFF) << 32 | int(lo))
        return g

    def __repr__(self):
        return f'DropoutKey{self.path}'


def dropout(x, rate: float, key: Optional[DropoutKey]):
    """Inverted dropout: each unit kept with probability ``keep = 1 - rate``
    (a uniform draw below ``keep``) and scaled by ``1 / keep``, with
    ``keep`` rounded to x's dtype first, as the JAX package divides by
    ``jnp.asarray(keep, x.dtype)``.  ``key=None`` or ``rate <= 0`` is the
    eval path: x itself, no operation."""
    if key is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    keep_x = float(torch.tensor(keep, dtype=x.dtype))
    u = torch.rand(x.shape, generator=key.generator(x.device), device=x.device)
    return torch.where(u < keep, x / keep_x, torch.zeros((), dtype=x.dtype, device=x.device))


class RopeFreqs(nn.Module):
    """Holds the RoPE base frequencies as the buffer ``freqs`` (the
    reference's ``rope_emb.freqs``); always fp32."""

    def __init__(self, freqs: np.ndarray):
        super().__init__()
        self._init = np.asarray(freqs, np.float32)
        self.register_buffer('freqs', torch.tensor(self._init))

    def reset_parameters(self):
        with torch.no_grad():
            self.freqs.copy_(torch.from_numpy(self._init))


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init with the JAX package's distributions: Linear and conv
    weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's
    defaults), norms ones/zeros, learned tokens N(0, 1).  Draws on the
    CPU so that a seed gives the same weights on every device."""
    def uniform_(t, bound):
        t.copy_(torch.rand(t.shape, generator=generator) * (2 * bound) - bound)

    for name, mod in model.named_modules():
        if isinstance(mod, nn.Linear):
            bound = 1.0 / math.sqrt(mod.in_features)
        elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            kh, kw = mod.kernel_size
            bound = 1.0 / math.sqrt(mod.in_channels * kh * kw)
        elif isinstance(mod, (RMSNorm, LayerNorm)):
            mod.weight.fill_(1.0)
            if isinstance(mod, LayerNorm):
                mod.bias.zero_()
            continue
        elif isinstance(mod, RopeFreqs):
            mod.reset_parameters()
            continue
        else:
            for p in mod.parameters(recurse=False):
                p.copy_(torch.randn(p.shape, generator=generator))
            continue
        uniform_(mod.weight, bound)
        if mod.bias is not None:
            uniform_(mod.bias, bound)
    return model


def cast_params(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A copy of ``module`` with its float parameters in ``dtype``; the
    RoPE frequencies stay fp32 (rotation is always computed in fp32)."""
    if dtype == torch.float32:
        return module
    out = copy.deepcopy(module)
    with torch.no_grad():
        for p in out.parameters():
            if p.dtype == torch.float32:
                p.data = p.data.to(dtype)
    return out
