"""Fused RMSNorm (kernel K11): the forward and the backward over the last
axis with fp32 statistics, their plain PyTorch versions, the shape gate of
the JAX package, and the autograd Function that joins them.

The kernels take x ``[R, D]`` in bf16 or fp32 and the scale ``[D]`` in
bf16 or fp32 as it is given (a bf16 scale widens to fp32 exactly inside the
kernel, so the result is the JAX package's, which casts it first);
:func:`fused_rms_norm` flattens the leading axes.  The forward's rescale is
``x*inv*s`` in fp32 and ``x * bf16(inv)`` then ``* bf16(s)``, each rounded
to bf16, on a bf16 input.
The backward recomputes inv from x and writes dx and per-block fp32
partials of the scale's gradient, which the wrapper sums with one
``torch.sum``.  The CUDA source is ``csrc/fused_norm.cu``; its note says
what bounds the kernels on the card.
"""

from __future__ import annotations

import torch

from renderformer_tpu_torch import _build
from renderformer_tpu_torch.ops import LAUNCHES, use_plain

KERNEL_DTYPES = (torch.bfloat16, torch.float32)
BLOCK_WARPS = 8    # warps a block in csrc/fused_norm.cu, one row each at a time
_BWD_BLOCKS = 264  # about two backward blocks an SM of the H100's 132


def fused_rms_norm_supported(x, scale) -> bool:
    """The JAX package's shape gate: an input of 2 or more axes, its last the
    scale's length and a multiple of 128, and at least 256 rows."""
    if x.dim() < 2 or scale.dim() != 1 or x.shape[-1] != scale.shape[0]:
        return False
    rows = 1
    for s in x.shape[:-1]:
        rows *= s
    return x.shape[-1] % 128 == 0 and rows >= 256


def rms_norm_fwd_plain(x, scale, eps: float):
    """The forward kernel's function in torch ops: inv = rsqrt(sum(x*x)/D +
    eps) in fp32, then x*inv*s (fp32) or x*bf16(inv)*bf16(s) (bf16)."""
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).sum(dim=-1, keepdim=True) / x.shape[-1] + eps)
    s = scale.float()
    if x.dtype == torch.float32:
        return x * inv * s
    return x * inv.to(x.dtype) * s.to(x.dtype)


def rms_norm_bwd_plain(x, scale, g, eps: float):
    """The backward kernel's function in torch ops, in fp32: dx = gs*inv -
    x*(inv^3 * sum(gs*x)/D) with gs = g*s, cast to x's dtype, and ds =
    sum over rows of g*(x*inv), fp32 [D]."""
    xf, gf, s = x.float(), g.float(), scale.float()
    d = x.shape[-1]
    inv = torch.rsqrt((xf * xf).sum(dim=-1, keepdim=True) / d + eps)
    gs = gf * s
    dot = (gs * xf).sum(dim=-1, keepdim=True)
    dx = gs * inv - xf * (inv * inv * inv * (dot / d))
    return dx.to(x.dtype), (gf * (xf * inv)).sum(dim=0)


def _check_2d(x, scale, *others):
    """x [R, D] and each (name, tensor) of ``others`` alike, contiguous;
    scale [D]."""
    if x.dim() != 2 or scale.dim() != 1 or scale.shape[0] != x.shape[1]:
        raise ValueError(f'x must be [R, D] and scale [D], got {tuple(x.shape)} and '
                         f'{tuple(scale.shape)}')
    if not x.is_contiguous():
        raise ValueError('x: expected a contiguous tensor')
    for name, t in others:
        if t.shape != x.shape:
            raise ValueError(f'{name} must be {tuple(x.shape)}, got {tuple(t.shape)}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: expected a contiguous tensor')


_CODES = {getattr(torch, name): code for name, code in _build.DTYPE_CODES.items()}
_lib = None


def _library():
    """The kernel library, looked up once."""
    global _lib
    if _lib is None:
        _lib = _build.library()
    return _lib


def _kernel_args(x, scale, *others):
    """Check the operands of a kernel on the card (x [R, D] there, and each
    (name, tensor) of ``others`` in x's dtype, checked by ``_check_2d``);
    returns (x's dtype code, the scale's, the raw current stream)."""
    code, scode = _CODES.get(x.dtype), _CODES.get(scale.dtype)
    if code is None or scode is None:
        raise ValueError(f'RMSNorm kernel takes {KERNEL_DTYPES}, got x {x.dtype} and scale '
                         f'{scale.dtype}')
    dev = x.get_device()
    for name, t in (('x', x), ('scale', scale), *others):
        if t.get_device() != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f'{name}: expected a contiguous, 16-byte aligned tensor on '
                             f'{x.device}')
    for name, t in others:
        if t.dtype != x.dtype:
            raise ValueError(f'{name}: expected {x.dtype}, got {t.dtype}')
    return code, scode, torch._C._cuda_getCurrentRawStream(dev)


def bwd_rows_per_block(r: int) -> int:
    """Rows a block of the backward kernel takes (a multiple of its warps):
    enough that about _BWD_BLOCKS blocks cover ``r`` rows."""
    return BLOCK_WARPS * max(1, -(-r // (BLOCK_WARPS * _BWD_BLOCKS)))


def rms_norm_fwd(x, scale, eps: float):
    """RMSNorm of x [R, D] (bf16 or fp32) with scale [D]: K11's forward."""
    _check_2d(x, scale)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        raise RuntimeError('rms_norm_fwd is a forward kernel alone; differentiate through '
                           'fused_rms_norm')
    if use_plain(x):
        return rms_norm_fwd_plain(x, scale, eps)
    code, scode, stream = _kernel_args(x, scale)
    r, d = x.shape
    y = torch.empty_like(x)
    rc = _library().rf_rms_norm_fwd(x.data_ptr(), scale.data_ptr(), y.data_ptr(), code, scode,
                                    r, d, eps, stream)
    _build.check(rc, 'rf_rms_norm_fwd')
    LAUNCHES['rms_norm_fwd'] += 1
    return y


def rms_norm_bwd(x, scale, g, eps: float):
    """K11's backward at x [R, D] for the cotangent g [R, D]: (dx in x's
    dtype, ds [D] fp32)."""
    _check_2d(x, scale, ('g', g))
    if use_plain(x):
        return rms_norm_bwd_plain(x, scale, g, eps)
    code, scode, stream = _kernel_args(x, scale, ('g', g))
    r, d = x.shape
    rows = bwd_rows_per_block(r)
    dx = torch.empty_like(x)
    part = torch.empty((-(-r // rows), d), dtype=torch.float32, device=x.device)
    rc = _library().rf_rms_norm_bwd(x.data_ptr(), scale.data_ptr(), g.data_ptr(),
                                    dx.data_ptr(), part.data_ptr(), code, scode, r, d, rows,
                                    eps, stream)
    _build.check(rc, 'rf_rms_norm_bwd')
    LAUNCHES['rms_norm_bwd'] += 1
    return dx, torch.sum(part, dim=0)


class _FusedRMSNorm(torch.autograd.Function):
    """The JAX package's ``_fused`` custom VJP: the forward keeps x and the
    scale it was given (a stage's cast one under a train step), the backward
    runs K11's backward and returns ds in the scale's dtype."""

    @staticmethod
    def forward(ctx, x2, scale, eps):
        ctx.save_for_backward(x2, scale)
        ctx.eps = eps
        return rms_norm_fwd(x2, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x2, scale = ctx.saved_tensors
        dx, ds = rms_norm_bwd(x2, scale, g.contiguous(), ctx.eps)
        return dx, ds.to(scale.dtype), None


def fused_rms_norm(x, scale, eps: float):
    """RMSNorm of x [..., D] over its last axis through K11; where autograd
    tracks x or the scale, the backward is K11's too."""
    x2 = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        out = _FusedRMSNorm.apply(x2, scale, eps)
    else:
        out = rms_norm_fwd(x2, scale, eps)
    return out.reshape(x.shape)
