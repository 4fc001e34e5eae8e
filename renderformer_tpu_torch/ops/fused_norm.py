"""Fused RMSNorm (kernel K11): the forward and the backward over the last
axis with fp32 statistics, their plain PyTorch versions, the shape gate of
the JAX package, and the autograd Function that joins them.

The kernels take x ``[R, D]`` in bf16 or fp32 and the scale ``[D]`` in
bf16 or fp32 as it is given (a bf16 scale widens to fp32 exactly inside the
kernel, so the result is the JAX package's, which casts it first);
:func:`fused_rms_norm` flattens the leading axes.  The forward's rescale is
``x*inv*s`` in fp32 and ``x * bf16(inv)`` then ``* bf16(s)``, each rounded
to bf16, on a bf16 input.
The backward recomputes inv from x and writes dx and the scale's gradient
ds, summed over the rows in fp32 and written in the scale's dtype, in one
launch.  The CUDA source is ``csrc/fused_norm.cu``; its note says what
bounds the kernels on the card.
"""

from __future__ import annotations

import ctypes

import torch

from renderformer_tpu_torch import _build
from renderformer_tpu_torch.ops import LAUNCHES, use_plain

KERNEL_DTYPES = (torch.bfloat16, torch.float32)
BLOCK_WARPS = 8  # warps a block in csrc/fused_norm.cu, one row each at a time
CLUSTER = 8      # blocks of the backward kernel's thread block clusters
BWD_D_MULTIPLE = 64  # the backward's slices of D / CLUSTER columns hold whole 16-byte chunks


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
    sum over rows of g*(x*inv), fp32 [D] (the wrapper casts it)."""
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
_ptr = ctypes.c_void_p


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


def bwd_plan(r: int, capacity: int):
    """(blocks, rows a block) of the backward kernel at ``r`` rows, given
    the blocks the card holds at once (``capacity``, a multiple of CLUSTER):
    about ``capacity`` blocks with a row for each warp at least, in whole
    clusters.  Block b owns rows [b * rows, (b + 1) * rows) and its warp w
    rows b * rows + w + 8k; blocks past the last row (at most CLUSTER - 1,
    all in the last cluster) add zeros to ds."""
    if r <= 0 or capacity <= 0 or capacity % CLUSTER:
        raise ValueError(f'bad backward plan input: {r} rows, capacity {capacity}')
    want = min(capacity, -(-r // BLOCK_WARPS))
    rows = -(-r // want)
    blocks = -(-r // rows)
    return -(-blocks // CLUSTER) * CLUSTER, rows


TICKET_SLOTS = 256  # streams that may run the backward on a device (csrc/fused_norm.cu)
_capacity = {}
_slots = {}


def bwd_capacity(dtype, d: int, device) -> int:
    """Blocks of the backward kernel the card holds at once at rows of
    ``d`` in ``dtype`` (the occupancy API's count, in whole clusters),
    looked up once a (device, dtype, d)."""
    key = (device, dtype, d)
    cap = _capacity.get(key)
    if cap is None:
        with torch.cuda.device(device):
            cap = _build.function('rf_rms_norm_bwd_capacity')(_CODES[dtype], d)
        if cap <= 0:
            raise RuntimeError(f'rf_rms_norm_bwd_capacity: no resident cluster at D={d}, '
                               f'{dtype}')
        _capacity[key] = cap
    return cap


def _ticket_slot(device, stream: int) -> int:
    """The backward's slot of tickets for ``stream`` on ``device``: a row of
    a device variable of the kernel's module, zero when it loads, left at
    zero by every launch and never freed, so a CUDA graph captured on the
    stream may use it as long as the graph lives.  The launches on a stream
    and the replays of the graphs captured on it share the slot, so they
    must not run at the same time (as with cuBLAS's workspace, which is
    also one a stream)."""
    slot = _slots.get((device, stream))
    if slot is None:
        slot = sum(1 for dev, _ in _slots if dev == device)
        if slot >= TICKET_SLOTS:
            raise RuntimeError(f'rms_norm_bwd: more than {TICKET_SLOTS} streams ran the '
                               f'backward on device {device}')
        _slots[device, stream] = slot
    return slot


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
    rc = _build.function('rf_rms_norm_fwd')(
        _ptr(x.data_ptr()), _ptr(scale.data_ptr()), _ptr(y.data_ptr()), code, scode, r, d,
        ctypes.c_float(eps), _ptr(stream))
    if rc:
        _build.check(rc, 'rf_rms_norm_fwd')
    LAUNCHES['rms_norm_fwd'] += 1
    return y


def rms_norm_bwd(x, scale, g, eps: float):
    """K11's backward at x [R, D] for the cotangent g [R, D]: (dx in x's
    dtype, ds [D] in the scale's), in one launch on the card.  A bf16
    scale's ds is the fp32 sum that its fp32 cast gives, rounded once."""
    _check_2d(x, scale, ('g', g))
    if use_plain(x):
        dx, ds = rms_norm_bwd_plain(x, scale, g, eps)
        return dx, ds.to(scale.dtype)
    code, scode, stream = _kernel_args(x, scale, ('g', g))
    r, d = x.shape
    if d % BWD_D_MULTIPLE:
        raise ValueError(f'the backward kernel takes rows of a multiple of {BWD_D_MULTIPLE} '
                         f'columns, got {d}')
    dev = x.get_device()
    blocks, rows = bwd_plan(r, bwd_capacity(x.dtype, d, dev))
    # the ds partials, written and read by the launch alone: held to its end
    # here, then the allocator's, in stream order (in a graph, the graph's)
    part = torch.empty(blocks // CLUSTER * d, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    ds = torch.empty_like(scale)
    rc = _build.function('rf_rms_norm_bwd')(
        _ptr(x.data_ptr()), _ptr(scale.data_ptr()), _ptr(g.data_ptr()), _ptr(dx.data_ptr()),
        _ptr(ds.data_ptr()), _ptr(part.data_ptr()), _ticket_slot(dev, stream), code, scode,
        r, d, blocks, rows, ctypes.c_float(eps), _ptr(stream))
    if rc:
        _build.check(rc, 'rf_rms_norm_bwd')
    LAUNCHES['rms_norm_bwd'] += 1
    return dx, ds


class _FusedRMSNorm(torch.autograd.Function):
    """The JAX package's ``_fused`` custom VJP: the forward keeps x and the
    scale it was given (a stage's cast one under a train step), the backward
    runs K11's backward, whose ds comes in the scale's dtype."""

    @staticmethod
    def forward(ctx, x2, scale, eps):
        ctx.save_for_backward(x2, scale)
        ctx.eps = eps
        return rms_norm_fwd(x2, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x2, scale = ctx.saved_tensors
        dx, ds = rms_norm_bwd(x2, scale, g.contiguous(), ctx.eps)
        return dx, ds, None


def fused_rms_norm(x, scale, eps: float):
    """RMSNorm of x [..., D] over its last axis through K11; where autograd
    tracks x or the scale, the backward is K11's too."""
    x2 = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        out = _FusedRMSNorm.apply(x2, scale, eps)
    else:
        out = rms_norm_fwd(x2, scale, eps)
    return out.reshape(x.shape)
