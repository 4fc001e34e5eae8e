"""Bilinear resize with align_corners=True (kernel K4), the same resize
written in space-to-depth layout (kernel K5), K4's adjoint (kernel K4^T),
their plain PyTorch versions, and the autograd Functions that join them.
K4: NHWC ``[B, IH, IW, C] -> [B, OH, OW, C]``; K5: ``[B, IH, IW, C] ->
[B, OH/2, OW/2, 4C]`` with the packing of ``ops/s2d_conv.py``, the input of
the composed DPT tail; K4^T: ``[B, OH, OW, C] -> [B, IH, IW, C]``, the VJP
of K4; K4^T on g ``[B, OH/2, OW/2, 4C]`` in space-to-depth layout, the VJP
of K5 (the JAX package's ``depth_to_space`` then K4^T, without the copy).
The CUDA source of all three is ``csrc/resize.cu``; its note says what
bounds them on the card, and :func:`row_plan` sizes their blocks."""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from renderformer_tpu_torch import _build
from renderformer_tpu_torch.ops import LAUNCHES, use_plain
from renderformer_tpu_torch.ops.s2d_conv import depth_to_space, space_to_depth

KERNEL_DTYPES = (torch.bfloat16, torch.float32)


@functools.lru_cache(maxsize=128)
def interp_gather(n_in: int, n_out: int):
    """Static (i0, i1, frac): out[o] = (1-frac[o])*x[i0[o]] + frac[o]*x[i1[o]]."""
    if n_out == 1 or n_in == 1:
        return (np.zeros(n_out, np.int64), np.zeros(n_out, np.int64),
                np.zeros(n_out, np.float32))
    coords = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    i0 = np.clip(np.floor(coords).astype(np.int64), 0, n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    frac = (coords - i0).astype(np.float32)
    return i0, i1, frac


@functools.lru_cache(maxsize=None)  # unbounded: a captured CUDA graph reads it in place
def _device_taps(n_in: int, n_out: int, device: torch.device, dtype: torch.dtype):
    """:func:`interp_gather`'s tables on ``device``, copied there once (a
    copy from pageable host memory waits for the device to drain)."""
    i0, i1, frac = interp_gather(n_in, n_out)
    with torch.inference_mode(False):  # cached: usable later under autograd
        return (torch.from_numpy(i0).to(device), torch.from_numpy(i1).to(device),
                torch.from_numpy(frac).to(device=device, dtype=dtype))


@functools.lru_cache(maxsize=128)
def interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Dense [n_out, n_in] fp32 matrix of the resize of one axis: row o holds
    1-frac[o] at i0[o] and frac[o] at i1[o], added in that order."""
    i0, i1, frac = interp_gather(n_in, n_out)
    m = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    np.add.at(m, (rows, i0), 1.0 - frac)
    np.add.at(m, (rows, i1), frac)
    return m


@functools.lru_cache(maxsize=128)
def adjoint_taps(n_in: int, n_out: int):
    """Per input index i of the forward map n_in -> n_out: the first output
    index that reads it, their count, and their weights (column i of
    :func:`interp_matrix` from the first to the last nonzero), as
    (span [n_in, 2] int32, weights [n_in, taps] fp32) with taps the largest
    count, zero-padded."""
    m = interp_matrix(n_in, n_out)
    span = np.zeros((n_in, 2), np.int32)
    cols = []
    for i in range(n_in):
        nz = np.nonzero(m[:, i])[0]
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if len(nz) else (0, 0)
        span[i] = lo, hi - lo
        cols.append(m[lo:hi, i])
    taps = max(1, int(span[:, 1].max()))
    w = np.zeros((n_in, taps), np.float32)
    for i, c in enumerate(cols):
        w[i, :len(c)] = c
    return span, w


@functools.lru_cache(maxsize=None)  # unbounded: a captured CUDA graph reads it in place
def _device_adjoint_taps(n_in: int, n_out: int, device: torch.device):
    span, w = adjoint_taps(n_in, n_out)
    with torch.inference_mode(False):  # cached: usable later under autograd
        return torch.from_numpy(span).to(device), torch.from_numpy(w).to(device)


def _lerp_axis(x, axis: int, n_out: int):
    i0, i1, frac = _device_taps(x.shape[axis], n_out, x.device, x.dtype)
    shape = [1] * x.dim()
    shape[axis] = n_out
    f = frac.reshape(shape)
    return x.index_select(axis, i0) * (1 - f) + x.index_select(axis, i1) * f


@functools.lru_cache(maxsize=None)  # unbounded: a captured CUDA graph reads it in place
def _device_adjoint(n_in: int, n_out: int, device: torch.device, dtype: torch.dtype):
    """[n_in, n_out] fp32 transpose of the resize's matrix with the weights
    1 - f and f that the lerp takes in ``dtype``, on ``device``."""
    i0, i1, frac = interp_gather(n_in, n_out)
    f = torch.from_numpy(frac).to(dtype)
    m = torch.zeros(n_in, n_out)
    rows = torch.arange(n_out)
    m.index_put_((torch.from_numpy(i0), rows), (1 - f).float(), accumulate=True)
    m.index_put_((torch.from_numpy(i1), rows), f.float(), accumulate=True)
    with torch.inference_mode(False):  # cached: usable later under autograd
        return m.to(device)


class _ResizeAxis(torch.autograd.Function):
    """The lerp of one axis; its VJP is one product with the transposed
    resize matrix, where index_select's VJP would add the terms of a
    repeated index by atomics, in a run-dependent order on the card."""

    @staticmethod
    def forward(ctx, x, axis, n_out):
        ctx.axis, ctx.n_in, ctx.dtype = axis, x.shape[axis], x.dtype
        return _lerp_axis(x, axis, n_out)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        m = _device_adjoint(ctx.n_in, g.shape[ctx.axis], g.device, ctx.dtype)
        gx = torch.matmul(m, g.movedim(ctx.axis, -2).float()).movedim(-2, ctx.axis)
        return gx.to(g.dtype), None, None


def resize_axis(x, axis: int, n_out: int):
    """Resize one axis of ``x`` to ``n_out`` (align_corners=True), in x's
    dtype; differentiable, with the same VJP on every run."""
    axis = axis % x.dim()
    if torch.is_grad_enabled() and x.requires_grad:
        return _ResizeAxis.apply(x, axis, n_out)
    return _lerp_axis(x, axis, n_out)


def resize_bilinear_plain(x, out_hw: Tuple[int, int]):
    """The lerp over H, then over W, in x's dtype."""
    oh, ow = out_hw
    if x.shape[1] != oh:
        x = resize_axis(x, 1, oh)
    if x.shape[2] != ow:
        x = resize_axis(x, 2, ow)
    return x


def resize_s2d_plain(x, out_hw: Tuple[int, int]):
    """The plain resize computed in fp32 and rounded once to x's dtype (the
    kernel's arithmetic), then space-to-depth."""
    return space_to_depth(resize_bilinear_plain(x.float(), out_hw).to(x.dtype))


def resize_bilinear_t_plain(g, in_hw: Tuple[int, int]):
    """K4's adjoint: g [B, OH, OW, C] -> [B, IH, IW, C] with the transposed
    interpolation matrices, H pass then W pass, in fp32, rounded once to g's
    dtype."""
    ih, iw = in_hw
    mh = torch.from_numpy(interp_matrix(ih, g.shape[1])).to(g.device)
    mw = torch.from_numpy(interp_matrix(iw, g.shape[2])).to(g.device)
    t = torch.einsum('oi,bowc->biwc', mh, g.float())
    return torch.einsum('oj,bioc->bijc', mw, t).to(g.dtype)


def _check_input(x, out_hw):
    if x.dim() != 4:
        raise ValueError('x must be [B, H, W, C]')
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if oh <= 0 or ow <= 0:
        raise ValueError(f'bad output size {out_hw}')
    if not x.is_contiguous():
        raise ValueError('x: expected a contiguous tensor')
    return oh, ow


# dtype -> (its code in the C interface, elements in 16 bytes)
_CODES = {torch.bfloat16: (_build.DTYPE_CODES['bfloat16'], 8),
          torch.float32: (_build.DTYPE_CODES['float32'], 4)}
_ptr = ctypes.c_void_p


def _kernel_args(name, x, c):
    """Check x [B, H, W, C] (contiguous, as ``_check_input`` saw it) for a
    resize kernel on the card: a kernel dtype, 16-byte channel vectors, a
    16-byte aligned start; returns (x's address, its dtype code, the raw
    current stream), the two pointers as ``c_void_p``."""
    code, vec = _CODES.get(x.dtype, (None, 0))
    if code is None:
        raise ValueError(f'resize kernel takes {KERNEL_DTYPES}, got {x.dtype}')
    if c % vec:
        raise ValueError(f'resize kernel needs C*itemsize % 16 == 0, got C={c}')
    xp = x.data_ptr()
    if xp % 16:
        raise ValueError(f'{name}: expected a 16-byte aligned tensor')
    return _ptr(xp), code, _ptr(torch._C._cuda_getCurrentRawStream(x.get_device()))


# the row-tiled kernels' plan, as csrc/resize.cu reads it: threads a block
# (ROW_THREADS rounded down to whole pixels), at most ROW_VPT steps of the
# block's pixels a block, and at most TAP_SMEM bytes of a block's taps
ROW_THREADS, ROW_VPT, TAP_SMEM = 256, 16, 32 << 10
MIN_BLOCKS = 2 * 132  # two blocks an SM of the H100's 132
MAX_VECTORS = 1024    # 16-byte vectors a pixel: a block's most threads


@functools.lru_cache(maxsize=256)
def row_plan(row_px: int, rows: int, pv: int, tap_bytes: int):
    """(threads a block, pixels a block) of a row-tiled resize kernel (K4,
    K5 or K4^T) over ``rows`` rows (of every image) of ``row_px`` pixels of
    ``pv`` 16-byte vectors, whose taps take ``tap_bytes`` of shared memory a
    pixel.  Thread t takes vector t % pv of every (threads // pv)-th pixel of
    the block's chunk of a row; the chunk is the most steps (at most
    ROW_VPT) that leave the grid MIN_BLOCKS blocks and its taps in
    TAP_SMEM."""
    if not 0 < pv <= MAX_VECTORS:
        raise ValueError(f'resize kernel takes at most {MAX_VECTORS} 16-byte vectors a '
                         f'pixel, got {pv}')
    threads = ROW_THREADS // pv * pv if pv < ROW_THREADS else pv
    dpx = threads // pv
    vpt = ROW_VPT
    while vpt > 1 and (-(-row_px // (dpx * vpt)) * rows < MIN_BLOCKS
                       or dpx * vpt * tap_bytes > TAP_SMEM):
        vpt //= 2
    return threads, dpx * vpt


def _resize_fwd(x, oh, ow, s2d=False):
    """K4 (or with ``s2d`` K5) on x [B, IH, IW, C], or its plain version."""
    if use_plain(x):
        return resize_s2d_plain(x, (oh, ow)) if s2d else resize_bilinear_plain(x, (oh, ow))
    b, ih, iw, c = x.shape
    xp, code, stream = _kernel_args('x', x, c)
    s = 2 if s2d else 1
    # a stored pixel: S x S output pixels; its column taps 16 bytes each
    _, ppb = row_plan(ow // s, oh // s * b, s * s * c * x.element_size() // 16, 16 * s)
    name = 'rf_resize_s2d' if s2d else 'rf_resize_bilinear'
    out = x.new_empty((b, oh // 2, ow // 2, 4 * c) if s2d else (b, oh, ow, c))
    rc = _build.function(name)(xp, _ptr(out.data_ptr()), code, b, ih, iw, oh, ow, c, ppb,
                               stream)
    if rc:
        _build.check(rc, name)
    LAUNCHES['resize_s2d' if s2d else 'resize_bilinear'] += 1
    return out


def _resize_t(g, ih, iw, oh, ow, s2d):
    """K4^T on g (NHWC, or with ``s2d`` in space-to-depth layout) of the
    resize from (ih, iw) to (oh, ow)."""
    b, c = g.shape[0], g.shape[3] // (4 if s2d else 1)
    gp, code, stream = _kernel_args('g', g, c)
    span_h, w_h = _device_adjoint_taps(ih, oh, g.device)
    span_w, w_w = _device_adjoint_taps(iw, ow, g.device)
    # a pixel's column taps: 4 of 8 bytes (wider tables read them in the loop)
    _, ppb = row_plan(iw, ih * b, c * g.element_size() // 16, 32)
    out = g.new_empty((b, ih, iw, c))
    rc = _build.function('rf_resize_bilinear_t')(
        gp, _ptr(out.data_ptr()), _ptr(span_h.data_ptr()), _ptr(w_h.data_ptr()), w_h.shape[1],
        _ptr(span_w.data_ptr()), _ptr(w_w.data_ptr()), w_w.shape[1], code, int(s2d), b, ih, iw,
        oh, ow, c, ppb, stream)
    if rc:
        _build.check(rc, 'rf_resize_bilinear_t')
    LAUNCHES['resize_bilinear_t'] += 1
    return out


def resize_bilinear_t(g, in_hw: Tuple[int, int]):
    """The VJP of :func:`resize_bilinear` from ``in_hw``: g [B, OH, OW, C]
    -> [B, IH, IW, C] (kernel K4^T on the card)."""
    ih, iw = _check_input(g, in_hw)
    if use_plain(g):
        return resize_bilinear_t_plain(g, (ih, iw))
    return _resize_t(g, ih, iw, g.shape[1], g.shape[2], s2d=False)


def resize_s2d_t(g, in_hw: Tuple[int, int]):
    """The VJP of :func:`resize_s2d` from ``in_hw``: g [B, OH/2, OW/2, 4C]
    -> [B, IH, IW, C] (kernel K4^T reading g in place on the card; the plain
    version is K4^T's after ``depth_to_space``, the JAX package's
    ``_resize_s2d_bwd``)."""
    ih, iw = _check_input(g, in_hw)
    if g.shape[3] % 4:
        raise ValueError(f'space-to-depth g needs 4C channels, got {g.shape[3]}')
    if use_plain(g):
        return resize_bilinear_t_plain(depth_to_space(g), (ih, iw))
    return _resize_t(g, ih, iw, 2 * g.shape[1], 2 * g.shape[2], s2d=True)


class _Resize(torch.autograd.Function):
    """K4 forward, K4^T backward (the JAX package's ``_resize`` VJP)."""

    @staticmethod
    def forward(ctx, x, oh, ow):
        ctx.in_hw = (x.shape[1], x.shape[2])
        return _resize_fwd(x, oh, ow)

    @staticmethod
    def backward(ctx, g):
        return resize_bilinear_t(g.contiguous(), ctx.in_hw), None, None


class _ResizeS2d(torch.autograd.Function):
    """K5 forward; backward K4^T on g in space-to-depth layout
    (``_resize_s2d_bwd``, with no depth_to_space copy on the card)."""

    @staticmethod
    def forward(ctx, x, oh, ow):
        ctx.in_hw = (x.shape[1], x.shape[2])
        return _resize_fwd(x, oh, ow, s2d=True)

    @staticmethod
    def backward(ctx, g):
        return resize_s2d_t(g.contiguous(), ctx.in_hw), None, None


def resize_bilinear(x, out_hw: Tuple[int, int]):
    """[B, IH, IW, C] -> [B, OH, OW, C], align_corners=True; differentiable
    (backward K4^T)."""
    oh, ow = _check_input(x, out_hw)
    if x.requires_grad and torch.is_grad_enabled():
        return _Resize.apply(x, oh, ow)
    return _resize_fwd(x, oh, ow)


def resize_s2d(x, out_hw: Tuple[int, int]):
    """[B, IH, IW, C] -> space_to_depth(resize(x)) = [B, OH/2, OW/2, 4C],
    align_corners=True; OH and OW even; differentiable (backward
    :func:`resize_s2d_t`)."""
    oh, ow = _check_input(x, out_hw)
    if oh % 2 or ow % 2:
        raise ValueError(f'space-to-depth needs an even output size, got {out_hw}')
    if x.requires_grad and torch.is_grad_enabled():
        return _ResizeS2d.apply(x, oh, ow)
    return _resize_fwd(x, oh, ow, s2d=True)
