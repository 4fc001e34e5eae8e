"""Bilinear resize with align_corners=True (kernel K4), the same resize
written in space-to-depth layout (kernel K5), K4's adjoint (kernel K4^T),
their plain PyTorch versions, and the autograd Functions that join them.
K4: NHWC ``[B, IH, IW, C] -> [B, OH, OW, C]``; K5: ``[B, IH, IW, C] ->
[B, OH/2, OW/2, 4C]`` with the packing of ``ops/s2d_conv.py``, the input of
the composed DPT tail; K4^T: ``[B, OH, OW, C] -> [B, IH, IW, C]``, the VJP
of K4, and after a ``depth_to_space`` of K5, as in the JAX package.  The
CUDA source of all three is ``csrc/resize.cu``; its note says what bounds
them on the card."""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

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


@functools.lru_cache(maxsize=128)
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


@functools.lru_cache(maxsize=128)
def _device_adjoint_taps(n_in: int, n_out: int, device: torch.device):
    span, w = adjoint_taps(n_in, n_out)
    with torch.inference_mode(False):  # cached: usable later under autograd
        return torch.from_numpy(span).to(device), torch.from_numpy(w).to(device)


def resize_axis(x, axis: int, n_out: int):
    """Resize one axis of ``x`` to ``n_out`` (align_corners=True), in x's
    dtype."""
    i0, i1, frac = _device_taps(x.shape[axis], n_out, x.device, x.dtype)
    shape = [1] * x.dim()
    shape[axis] = n_out
    f = frac.reshape(shape)
    return x.index_select(axis, i0) * (1 - f) + x.index_select(axis, i1) * f


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


def _resize_fwd(x, oh, ow, s2d=False):
    """K4 (or with ``s2d`` K5) on x [B, IH, IW, C], or its plain version."""
    if use_plain(x):
        return resize_s2d_plain(x, (oh, ow)) if s2d else resize_bilinear_plain(x, (oh, ow))
    b, ih, iw, c = x.shape
    xp, code, stream = _kernel_args('x', x, c)
    name = 'rf_resize_s2d' if s2d else 'rf_resize_bilinear'
    out = x.new_empty((b, oh // 2, ow // 2, 4 * c) if s2d else (b, oh, ow, c))
    rc = _build.function(name)(xp, _ptr(out.data_ptr()), code, b, ih, iw, oh, ow, c, stream)
    if rc:
        _build.check(rc, name)
    LAUNCHES['resize_s2d' if s2d else 'resize_bilinear'] += 1
    return out


def resize_bilinear_t(g, in_hw: Tuple[int, int]):
    """The VJP of :func:`resize_bilinear` from ``in_hw``: g [B, OH, OW, C]
    -> [B, IH, IW, C] (kernel K4^T on the card)."""
    ih, iw = _check_input(g, in_hw)
    if use_plain(g):
        return resize_bilinear_t_plain(g, (ih, iw))
    b, oh, ow, c = g.shape
    gp, code, stream = _kernel_args('g', g, c)
    span_h, w_h = _device_adjoint_taps(ih, oh, g.device)
    span_w, w_w = _device_adjoint_taps(iw, ow, g.device)
    out = g.new_empty((b, ih, iw, c))
    rc = _build.function('rf_resize_bilinear_t')(
        gp, _ptr(out.data_ptr()), _ptr(span_h.data_ptr()), _ptr(w_h.data_ptr()), w_h.shape[1],
        _ptr(span_w.data_ptr()), _ptr(w_w.data_ptr()), w_w.shape[1], code, b, ih, iw, oh, ow,
        c, stream)
    if rc:
        _build.check(rc, 'rf_resize_bilinear_t')
    LAUNCHES['resize_bilinear_t'] += 1
    return out


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
    """K5 forward; backward depth_to_space then K4^T (``_resize_s2d_bwd``)."""

    @staticmethod
    def forward(ctx, x, oh, ow):
        ctx.in_hw = (x.shape[1], x.shape[2])
        return _resize_fwd(x, oh, ow, s2d=True)

    @staticmethod
    def backward(ctx, g):
        return resize_bilinear_t(depth_to_space(g).contiguous(), ctx.in_hw), None, None


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
    depth_to_space, then K4^T)."""
    oh, ow = _check_input(x, out_hw)
    if oh % 2 or ow % 2:
        raise ValueError(f'space-to-depth needs an even output size, got {out_hw}')
    if x.requires_grad and torch.is_grad_enabled():
        return _ResizeS2d.apply(x, oh, ow)
    return _resize_fwd(x, oh, ow, s2d=True)
