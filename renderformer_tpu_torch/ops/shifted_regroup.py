"""Shifted-window regroup (kernel K7) and its plain PyTorch version.

A window-ordered stream ``[B, S, C]`` (S = h*w, unshifted windows of
ws x ws tokens, row-major inside a window) goes into shifted-window order,
the grouping of partition(roll(x, -ws/2)), or back with ``inverse``.  With
the shift ws/2, the only one the model uses, every destination window is
four quadrant blocks of four source windows:

    out[b, w, i, j] = x[b, tbl[w, 2*(i >= s) + (j >= s)], (i+s) % ws, (j+s) % ws]

with s = ws/2 and ``tbl`` from :func:`window_table`; the inverse uses the
inverse table.  The CUDA source is ``csrc/shifted_regroup.cu``.  The plain
version is the slice/roll/concat of :func:`renderformer_tpu_torch.nn.swin.
shifted_regroup`.  The regroup is a permutation, so its VJP is the inverse
regroup: K7 again with ``inverse`` flipped.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from renderformer_tpu_torch import _build
from renderformer_tpu_torch.nn.swin import shifted_regroup as shifted_regroup_plain
from renderformer_tpu_torch.ops import LAUNCHES, check_cuda_tensor, use_plain


@functools.lru_cache(maxsize=64)
def window_table(wr: int, wc: int, inverse: bool) -> np.ndarray:
    """[nW, 4] int32 source window of (destination window, quadrant
    2*bi + bj) on a wr x wc window grid.  Forward:
    src = ((r + bi) % wr, (c + bj) % wc); inverse:
    src = ((r + bi - 1) % wr, (c + bj - 1) % wc)."""
    r = np.arange(wr)[:, None, None, None]
    c = np.arange(wc)[None, :, None, None]
    bi = np.arange(2)[None, None, :, None]
    bj = np.arange(2)[None, None, None, :]
    d = -1 if inverse else 0
    src = ((r + bi + d) % wr) * wc + ((c + bj + d) % wc)
    return np.ascontiguousarray(src.reshape(wr * wc, 4).astype(np.int32))


@functools.lru_cache(maxsize=64)
def regroup_index(h: int, w: int, ws: int, inverse: bool) -> np.ndarray:
    """[S] int64 gather index of the regroup: out[:, t] = x[:, idx[t]].
    The model does not use it; it is the library form of K7
    (``x.index_select(1, idx)``) that the kernel is timed against."""
    s = ws // 2
    tbl = window_table(h // ws, w // ws, inverse)            # [nW, 4]
    i, j = np.arange(ws)[:, None], np.arange(ws)[None, :]
    quad = 2 * (i >= s) + (j >= s)                            # [ws, ws]
    pos = ((i + s) % ws) * ws + (j + s) % ws                  # [ws, ws]
    return (tbl[:, quad].astype(np.int64) * ws * ws + pos).reshape(-1)


@functools.lru_cache(maxsize=None)  # unbounded: a captured CUDA graph reads it in place
def _device_table(wr: int, wc: int, inverse: bool, device: torch.device):
    with torch.inference_mode(False):  # cached: usable later under autograd
        return torch.from_numpy(window_table(wr, wc, inverse)).to(device)


def regroup_kernel_applicable(seq: int, grid_hw: Tuple[int, int], ws: int,
                              shift: int) -> bool:
    """The kernel's shapes: shift ws/2 on a grid of whole windows."""
    h, w = grid_hw
    return (ws >= 2 and shift * 2 == ws and h % ws == 0 and w % ws == 0
            and seq == h * w)


def _regroup(x, h: int, w: int, ws: int, inverse: bool):
    if use_plain(x):
        return shifted_regroup_plain(x, h, w, ws, ws // 2, inverse)
    b, seq, c = x.shape
    if (c * x.element_size()) % 16:
        raise ValueError(f'regroup kernel needs C*itemsize % 16 == 0, got C={c}')
    check_cuda_tensor('x', x, x.dtype, (b, seq, c))
    wr, wc = h // ws, w // ws
    tbl = _device_table(wr, wc, bool(inverse), x.device)
    out = torch.empty_like(x)
    rc = _build.library().rf_shifted_regroup(
        x.data_ptr(), tbl.data_ptr(), out.data_ptr(), b, wr * wc, ws,
        c * x.element_size(), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, 'rf_shifted_regroup')
    LAUNCHES['shifted_regroup'] += 1
    return out


class _ShiftedRegroup(torch.autograd.Function):
    """The regroup, and as its VJP the inverse regroup of the cotangent."""

    @staticmethod
    def forward(ctx, x, h, w, ws, inverse):
        ctx.args = (h, w, ws, inverse)
        return _regroup(x, h, w, ws, inverse)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        h, w, ws, inverse = ctx.args
        return _regroup(g.contiguous(), h, w, ws, not inverse), None, None, None, None


def shifted_regroup(x, grid_hw: Tuple[int, int], ws: int, inverse: bool = False):
    """x [B, S, C] in unshifted-window order (shifted order when
    ``inverse``) -> the other order; the shift is ws // 2.  Differentiable
    in x."""
    if x.dim() != 3:
        raise ValueError('x must be [B, S, C]')
    seq = x.shape[1]
    h, w = int(grid_hw[0]), int(grid_hw[1])
    if not regroup_kernel_applicable(seq, (h, w), ws, ws // 2):
        raise ValueError(f'regroup takes a {h}x{w} grid of whole {ws}x{ws} windows '
                         f'with S = h*w, got S={seq}')
    if not x.is_contiguous():
        raise ValueError('x: expected a contiguous tensor')
    if torch.is_grad_enabled() and x.requires_grad:
        return _ShiftedRegroup.apply(x, h, w, ws, bool(inverse))
    return _regroup(x, h, w, ws, bool(inverse))
