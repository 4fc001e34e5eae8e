"""Bilinear resize with align_corners=True (kernel K4), the same resize
written in space-to-depth layout (kernel K5), and their plain PyTorch
versions.  K4: NHWC ``[B, IH, IW, C] -> [B, OH, OW, C]``; K5:
``[B, IH, IW, C] -> [B, OH/2, OW/2, 4C]`` with the packing of
``ops/s2d_conv.py``, the input of the composed DPT tail.  The CUDA source
of both is ``csrc/resize.cu``; its note says what bounds them on the card."""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from renderformer_tpu_torch import _build
from renderformer_tpu_torch.ops import (
    LAUNCHES, check_cuda_tensor, check_no_grad, use_plain)
from renderformer_tpu_torch.ops.s2d_conv import space_to_depth

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
    return (torch.from_numpy(i0).to(device), torch.from_numpy(i1).to(device),
            torch.from_numpy(frac).to(device=device, dtype=dtype))


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


def _check_input(x, out_hw):
    if x.dim() != 4:
        raise ValueError('x must be [B, H, W, C]')
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if oh <= 0 or ow <= 0:
        raise ValueError(f'bad output size {out_hw}')
    if not x.is_contiguous():
        raise ValueError('x: expected a contiguous tensor')
    check_no_grad(x)
    return oh, ow


def _launch(fn_name, x, out, oh, ow):
    b, ih, iw, c = x.shape
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f'resize kernel takes {KERNEL_DTYPES}, got {x.dtype}')
    if (c * x.element_size()) % 16:
        raise ValueError(f'resize kernel needs C*itemsize % 16 == 0, got C={c}')
    check_cuda_tensor('x', x, x.dtype, (b, ih, iw, c))
    rc = getattr(_build.library(), fn_name)(
        x.data_ptr(), out.data_ptr(), _build.DTYPE_CODES[str(x.dtype).split('.')[-1]],
        b, ih, iw, oh, ow, c, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, fn_name)
    return out


def resize_bilinear(x, out_hw: Tuple[int, int]):
    """[B, IH, IW, C] -> [B, OH, OW, C], align_corners=True."""
    oh, ow = _check_input(x, out_hw)
    if use_plain(x):
        return resize_bilinear_plain(x, (oh, ow))
    b, _, _, c = x.shape
    out = _launch('rf_resize_bilinear', x,
                  torch.empty((b, oh, ow, c), dtype=x.dtype, device=x.device), oh, ow)
    LAUNCHES['resize_bilinear'] += 1
    return out


def resize_s2d(x, out_hw: Tuple[int, int]):
    """[B, IH, IW, C] -> space_to_depth(resize(x)) = [B, OH/2, OW/2, 4C],
    align_corners=True; OH and OW even."""
    oh, ow = _check_input(x, out_hw)
    if oh % 2 or ow % 2:
        raise ValueError(f'space-to-depth needs an even output size, got {out_hw}')
    if use_plain(x):
        return resize_s2d_plain(x, (oh, ow))
    b, _, _, c = x.shape
    out = _launch('rf_resize_s2d', x, torch.empty(
        (b, oh // 2, ow // 2, 4 * c), dtype=x.dtype, device=x.device), oh, ow)
    LAUNCHES['resize_s2d'] += 1
    return out
