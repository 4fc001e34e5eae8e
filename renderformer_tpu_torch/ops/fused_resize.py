"""Bilinear resize with align_corners=True (kernel K4) and its plain
PyTorch version.  NHWC ``[B, IH, IW, C] -> [B, OH, OW, C]``.  The CUDA
source is ``csrc/resize.cu``; its note says what bounds it on the card."""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from renderformer_tpu_torch import _build
from renderformer_tpu_torch.ops import (
    LAUNCHES, check_cuda_tensor, check_no_grad, use_plain)

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


def _resize_axis(x, axis: int, n_out: int):
    i0, i1, frac = interp_gather(x.shape[axis], n_out)
    shape = [1] * x.dim()
    shape[axis] = n_out
    f = torch.from_numpy(frac).to(device=x.device, dtype=x.dtype).reshape(shape)
    lo = x.index_select(axis, torch.from_numpy(i0).to(x.device))
    hi = x.index_select(axis, torch.from_numpy(i1).to(x.device))
    return lo * (1 - f) + hi * f


def resize_bilinear_plain(x, out_hw: Tuple[int, int]):
    """The lerp over H, then over W, in x's dtype."""
    oh, ow = out_hw
    if x.shape[1] != oh:
        x = _resize_axis(x, 1, oh)
    if x.shape[2] != ow:
        x = _resize_axis(x, 2, ow)
    return x


def resize_bilinear(x, out_hw: Tuple[int, int]):
    """[B, IH, IW, C] -> [B, OH, OW, C], align_corners=True."""
    if x.dim() != 4:
        raise ValueError('x must be [B, H, W, C]')
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if oh <= 0 or ow <= 0:
        raise ValueError(f'bad output size {out_hw}')
    if not x.is_contiguous():
        raise ValueError('x: expected a contiguous tensor')
    check_no_grad(x)
    if use_plain(x):
        return resize_bilinear_plain(x, (oh, ow))
    b, ih, iw, c = x.shape
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f'resize kernel takes {KERNEL_DTYPES}, got {x.dtype}')
    if (c * x.element_size()) % 16:
        raise ValueError(f'resize kernel needs C*itemsize % 16 == 0, got C={c}')
    check_cuda_tensor('x', x, x.dtype, (b, ih, iw, c))
    out = torch.empty((b, oh, ow, c), dtype=x.dtype, device=x.device)
    lib = _build.library()
    rc = lib.rf_resize_bilinear(
        x.data_ptr(), out.data_ptr(), _build.DTYPE_CODES[str(x.dtype).split('.')[-1]],
        b, ih, iw, oh, ow, c, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, 'rf_resize_bilinear')
    LAUNCHES['resize_bilinear'] += 1
    return out
