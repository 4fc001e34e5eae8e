"""Swin window self-attention (kernel K6) and its plain PyTorch version.

q/k/v are flat window batches ``[B*nW, S, C]`` with the heads packed in C
(``C = num_heads * D``), windows view-major, as the window-ordered residual
stream of the Swin decoder gives them by a reshape.  A shifted layer passes
the ``[nW, S]`` uint8 region table of its window grid
(:func:`renderformer_tpu_torch.nn.swin.swin_regions`): token i of window w
attends to token j when ``regions[w % nW, i] == regions[w % nW, j]``.  The
CUDA source is ``csrc/swin_attention.cu``; its note says what bounds it on
the card.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from renderformer_tpu_torch import _build
from renderformer_tpu_torch.nn.swin import swin_regions
from renderformer_tpu_torch.ops import (
    LAUNCHES, check_cuda_tensor, check_no_grad, use_plain)

NEG_INF = -1e30
LOG2E = 1.4426950408889634
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
KERNEL_WINDOW = 64
KERNEL_HEAD_DIM = 128


def q_scale(d: int) -> float:
    """D^-0.5 * log2(e): q is multiplied by it in fp32 and rounded to its
    dtype, so the scores come out in log2 units."""
    return 1.0 / math.sqrt(d) * LOG2E


@functools.lru_cache(maxsize=64)
def region_table(h: int, w: int, window_size: int, shift_size: int,
                 device: torch.device) -> torch.Tensor:
    """The [nW, ws*ws] uint8 region table of a shifted h x w grid, on
    ``device``."""
    return torch.from_numpy(swin_regions(h, w, window_size, shift_size)).to(device)


def swin_window_attention_plain(q, k, v, num_heads: int,
                                regions: Optional[torch.Tensor] = None):
    """The kernel's function in torch ops: q scaled in fp32 and rounded to
    its dtype, fp32 scores plus -1e30 on masked pairs, e = exp2(s - max),
    p = e / sum(e) rounded to v's dtype, P.V in fp32, rounded once."""
    bw, s, c = q.shape
    h = num_heads
    d = c // h
    qs = (q.float() * q_scale(d)).to(q.dtype)
    logits = torch.einsum('wqhd,wkhd->whqk', qs.float().reshape(bw, s, h, d),
                          k.float().reshape(bw, s, h, d))
    if regions is not None:
        nw = regions.shape[0]
        same = regions[:, :, None] == regions[:, None, :]
        bias = torch.where(same, 0.0, NEG_INF).to(torch.float32)
        logits = (logits.reshape(bw // nw, nw, h, s, s)
                  + bias[None, :, None]).reshape(bw, h, s, s)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp2(logits - m)
    p = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype)
    out = torch.einsum('whqk,wkhd->wqhd', p.float(), v.float().reshape(bw, s, h, d))
    return out.reshape(bw, s, c).to(q.dtype)


def swin_window_attention(q, k, v, *, num_heads: int,
                          regions: Optional[torch.Tensor] = None):
    """Attention inside each window: q/k/v [B*nW, S, C] -> [B*nW, S, C] in
    q's dtype; ``regions`` [nW, S] uint8 for a shifted layer, None for an
    unshifted one.  On the card: S = 64 and C / num_heads = 128."""
    if q.dim() != 3:
        raise ValueError('q, k and v must be [B*nW, S, C]')
    bw, s, c = q.shape
    for name, t in (('k', k), ('v', v)):
        if tuple(t.shape) != (bw, s, c):
            raise ValueError(f'{name} must be {(bw, s, c)}, got {tuple(t.shape)}')
    if num_heads <= 0 or c % num_heads:
        raise ValueError(f'C={c} is not a multiple of num_heads={num_heads}')
    if regions is not None:
        if regions.dim() != 2 or regions.shape[1] != s or bw % regions.shape[0]:
            raise ValueError(f'regions must be [nW, {s}] with nW dividing {bw}, '
                             f'got {tuple(regions.shape)}')
        if regions.dtype != torch.uint8:
            raise ValueError(f'regions must be uint8, got {regions.dtype}')
    for name, t in (('q', q), ('k', k), ('v', v)):
        if not t.is_contiguous():
            raise ValueError(f'{name}: expected a contiguous tensor')
    check_no_grad(q, k, v)
    if use_plain(q):
        return swin_window_attention_plain(q, k, v, num_heads, regions)
    d = c // num_heads
    if s != KERNEL_WINDOW or d != KERNEL_HEAD_DIM:
        raise ValueError(f'swin kernel takes {KERNEL_WINDOW}-token windows and head '
                         f'dim {KERNEL_HEAD_DIM}, got S={s}, D={d}')
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f'swin kernel takes {KERNEL_DTYPES}, got {q.dtype}')
    for name, t in (('q', q), ('k', k), ('v', v)):
        check_cuda_tensor(name, t, q.dtype, (bw, s, c))
    nw = 1
    if regions is not None:
        nw = regions.shape[0]
        check_cuda_tensor('regions', regions, torch.uint8, (nw, s))
    out = torch.empty_like(q)
    rc = _build.library().rf_swin_window_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        regions.data_ptr() if regions is not None else None, out.data_ptr(),
        _build.DTYPE_CODES[str(q.dtype).split('.')[-1]], int(regions is not None),
        bw, nw, num_heads, q_scale(d), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, 'rf_swin_window_attention')
    LAUNCHES['swin_window_attention'] += 1
    return out
