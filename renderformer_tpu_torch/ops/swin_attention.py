"""Swin window self-attention (kernel K6), its backward (K6^T), and their
plain PyTorch versions.

q/k/v are flat window batches ``[B*nW, S, C]`` with the heads packed in C
(``C = num_heads * D``), windows view-major, as the window-ordered residual
stream of the Swin decoder gives them by a reshape.  A shifted layer passes
the ``[nW, S]`` uint8 region table of its window grid
(:func:`renderformer_tpu_torch.nn.swin.swin_regions`): token i of window w
attends to token j when ``regions[w % nW, i] == regions[w % nW, j]``.
:func:`swin_window_attention` is differentiable: its backward is K6^T, the
gradient of the same function with each window's 64 keys resident.  The
CUDA sources are ``csrc/swin_attention.cu`` and
``csrc/swin_attention_bwd.cu``; their notes say what bounds them on the
card.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from renderformer_tpu_torch import _build
from renderformer_tpu_torch.nn.swin import swin_regions
from renderformer_tpu_torch.ops import LAUNCHES, check_cuda_tensor, use_plain

NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
KERNEL_WINDOW = 64
KERNEL_HEAD_DIM = 128


def q_scale(d: int) -> float:
    """D^-0.5 * log2(e): q is multiplied by it in fp32 and rounded to its
    dtype, so the scores come out in log2 units."""
    return 1.0 / math.sqrt(d) * LOG2E


@functools.lru_cache(maxsize=None)  # unbounded: a captured CUDA graph reads it in place
def region_table(h: int, w: int, window_size: int, shift_size: int,
                 device: torch.device) -> torch.Tensor:
    """The [nW, ws*ws] uint8 region table of a shifted h x w grid, on
    ``device``."""
    with torch.inference_mode(False):  # cached: usable later under autograd
        return torch.from_numpy(swin_regions(h, w, window_size, shift_size)).to(device)


def _probs(q, k, num_heads: int, regions: Optional[torch.Tensor]):
    """(q scaled and rounded to its dtype [BW, S, H, D], the fp32 softmax
    [BW, H, S, S]) of the forward: fp32 scores in log2 units plus -1e30 on
    masked pairs, e = exp2(s - max), p = e / sum(e)."""
    bw, s, c = q.shape
    h = num_heads
    d = c // h
    qs = (q.float() * q_scale(d)).to(q.dtype).reshape(bw, s, h, d)
    logits = torch.einsum('wqhd,wkhd->whqk', qs.float(), k.float().reshape(bw, s, h, d))
    if regions is not None:
        nw = regions.shape[0]
        same = regions[:, :, None] == regions[:, None, :]
        bias = torch.where(same, 0.0, NEG_INF).to(torch.float32)
        logits = (logits.reshape(bw // nw, nw, h, s, s)
                  + bias[None, :, None]).reshape(bw, h, s, s)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp2(logits - m)
    return qs, e / e.sum(dim=-1, keepdim=True)


def swin_window_attention_plain(q, k, v, num_heads: int,
                                regions: Optional[torch.Tensor] = None):
    """The kernel's function in torch ops: q scaled in fp32 and rounded to
    its dtype, fp32 scores plus -1e30 on masked pairs, e = exp2(s - max),
    p = e / sum(e) rounded to v's dtype, P.V in fp32, rounded once."""
    bw, s, c = q.shape
    d = c // num_heads
    _, p = _probs(q, k, num_heads, regions)
    out = torch.einsum('whqk,wkhd->wqhd', p.to(v.dtype).float(),
                       v.float().reshape(bw, s, num_heads, d))
    return out.reshape(bw, s, c).to(q.dtype)


def swin_window_attention_bwd_plain(q, k, v, do, num_heads: int,
                                    regions: Optional[torch.Tensor] = None):
    """K6^T's function in torch ops, in its order of rounding: the gradients
    (dq, dk, dv) of :func:`swin_window_attention_plain` for the cotangent
    ``do``, with a rounding to a dtype taken as the identity.  The softmax
    is recomputed as the forward computes it; then, all in fp32 on values in
    the inputs' dtype,

        dV = P^T dO                      (P rounded to v's dtype)
        dP = dO V^T
        dS = (P o (dP - rowsum(P o dP))) * ln 2, rounded to v's dtype
        dQ = (dS K) * D^-0.5 * log2(e)
        dK = dS^T (q scaled and rounded, as the forward's scores use it)

    with P the fp32 softmax; the ln 2 turns the exp2 domain's scores back
    into q's units.  Each gradient is rounded once to q's dtype."""
    bw, s, c = q.shape
    h = num_heads
    d = c // h
    qs, p = _probs(q, k, h, regions)
    dof = do.float().reshape(bw, s, h, d)
    dv = torch.einsum('whqk,wqhd->wkhd', p.to(v.dtype).float(), dof)
    dp = torch.einsum('wqhd,wkhd->whqk', dof, v.float().reshape(bw, s, h, d))
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = ((p * (dp - delta)) * LN2).to(v.dtype).float()
    dq = torch.einsum('whqk,wkhd->wqhd', ds, k.float().reshape(bw, s, h, d)) * q_scale(d)
    dk = torch.einsum('whqk,wqhd->wkhd', ds, qs.float())
    return tuple(t.reshape(bw, s, c).to(q.dtype) for t in (dq, dk, dv))


def _check_args(q, k, v, num_heads, regions, *more):
    if q.dim() != 3:
        raise ValueError('q, k and v must be [B*nW, S, C]')
    bw, s, c = q.shape
    for name, t in (('k', k), ('v', v), *more):
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
    for name, t in (('q', q), ('k', k), ('v', v), *more):
        if not t.is_contiguous():
            raise ValueError(f'{name}: expected a contiguous tensor')


def _check_kernel_args(q, k, v, num_heads, regions, *more) -> int:
    """Raise unless the CUDA kernels take these tensors; return nW."""
    bw, s, c = q.shape
    d = c // num_heads
    if s != KERNEL_WINDOW or d != KERNEL_HEAD_DIM:
        raise ValueError(f'swin kernel takes {KERNEL_WINDOW}-token windows and head '
                         f'dim {KERNEL_HEAD_DIM}, got S={s}, D={d}')
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f'swin kernel takes {KERNEL_DTYPES}, got {q.dtype}')
    for name, t in (('q', q), ('k', k), ('v', v), *more):
        check_cuda_tensor(name, t, q.dtype, (bw, s, c))
    if regions is None:
        return 1
    check_cuda_tensor('regions', regions, torch.uint8, (regions.shape[0], s))
    return regions.shape[0]


def _forward(q, k, v, num_heads: int, regions: Optional[torch.Tensor]):
    if use_plain(q):
        return swin_window_attention_plain(q, k, v, num_heads, regions)
    nw = _check_kernel_args(q, k, v, num_heads, regions)
    bw, _, c = q.shape
    out = torch.empty_like(q)
    rc = _build.library().rf_swin_window_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        regions.data_ptr() if regions is not None else None, out.data_ptr(),
        _build.DTYPE_CODES[str(q.dtype).split('.')[-1]], int(regions is not None),
        bw, nw, num_heads, q_scale(c // num_heads),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, 'rf_swin_window_attention')
    LAUNCHES['swin_window_attention'] += 1
    return out


def swin_window_attention_bwd(q, k, v, do, *, num_heads: int,
                              regions: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of :func:`swin_window_attention` at (q, k, v) for the
    cotangent ``do`` [B*nW, S, C], in q's dtype: K6^T on the card (S = 64,
    C / num_heads = 128, every tensor in one dtype), its plain version on
    the CPU."""
    _check_args(q, k, v, num_heads, regions, ('do', do))
    if use_plain(q):
        return swin_window_attention_bwd_plain(q, k, v, do, num_heads, regions)
    nw = _check_kernel_args(q, k, v, num_heads, regions, ('do', do))
    bw, _, c = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    rc = _build.library().rf_swin_window_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        regions.data_ptr() if regions is not None else None,
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _build.DTYPE_CODES[str(q.dtype).split('.')[-1]], int(regions is not None),
        bw, nw, num_heads, q_scale(c // num_heads),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, 'rf_swin_window_attention_bwd')
    LAUNCHES['swin_window_attention_bwd'] += 1
    return dq, dk, dv


class _SwinWindowAttention(torch.autograd.Function):
    """K6 forward, K6^T backward: the inputs are saved, the softmax is
    recomputed in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, regions):
        ctx.num_heads = num_heads
        ctx.regions = regions
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, num_heads, regions)

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        grads = swin_window_attention_bwd(q, k, v, do.contiguous(), num_heads=ctx.num_heads,
                                          regions=ctx.regions)
        return (*grads, None, None)


def swin_window_attention(q, k, v, *, num_heads: int,
                          regions: Optional[torch.Tensor] = None):
    """Attention inside each window: q/k/v [B*nW, S, C] -> [B*nW, S, C] in
    q's dtype; ``regions`` [nW, S] uint8 for a shifted layer, None for an
    unshifted one.  On the card: S = 64 and C / num_heads = 128.
    Differentiable in q, k and v (K6^T)."""
    _check_args(q, k, v, num_heads, regions)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _SwinWindowAttention.apply(q, k, v, num_heads, regions)
    return _forward(q, k, v, num_heads, regions)
