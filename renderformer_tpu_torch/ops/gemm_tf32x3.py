"""The float32 product of a linear in split TF32 (``csrc/gemm_tf32x3.cu``):
its plain PyTorch version, the kernel's wrappers for the forward, dX and dW,
the autograd Function that joins them, and the gate of the route
(``nn/core.py:linear``).

Each operand x splits into hi + lo: hi is x rounded to TF32 (10 mantissa
bits) to nearest, ties away from zero, lo is x - hi truncated to TF32, so
that |x - hi - lo| < 2^-21 |x| for a normal x; inf and NaN stay in hi with
a zero lo.  A product a*b is taken as a_lo*b_hi + a_hi*b_lo + a_hi*b_hi,
each a product of two TF32 values, exact in fp32, summed in fp32.  The
kernel runs the three products on the tensor cores; the plain version runs
them as three fp32 matrix products.
"""

from __future__ import annotations

import ctypes

import torch

from renderformer_tpu_torch import _build
from renderformer_tpu_torch.ops import LAUNCHES, use_plain

BM = BN = 128  # the kernel's output tile
BK = 32        # the reduction a stage of the kernel's ring holds
MIN_SPLIT_BLOCKS = 8  # stages of the reduction a slice of a split tile keeps at least
ALIGN = 4      # K and N in elements: TMA reads rows of a multiple of 16 bytes
_MASK = -0x2000  # 0xFFFFE000 as int32: the 13 mantissa bits TF32 drops
_EXP = 0x7F800000


def tf32_split(x: torch.Tensor):
    """(hi, lo) of an fp32 tensor, as the kernel splits it, by bit operations."""
    if x.dtype != torch.float32:
        raise ValueError(f'tf32_split takes float32, got {x.dtype}')
    u = x.view(torch.int32)
    special = (u & _EXP) == _EXP
    hi = torch.where(special, u, (u + 0x1000) & _MASK).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & _MASK).view(torch.float32)
    lo = torch.where((hi.view(torch.int32) & _EXP) == _EXP, torch.zeros_like(lo), lo)
    return hi, lo


def gemm_tf32x3_plain(a, b, bias=None):
    """a [M, K] b [N, K]^T (+ bias [N]) in split TF32, as three fp32 products
    (run with TF32 off: on the card the caller's flag, which the route
    checks)."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    y = al @ bh.t() + ah @ bl.t() + ah @ bh.t()
    return y if bias is None else y + bias


def tf32x3_linear_supported(x, weight, bias=None) -> bool:
    """Whether ``linear(x, weight, bias)`` takes the split-TF32 kernel: CUDA
    float32 operands, torch's float32 matmul precision at its highest
    (``torch.backends.cuda.matmul.allow_tf32`` False: with TF32 allowed the
    caller asked for 10-bit products, which cuBLAS runs faster), and K and N
    multiples of 4, as the kernel's TMA rows need."""
    return (x.is_cuda and x.dtype == torch.float32 and weight.dtype == torch.float32
            and weight.dim() == 2 and x.dim() >= 1 and x.numel() > 0
            and (bias is None or bias.dtype == torch.float32)
            and not torch.backends.cuda.matmul.allow_tf32
            and weight.shape[1] % ALIGN == 0 and weight.shape[0] % ALIGN == 0)


def plan(m: int, n: int, k: int, sms: int):
    """(slices of the reduction, blocks) of the kernel for C [m, n] over k
    on a card of ``sms`` SMs: the tiles alone where they fill the card,
    else each tile cut into as many slices as fill it, each keeping at least
    MIN_SPLIT_BLOCKS stages; one block an SM walks the work units."""
    tiles = -(-m // BM) * -(-n // BN)
    blocks = -(-k // BK)
    splits = max(1, min(blocks // MIN_SPLIT_BLOCKS, sms // tiles))
    return splits, min(tiles * splits, sms)


_ptr = ctypes.c_void_p


def _check(name, t, dev):
    if t.device.type != 'cuda' or t.get_device() != dev:
        raise ValueError(f'{name}: expected a tensor on cuda:{dev}, got {t.device}')
    if t.dtype != torch.float32:
        raise ValueError(f'{name}: expected float32, got {t.dtype}')
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f'{name}: expected a contiguous, 16-byte aligned tensor')


def _split(x, transpose: bool, stream: int):
    """(hi, lo) of x [r, c], or of x^T [c, r] with rows padded to a multiple
    of 4 elements (the pad is never read)."""
    r, c = x.shape
    ld = -(-r // ALIGN) * ALIGN if transpose else c
    out = torch.empty((2, c if transpose else r, ld), dtype=torch.float32, device=x.device)
    hi, lo = out[0], out[1]
    rc = _build.function('rf_tf32x3_split')(
        _ptr(x.data_ptr()), _ptr(hi.data_ptr()), _ptr(lo.data_ptr()), r, c, c, ld,
        int(transpose), _ptr(stream))
    if rc:
        _build.check(rc, 'rf_tf32x3_split')
    return hi, lo, ld


def _gemm(a, a_mn: bool, b, b_transpose: bool, bias, m: int, n: int, k: int):
    """C [m, n] = A B^T (+ bias) on the card: A is ``a`` [m, k], or, with
    ``a_mn``, ``a`` [k, m] read as its transpose; B is ``b`` [n, k], or,
    with ``b_transpose``, ``b`` [k, n] read as its transpose."""
    dev = a.get_device()
    for name, t in (('a', a), ('b', b)) + ((('bias', bias),) if bias is not None else ()):
        _check(name, t, dev)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    bhi, blo, ldb = _split(b, b_transpose, stream)
    splits, grid = plan(m, n, k, torch.cuda.get_device_properties(dev).multi_processor_count)
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    part = c if splits == 1 else torch.empty((splits, m, n), dtype=torch.float32,
                                             device=a.device)
    # the bias goes in once: with the product, or with the slices' sum
    bias_ptr = _ptr(bias.data_ptr() if bias is not None else 0)
    rc = _build.function('rf_gemm_tf32x3')(
        _ptr(a.data_ptr()), _ptr(bhi.data_ptr()), _ptr(blo.data_ptr()),
        bias_ptr if splits == 1 else _ptr(0), _ptr(part.data_ptr()), int(a_mn),
        m, n, k, a.shape[1], ldb, splits, grid, _ptr(stream))
    if rc:
        _build.check(rc, 'rf_gemm_tf32x3')
    if splits > 1:
        rc = _build.function('rf_gemm_tf32x3_reduce')(
            _ptr(part.data_ptr()), bias_ptr, _ptr(c.data_ptr()), m, n, splits, _ptr(stream))
        if rc:
            _build.check(rc, 'rf_gemm_tf32x3_reduce')
    return c


def _agree(name, *shapes):
    """Raise unless the operands' shapes (2-D, and what they share) agree."""
    x, w = shapes[:2]
    ok = len(x) == 2 and len(w) == 2 and {
        'gemm_tf32x3_fwd': x[1] == w[1] and (len(shapes) < 3 or shapes[2] == w[:1]),
        'gemm_tf32x3_dgrad': x[1] == w[0],
        'gemm_tf32x3_wgrad': x[0] == w[0]}[name]
    if not ok:
        raise ValueError(f'{name}: operand shapes {[tuple(s) for s in shapes]} do not agree')


def gemm_tf32x3_fwd(x, weight, bias=None):
    """y [M, N] = x [M, K] weight [N, K]^T (+ bias [N])."""
    _agree('gemm_tf32x3_fwd', x.shape, weight.shape, *(() if bias is None else (bias.shape,)))
    if use_plain(x):
        return gemm_tf32x3_plain(x, weight, bias)
    m, k = x.shape
    y = _gemm(x, False, weight, False, bias, m, weight.shape[0], k)
    LAUNCHES['gemm_tf32x3_fwd'] += 1
    return y


def gemm_tf32x3_dgrad(gy, weight):
    """dx [M, K] = gy [M, N] weight [N, K]."""
    _agree('gemm_tf32x3_dgrad', gy.shape, weight.shape)
    if use_plain(gy):
        return gemm_tf32x3_plain(gy, weight.t())
    m, n = gy.shape
    dx = _gemm(gy, False, weight, True, None, m, weight.shape[1], n)
    LAUNCHES['gemm_tf32x3_dgrad'] += 1
    return dx


def gemm_tf32x3_wgrad(gy, x):
    """dweight [N, K] = gy [M, N]^T x [M, K]."""
    _agree('gemm_tf32x3_wgrad', gy.shape, x.shape)
    if use_plain(gy):
        return gemm_tf32x3_plain(gy.t(), x.t())
    m, n = gy.shape
    dw = _gemm(gy, True, x, True, None, n, x.shape[1], m)
    LAUNCHES['gemm_tf32x3_wgrad'] += 1
    return dw


class _Tf32x3Linear(torch.autograd.Function):
    """A linear whose forward, dX and dW are the split-TF32 kernel; the
    bias's gradient is the sum of gy over its rows."""

    @staticmethod
    def forward(ctx, x2, weight, bias):
        ctx.save_for_backward(x2, weight)
        ctx.has_bias = bias is not None
        return gemm_tf32x3_fwd(x2, weight, bias)

    @staticmethod
    def backward(ctx, gy):
        x2, weight = ctx.saved_tensors
        gy = gy.contiguous()
        dx = gemm_tf32x3_dgrad(gy, weight) if ctx.needs_input_grad[0] else None
        dw = gemm_tf32x3_wgrad(gy, x2) if ctx.needs_input_grad[1] else None
        db = gy.sum(0) if ctx.has_bias and ctx.needs_input_grad[2] else None
        return dx, dw, db


def _operand(t):
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def tf32x3_linear(x, weight, bias=None):
    """``F.linear(x, weight, bias)`` in split TF32 over x's last axis; where
    autograd tracks an operand, the backward's products are the kernel's
    too.  An operand that is not contiguous or not 16-byte aligned is
    copied once."""
    x2 = _operand(x.reshape(-1, x.shape[-1]))
    y = _Tf32x3Linear.apply(x2, _operand(weight), None if bias is None else _operand(bias))
    return y.reshape(*x.shape[:-1], weight.shape[0])
