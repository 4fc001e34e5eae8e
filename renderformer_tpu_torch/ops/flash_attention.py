"""RoPE flash-attention forward (kernels K1/K2) and the K broadcast-rotate
(kernel K3), with their plain PyTorch versions.

Layouts are the JAX package's: q ``[B, Sq, H, D]``, k/v ``[Bkv, Sk, H, D]``
with ``Bkv`` dividing ``B`` (view-major fan-out: batch ``b`` reads scene
``b // reps``), key mask ``[B, Sk]`` bool (True = attend), head-shared
RoPE tables ``[B, S, D]`` fp32.  The CUDA sources are
``csrc/flash_attention.cu`` and ``csrc/rot_kv.cu``; their notes say what
bounds each kernel on the card.
"""

from __future__ import annotations

import math

import torch

from renderformer_tpu_torch import _build
from renderformer_tpu_torch.encodings.rope import apply_rope
from renderformer_tpu_torch.ops import (
    LAUNCHES, check_cuda_tensor, check_no_grad, use_plain)

NEG_INF = -1e30
LOG2E = 1.4426950408889634
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
KERNEL_HEAD_DIMS = (128,)


def q_scale(d: int) -> float:
    """D^-0.5 * log2(e), folded into the q-side tables (rounds to fp32 once
    when it multiplies them)."""
    return 1.0 / math.sqrt(d) * LOG2E


def _fan_out(x: torch.Tensor, b: int) -> torch.Tensor:
    """[Bkv, ...] -> [b, ...], view-major (batch i reads x[i // reps])."""
    reps = b // x.shape[0]
    if reps == 1:
        return x
    return x.unsqueeze(1).expand(x.shape[0], reps, *x.shape[1:]).reshape(b, *x.shape[1:])


def _check_shapes(q, k, v, mask, cosq, sinq):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError('q, k and v must be [B, S, H, D]')
    b, sq, h, d = q.shape
    bkv, sk = v.shape[0], v.shape[1]
    if bkv == 0 or b % bkv:
        raise ValueError(f'v batch {bkv} must divide the q batch {b}')
    if tuple(k.shape) != (b, sk, h, d):
        raise ValueError(f'rotated k must be {(b, sk, h, d)}, got {tuple(k.shape)}')
    if tuple(v.shape) != (bkv, sk, h, d):
        raise ValueError(f'v must be {(bkv, sk, h, d)}, got {tuple(v.shape)}')
    if mask is not None and tuple(mask.shape) != (b, sk):
        raise ValueError(f'mask must be {(b, sk)}, got {tuple(mask.shape)}')
    for name, t in (('cos', cosq), ('sin', sinq)):
        if tuple(t.shape) != (b, sq, d):
            raise ValueError(f'q-side {name} must be {(b, sq, d)}, got {tuple(t.shape)}')
    if d % 2:
        raise ValueError(f'head dim {d} must be even')
    _check_contiguous(q=q, k=k, v=v, mask=mask, cos=cosq, sin=sinq)


def _check_contiguous(**tensors):
    """The kernels take dense row-major tensors; the plain versions are held
    to the same layout so that CPU runs catch a strided caller."""
    for name, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f'{name}: expected a contiguous tensor')


# ---------------------------------------------------------------------------
# K1/K2: flash forward with the q rotation fused
# ---------------------------------------------------------------------------

def flash_fwd_rope_plain(q, k_rot, v, mask, cosq, sinq):
    """The kernels' function in torch ops: q rotated in fp32 with tables
    pre-scaled by D^-0.5*log2(e) and rounded to q's dtype, fp32 logits, a
    -1e30 bias on masked keys, an exp2 softmax, P rounded to v's dtype
    before P.V in fp32, the sum divided by l and cast back."""
    b, sq, h, d = q.shape
    s = q_scale(d)
    qr = apply_rope(q, (cosq.float() * s)[:, :, None, :], (sinq.float() * s)[:, :, None, :])
    logits = torch.einsum('bqhd,bkhd->bhqk', qr.float(), k_rot.float())
    if mask is not None:
        bias = torch.where(mask, 0.0, NEG_INF).to(torch.float32)
        logits = logits + bias[:, None, None, :]
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp2(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    vb = _fan_out(v, b)
    acc = torch.einsum('bhqk,bkhd->bqhd', p.to(v.dtype).float(), vb.float())
    return (acc / l.permute(0, 2, 1, 3)).to(q.dtype)


def launch_flash_fwd_rope(lib, q, k_rot, v, mask, cosq, sinq):
    """Launch ``rf_flash_fwd_rope`` of the loaded kernel library ``lib`` on
    CUDA tensors already checked by ``flash_fwd_rope``; counts nothing."""
    b, sq, h, d = q.shape
    bkv, sk = v.shape[0], v.shape[1]
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f'flash kernel takes {KERNEL_DTYPES}, got {q.dtype}')
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f'flash kernel takes head dims {KERNEL_HEAD_DIMS}, got {d}')
    check_cuda_tensor('q', q, q.dtype, (b, sq, h, d))
    check_cuda_tensor('k', k_rot, q.dtype, (b, sk, h, d))
    check_cuda_tensor('v', v, q.dtype, (bkv, sk, h, d))
    check_cuda_tensor('cos', cosq, torch.float32, (b, sq, d))
    check_cuda_tensor('sin', sinq, torch.float32, (b, sq, d))
    if mask is not None:
        if mask.dtype != torch.bool:
            raise ValueError(f'mask must be bool, got {mask.dtype}')
        mask = mask.view(torch.uint8)
        check_cuda_tensor('mask', mask, torch.uint8, (b, sk))
    out = torch.empty_like(q)
    rc = lib.rf_flash_fwd_rope(
        q.data_ptr(), k_rot.data_ptr(), v.data_ptr(),
        mask.data_ptr() if mask is not None else None,
        cosq.data_ptr(), sinq.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[str(q.dtype).split('.')[-1]], int(mask is not None),
        b, b // bkv, sq, sk, h, d, q_scale(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, 'rf_flash_fwd_rope')
    return out


def flash_fwd_rope(q, k_rot, v, mask, cosq, sinq):
    """Attention of q (rotated inside) against pre-rotated K.

    q [B, Sq, H, D]; k_rot [B, Sk, H, D]; v [Bkv, Sk, H, D]; mask [B, Sk]
    bool or None; cosq/sinq [B, Sq, D] fp32 (unscaled).  Returns
    [B, Sq, H, D] in q's dtype."""
    _check_shapes(q, k_rot, v, mask, cosq, sinq)
    check_no_grad(q, k_rot, v)
    if use_plain(q):
        return flash_fwd_rope_plain(q, k_rot, v, mask, cosq, sinq)
    out = launch_flash_fwd_rope(_build.library(), q, k_rot, v, mask, cosq, sinq)
    LAUNCHES['flash_fwd_rope_mask' if mask is not None else 'flash_fwd_rope_nomask'] += 1
    return out


# ---------------------------------------------------------------------------
# K3: K broadcast-rotate
# ---------------------------------------------------------------------------

def rot_kv_broadcast_plain(k, cos, sin):
    """out[b] = (k32*cos[b] + rotate_half(k32)*sin[b]).to(k.dtype) with
    k32 = k[b // reps] in fp32."""
    return apply_rope(_fan_out(k, cos.shape[0]), cos[:, :, None, :], sin[:, :, None, :])


def rot_kv_broadcast(k, cos, sin):
    """k [Bkv, Sk, H, D], cos/sin [B, Sk, D] fp32 -> [B, Sk, H, D]."""
    if k.dim() != 4:
        raise ValueError('k must be [Bkv, Sk, H, D]')
    bkv, sk, h, d = k.shape
    b = cos.shape[0]
    if bkv == 0 or b % bkv:
        raise ValueError(f'k batch {bkv} must divide the table batch {b}')
    for name, t in (('cos', cos), ('sin', sin)):
        if tuple(t.shape) != (b, sk, d):
            raise ValueError(f'k-side {name} must be {(b, sk, d)}, got {tuple(t.shape)}')
    if d % 2:
        raise ValueError(f'head dim {d} must be even')
    _check_contiguous(k=k, cos=cos, sin=sin)
    check_no_grad(k)
    if use_plain(k):
        return rot_kv_broadcast_plain(k, cos, sin)
    if k.dtype not in KERNEL_DTYPES:
        raise ValueError(f'rotate kernel takes {KERNEL_DTYPES}, got {k.dtype}')
    check_cuda_tensor('k', k, k.dtype, (bkv, sk, h, d))
    check_cuda_tensor('cos', cos, torch.float32, (b, sk, d))
    check_cuda_tensor('sin', sin, torch.float32, (b, sk, d))
    out = torch.empty((b, sk, h, d), dtype=k.dtype, device=k.device)
    lib = _build.library()
    rc = lib.rf_rot_kv_broadcast(
        k.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[str(k.dtype).split('.')[-1]], b, b // bkv, sk, h, d,
        torch.cuda.current_stream(k.device).cuda_stream)
    _build.check(rc, 'rf_rot_kv_broadcast')
    LAUNCHES['rot_kv_broadcast'] += 1
    return out


def flash_attention_rope(q, k, v, mask, cosq, sinq, cosk, sink):
    """RoPE attention: K rotated by K3 at the q batch, then K1 (masked) or
    K2 (``mask is None``) with the q rotation in its prologue.

    q [B, Sq, H, D]; k/v [Bkv, Sk, H, D] with Bkv dividing B; mask [B, Sk]
    bool (True = attend) or None; tables [B, S, D] fp32, per view on both
    sides."""
    k_rot = rot_kv_broadcast(k, cosk, sink)
    return flash_fwd_rope(q, k_rot, v, mask, cosq, sinq)
