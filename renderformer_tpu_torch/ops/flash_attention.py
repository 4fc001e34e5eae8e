"""Flash attention: the RoPE forward (kernels K1/K2, with the logsumexp for
training), the K broadcast-rotate (kernel K3), the forward without RoPE
(kernel K10, masked and unmasked, with an optional logsumexp), the backward
(kernel K8 fused, or the two kernels of K9), their plain PyTorch versions,
and the autograd Functions that join them.

Layouts are the JAX package's: q ``[B, Sq, H, D]``, k/v ``[Bkv, Sk, H, D]``
with ``Bkv`` dividing ``B`` (view-major fan-out: batch ``b`` reads scene
``b // reps``; K10 takes k and v at the q batch), key mask ``[B, Sk]`` bool
(True = attend), head-shared RoPE tables ``[B, S, D]`` fp32.  The logsumexp
and delta = rowsum(dO * O) are fp32 ``[B, H, Sq]``.  The CUDA sources are
``csrc/flash_attention.cu`` (K1/K2 and K10: the entry points and the fp32
kernel, split TF32 on the tensor cores), ``csrc/flash_fwd_sm90.cu`` (their
bf16 kernel for Hopper), ``csrc/rot_kv.cu``, ``csrc/flash_bwd.cu`` (the
backward's entry points and fp32 kernels), ``csrc/flash_bwd_sm90.cu`` (K8
and K9's dK/dV in bf16) and ``csrc/flash_bwd_dq_sm90.cu`` (K9's dQ in
bf16); their notes say what bounds each kernel on the card.
"""

from __future__ import annotations

import contextlib
import math

import torch

from renderformer_tpu_torch import _build
from renderformer_tpu_torch.encodings.rope import apply_rope
from renderformer_tpu_torch.ops import LAUNCHES, check_cuda_tensor, check_no_grad, use_plain

NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
BWD_VARIANTS = ('fused', 'twokernel')
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
KERNEL_HEAD_DIMS = (128,)


def q_scale(d: int) -> float:
    """D^-0.5 * log2(e), folded into the q-side tables (rounds to fp32 once
    when it multiplies them)."""
    return 1.0 / math.sqrt(d) * LOG2E


def fan_out(x: torch.Tensor, b: int) -> torch.Tensor:
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

def _softmax_pv_plain(qs, k, v, mask):
    """The forward kernels' loop in torch ops, on q already scaled by
    D^-0.5*log2(e) and rounded to its dtype: fp32 logits against k at the q
    batch, a -1e30 bias on masked keys, an exp2 softmax, P rounded to v's
    dtype before P.V in fp32 (v fanned out to the q batch), the sum divided
    by l and cast to q's dtype.  Returns (out, lse) with the natural-log
    logsumexp m*ln2 + ln(l) [B, H, Sq] fp32."""
    logits = torch.einsum('bqhd,bkhd->bhqk', qs.float(), k.float())
    if mask is not None:
        bias = torch.where(mask, 0.0, NEG_INF).to(torch.float32)
        logits = logits + bias[:, None, None, :]
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp2(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    vb = fan_out(v, qs.shape[0])
    acc = torch.einsum('bhqk,bkhd->bqhd', p.to(v.dtype).float(), vb.float())
    lse = (m * LN2 + torch.log(l))[..., 0]
    return (acc / l.permute(0, 2, 1, 3)).to(qs.dtype), lse


def flash_fwd_rope_plain(q, k_rot, v, mask, cosq, sinq):
    """K1/K2's function in torch ops: q rotated in fp32 with tables
    pre-scaled by D^-0.5*log2(e) and rounded to q's dtype, then
    :func:`_softmax_pv_plain`.  Returns (out, lse)."""
    s = q_scale(q.shape[-1])
    qr = apply_rope(q, (cosq.float() * s)[:, :, None, :], (sinq.float() * s)[:, :, None, :])
    return _softmax_pv_plain(qr, k_rot, v, mask)


def flash_fwd_plain(q, k, v, mask):
    """K10's function in torch ops: q multiplied in fp32 by D^-0.5*log2(e)
    and rounded to its dtype, then :func:`_softmax_pv_plain`.  Returns
    (out, lse)."""
    qs = (q.float() * q_scale(q.shape[-1])).to(q.dtype)
    return _softmax_pv_plain(qs, k, v, mask)


def _dtype_code(t):
    return _build.DTYPE_CODES[str(t.dtype).split('.')[-1]]


def flash_fwd_rows(dtype, b: int, sq: int, h: int) -> int:
    """Rows of q that one block of the CUDA flash forward (K1/K2, K10) takes
    at this grid on the current card: the bf16 kernel's tile plan (128, or
    64 where two blocks an SM fill the card in fewer waves), fp32's 64."""
    return _build.library().rf_flash_fwd_rows(_build.DTYPE_CODES[str(dtype).split('.')[-1]],
                                              b, sq, h)


def flash_fwd_splits(dtype, b: int, sq: int, sk: int, h: int) -> int:
    """Blocks (one thread block cluster) that share the keys of a q tile of
    the CUDA flash forward at this grid on the current card: the fp32
    kernel's key split (1, 2, 4 or 8), merged through the cluster's shared
    memory; 1 in bf16."""
    return _build.library().rf_flash_fwd_splits(
        _build.DTYPE_CODES[str(dtype).split('.')[-1]], b, sq, sk, h)


def flash_bwd_splits(dtype, b: int, sq: int, sk: int, h: int) -> int:
    """Blocks (one thread block cluster) that share the q steps of a key tile
    of the CUDA flash backward's dK/dV kernel (K8, K9's dK/dV) at this grid
    on the current card: the fp32 kernel's 1 or 2, their partial dK and dV
    summed through the cluster's shared memory; 1 in bf16."""
    return _build.library().rf_flash_bwd_splits(
        _build.DTYPE_CODES[str(dtype).split('.')[-1]], b, sq, sk, h)


def flash_bwd_dq_rows(dtype, b: int, sq: int, h: int) -> int:
    """Rows of q that one block of K9's CUDA dQ kernel takes at this grid on
    the current card: the bf16 kernel's 128 or 64 (the forward's plan), the
    fp32 kernel's 64."""
    return _build.library().rf_flash_bwd_dq_rows(_build.DTYPE_CODES[str(dtype).split('.')[-1]],
                                                 b, sq, h)


def flash_bwd_dq_splits(dtype, b: int, sq: int, sk: int, h: int) -> int:
    """Blocks (one thread block cluster) that share the keys of a q tile of
    K9's CUDA dQ kernel at this grid on the current card: the fp32 kernel's
    1, 2 or 4, their partial dQ summed in cluster-rank order; 1 in bf16."""
    return _build.library().rf_flash_bwd_dq_splits(
        _build.DTYPE_CODES[str(dtype).split('.')[-1]], b, sq, sk, h)


def flash_bwd_keys(dtype) -> int:
    """Keys that one block of the CUDA flash backward's dK/dV kernel (K8,
    K9's dK/dV) owns: the bf16 kernel's 128, the fp32 kernel's 64."""
    return _build.library().rf_flash_bwd_keys(_build.DTYPE_CODES[str(dtype).split('.')[-1]])


def _check_kernel_dtype(what, t):
    if t.dtype not in KERNEL_DTYPES:
        raise ValueError(f'{what} kernel takes {KERNEL_DTYPES}, got {t.dtype}')
    if t.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f'{what} kernel takes head dims {KERNEL_HEAD_DIMS}, '
                         f'got {t.shape[-1]}')


def _mask_bytes(mask, b, sk):
    if mask is None:
        return None
    if mask.dtype != torch.bool:
        raise ValueError(f'mask must be bool, got {mask.dtype}')
    mask = mask.view(torch.uint8)
    check_cuda_tensor('mask', mask, torch.uint8, (b, sk))
    return mask


def launch_flash_fwd_rope(lib, q, k_rot, v, mask, cosq, sinq, lse=None):
    """Launch ``rf_flash_fwd_rope`` of the loaded kernel library ``lib`` on
    CUDA tensors already checked by ``flash_fwd_rope``, writing the
    logsumexp into ``lse`` [B, H, Sq] fp32 when given; counts nothing."""
    b, sq, h, d = q.shape
    bkv, sk = v.shape[0], v.shape[1]
    _check_kernel_dtype('flash', q)
    check_cuda_tensor('q', q, q.dtype, (b, sq, h, d))
    check_cuda_tensor('k', k_rot, q.dtype, (b, sk, h, d))
    check_cuda_tensor('v', v, q.dtype, (bkv, sk, h, d))
    check_cuda_tensor('cos', cosq, torch.float32, (b, sq, d))
    check_cuda_tensor('sin', sinq, torch.float32, (b, sq, d))
    if lse is not None:
        check_cuda_tensor('lse', lse, torch.float32, (b, h, sq))
    mask = _mask_bytes(mask, b, sk)
    out = torch.empty_like(q)
    rc = lib.rf_flash_fwd_rope(
        q.data_ptr(), k_rot.data_ptr(), v.data_ptr(),
        mask.data_ptr() if mask is not None else None,
        cosq.data_ptr(), sinq.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        _dtype_code(q), int(mask is not None),
        b, b // bkv, sq, sk, h, d, q_scale(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, 'rf_flash_fwd_rope')
    return out


def flash_fwd_rope(q, k_rot, v, mask, cosq, sinq, with_lse: bool = False):
    """Attention of q (rotated inside) against pre-rotated K.

    q [B, Sq, H, D]; k_rot [B, Sk, H, D]; v [Bkv, Sk, H, D]; mask [B, Sk]
    bool or None; cosq/sinq [B, Sq, D] fp32 (unscaled).  Returns
    [B, Sq, H, D] in q's dtype, and with ``with_lse`` also the logsumexp
    [B, H, Sq] fp32."""
    _check_shapes(q, k_rot, v, mask, cosq, sinq)
    check_no_grad(q, k_rot, v, why='flash_fwd_rope is a forward kernel alone; '
                  'differentiate through flash_attention_rope')
    if use_plain(q):
        out, lse = flash_fwd_rope_plain(q, k_rot, v, mask, cosq, sinq)
        return (out, lse) if with_lse else out
    b, sq, h, _ = q.shape
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else None
    out = launch_flash_fwd_rope(_build.library(), q, k_rot, v, mask, cosq, sinq, lse)
    LAUNCHES['flash_fwd_rope_mask' if mask is not None else 'flash_fwd_rope_nomask'] += 1
    return (out, lse) if with_lse else out


# ---------------------------------------------------------------------------
# K10: flash forward without RoPE
# ---------------------------------------------------------------------------

def flash_fwd(q, k, v, mask, with_lse: bool = False):
    """Attention of q against k and v at the q batch, without RoPE.

    q [B, Sq, H, D]; k, v [B, Sk, H, D]; mask [B, Sk] bool or None.  Returns
    [B, Sq, H, D] in q's dtype, and with ``with_lse`` also the logsumexp
    [B, H, Sq] fp32."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError('q, k and v must be [B, S, H, D]')
    b, sq, h, d = q.shape
    sk = k.shape[1]
    for name, t in (('k', k), ('v', v)):
        if tuple(t.shape) != (b, sk, h, d):
            raise ValueError(f'{name} must be {(b, sk, h, d)}, got {tuple(t.shape)}')
    if mask is not None and tuple(mask.shape) != (b, sk):
        raise ValueError(f'mask must be {(b, sk)}, got {tuple(mask.shape)}')
    _check_contiguous(q=q, k=k, v=v, mask=mask)
    check_no_grad(q, k, v, why='flash_fwd is a forward kernel alone; '
                  'differentiate through flash_attention')
    if use_plain(q):
        out, lse = flash_fwd_plain(q, k, v, mask)
        return (out, lse) if with_lse else out
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else None
    out = launch_flash_fwd(_build.library(), q, k, v, mask, lse)
    LAUNCHES['flash_fwd_mask' if mask is not None else 'flash_fwd_nomask'] += 1
    return (out, lse) if with_lse else out


def launch_flash_fwd(lib, q, k, v, mask, lse=None):
    """Launch ``rf_flash_fwd`` of the loaded kernel library ``lib`` on CUDA
    tensors already checked by ``flash_fwd``, writing the logsumexp into
    ``lse`` [B, H, Sq] fp32 when given; counts nothing."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    _check_kernel_dtype('flash', q)
    for name, t in (('q', q), ('k', k), ('v', v)):
        check_cuda_tensor(name, t, q.dtype, tuple(t.shape))
    if lse is not None:
        check_cuda_tensor('lse', lse, torch.float32, (b, h, sq))
    mask_u8 = _mask_bytes(mask, b, sk)
    out = torch.empty_like(q)
    rc = lib.rf_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        mask_u8.data_ptr() if mask_u8 is not None else None, out.data_ptr(),
        lse.data_ptr() if lse is not None else None, _dtype_code(q), int(mask is not None),
        b, sq, sk, h, d, q_scale(d), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, 'rf_flash_fwd')
    return out


# ---------------------------------------------------------------------------
# K3: K broadcast-rotate
# ---------------------------------------------------------------------------

def rot_kv_broadcast_plain(k, cos, sin):
    """out[b] = (k32*cos[b] + rotate_half(k32)*sin[b]).to(k.dtype) with
    k32 = k[b // reps] in fp32."""
    return apply_rope(fan_out(k, cos.shape[0]), cos[:, :, None, :], sin[:, :, None, :])


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
    check_no_grad(k, why='rot_kv_broadcast is a forward kernel alone; '
                  'differentiate through flash_attention_rope')
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
        _dtype_code(k), b, b // bkv, sk, h, d,
        torch.cuda.current_stream(k.device).cuda_stream)
    _build.check(rc, 'rf_rot_kv_broadcast')
    LAUNCHES['rot_kv_broadcast'] += 1
    return out


# ---------------------------------------------------------------------------
# K8 / K9: the backward
# ---------------------------------------------------------------------------

def _bwd_plain_terms(q_rot, k_rot, v, mask, lse, delta, do):
    """q scaled by D^-0.5*log2(e) and rounded to its dtype, P = exp2(s2 -
    lse*log2(e)) with -1e30 on masked keys, and dS = (dP - delta)*P rounded
    to the dtype; all fp32."""
    b, sq, h, d = q_rot.shape
    dt = q_rot.dtype
    qs = (q_rot.float() * q_scale(d)).to(dt).float()
    s2 = torch.einsum('bqhd,bkhd->bhqk', qs, k_rot.float())
    if mask is not None:
        s2 = s2 + torch.where(mask, 0.0, NEG_INF).to(torch.float32)[:, None, None, :]
    p = torch.exp2(s2 - (lse * LOG2E)[..., None])
    dp = torch.einsum('bqhd,bkhd->bhqk', do.float(), fan_out(v, b).float())
    ds = ((dp - delta[..., None]) * p).to(dt).float()
    return qs, p, ds


def _dq_sum(ds, k_rot):
    d = k_rot.shape[-1]
    return torch.einsum('bhqk,bkhd->bqhd', ds, k_rot.float()) * (1.0 / math.sqrt(d))


def _dq_plain(ds, k_rot):
    return _dq_sum(ds, k_rot).to(k_rot.dtype)


def _dkv_plain(qs, p, ds, do):
    dt = do.dtype
    dv = torch.einsum('bhqk,bqhd->bkhd', p.to(dt).float(), do.float())
    dk = torch.einsum('bhqk,bqhd->bkhd', ds, qs) * (1.0 / LOG2E)
    return dk.to(dt), dv.to(dt)


def flash_bwd_plain(q_rot, k_rot, v, mask, lse, delta, do):
    """The backward kernels' function in torch ops, on q and k already
    rotated: q scaled by D^-0.5*log2(e) and rounded to its dtype, P =
    exp2(s2 - lse*log2(e)) with -1e30 on masked keys, dS = (dP - delta)*P
    rounded to the dtype, P rounded before dV = P^T.dO, dK = dS^T.q_scaled /
    log2(e) and dQ = D^-0.5 * dS.K summed in fp32, each cast to the dtype.
    K8 and K9 compute this function and differ only in summation order.
    Without RoPE (K10's backward) q and k are taken as given.  Returns (dq [B, Sq, H, D], dk [B, Sk, H, D], dv [B, Sk, H, D]): dk and
    dv at the q batch, per view."""
    qs, p, ds = _bwd_plain_terms(q_rot, k_rot, v, mask, lse, delta, do)
    return (_dq_plain(ds, k_rot), *_dkv_plain(qs, p, ds, do))


def flash_bwd_dq_plain(q_rot, k_rot, v, mask, lse, delta, do):
    """dq of :func:`flash_bwd_plain` alone: the function of K9's dQ kernel,
    which recomputes P and dS."""
    return _dq_plain(_bwd_plain_terms(q_rot, k_rot, v, mask, lse, delta, do)[2], k_rot)


def flash_bwd_dkv_plain(q_rot, k_rot, v, mask, lse, delta, do):
    """(dk, dv) of :func:`flash_bwd_plain` alone: the function of K9's dK/dV
    kernel."""
    return _dkv_plain(*_bwd_plain_terms(q_rot, k_rot, v, mask, lse, delta, do), do)


def flash_bwd(q_rot, k_rot, v, mask, lse, delta, do, variant: str = 'fused', dq_acc=None):
    """dq, dk, dv of attention at the rotated q and k (``flash_bwd_plain``'s
    function): K8 (``'fused'``, dQ by atomics into an fp32 scratch) or K9
    (``'twokernel'``, a dQ kernel and a dK/dV kernel, deterministic).

    q_rot, do [B, Sq, H, D]; k_rot [B, Sk, H, D]; v [Bkv, Sk, H, D]; mask
    [B, Sk] bool or None; lse, delta [B, H, Sq] fp32.  With ``dq_acc``
    (fp32 [B, Sq, H, D], a sum of earlier dQ) dQ is added into it and the
    returned dq is None: K8's atomics add into it in place of a zeroed
    scratch, so dQ does not round to the dtype; K9's dQ kernel writes dQ in
    the dtype, then it is added.  The plain version does as the variant.
    A ring sums its K/V slices' dQ so (``parallel/ring_attention.py``)."""
    if variant not in BWD_VARIANTS:
        raise ValueError(f'flash backward {variant!r} is not one of {BWD_VARIANTS}')
    b, sq, h, d = q_rot.shape
    bkv, sk = v.shape[0], v.shape[1]
    if bkv == 0 or b % bkv:
        raise ValueError(f'v batch {bkv} must divide the q batch {b}')
    for name, t, shape in (('k', k_rot, (b, sk, h, d)), ('v', v, (bkv, sk, h, d)),
                           ('dout', do, (b, sq, h, d)), ('lse', lse, (b, h, sq)),
                           ('delta', delta, (b, h, sq))):
        if tuple(t.shape) != shape:
            raise ValueError(f'{name} must be {shape}, got {tuple(t.shape)}')
    if mask is not None and tuple(mask.shape) != (b, sk):
        raise ValueError(f'mask must be {(b, sk)}, got {tuple(mask.shape)}')
    if dq_acc is not None and (dq_acc.dtype != torch.float32
                               or tuple(dq_acc.shape) != (b, sq, h, d)):
        raise ValueError(f'dq_acc must be fp32 {(b, sq, h, d)}')
    _check_contiguous(q=q_rot, k=k_rot, v=v, dout=do, lse=lse, delta=delta, mask=mask,
                      dq_acc=dq_acc)
    if use_plain(q_rot):
        if dq_acc is None:
            return flash_bwd_plain(q_rot, k_rot, v, mask, lse, delta, do)
        qs, p, ds = _bwd_plain_terms(q_rot, k_rot, v, mask, lse, delta, do)
        dq = _dq_sum(ds, k_rot)
        dq_acc.add_(dq if variant == 'fused' else dq.to(q_rot.dtype))
        return (None, *_dkv_plain(qs, p, ds, do))
    dq, dk, dv = launch_flash_bwd(_build.library(), variant, q_rot, k_rot, v, mask, lse,
                                  delta, do, dq_acc=dq_acc)
    if variant == 'fused':
        LAUNCHES['flash_bwd_mask' if mask is not None else 'flash_bwd_nomask'] += 1
    else:
        LAUNCHES['flash_bwd_dq'] += 1
        LAUNCHES['flash_bwd_dkv'] += 1
        if dq_acc is not None:
            dq_acc.add_(dq)
            dq = None
    return dq, dk, dv


def launch_flash_bwd(lib, kernels, q_rot, k_rot, v, mask, lse, delta, do, dq_acc=None):
    """Launch the backward kernels of the loaded library ``lib`` on tensors
    already checked by ``flash_bwd``: ``'fused'`` (K8), ``'twokernel'``
    (both K9 kernels), or one K9 kernel, ``'dq'`` or ``'dkv'``; returns
    (dq, dk, dv) with None for what was not computed.  K8 given ``dq_acc``
    adds dQ into it and returns no dq.  Counts nothing."""
    if kernels not in BWD_VARIANTS + ('dq', 'dkv'):
        raise ValueError(f'no backward kernels {kernels!r}')
    b, sq, h, d = q_rot.shape
    bkv, sk = v.shape[0], v.shape[1]
    _check_kernel_dtype('flash backward', q_rot)
    for name, t, shape in (('q', q_rot, (b, sq, h, d)), ('k', k_rot, (b, sk, h, d)),
                           ('v', v, (bkv, sk, h, d)), ('dout', do, (b, sq, h, d))):
        check_cuda_tensor(name, t, q_rot.dtype, shape)
    check_cuda_tensor('lse', lse, torch.float32, (b, h, sq))
    check_cuda_tensor('delta', delta, torch.float32, (b, h, sq))
    mask_u8 = _mask_bytes(mask, b, sk)
    ptrs = (q_rot.data_ptr(), k_rot.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            mask_u8.data_ptr() if mask_u8 is not None else None)
    shape_args = (_dtype_code(q_rot), int(mask is not None), b, b // bkv, sq, sk, h, d,
                  q_scale(d), 1.0 / math.sqrt(d))
    stream = torch.cuda.current_stream(q_rot.device).cuda_stream
    dq = dk = dv = None
    if kernels in ('fused', 'twokernel', 'dkv'):
        dk = torch.empty((b, sk, h, d), dtype=q_rot.dtype, device=q_rot.device)
        dv = torch.empty_like(dk)
        acc = None
        if kernels == 'fused':
            acc = dq_acc
            if acc is None:
                acc = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q_rot.device)
            else:
                check_cuda_tensor('dq_acc', acc, torch.float32, (b, sq, h, d))
        rc = lib.rf_flash_bwd_kv(*ptrs, acc.data_ptr() if acc is not None else None,
                                 dk.data_ptr(), dv.data_ptr(), *shape_args, 1.0 / LOG2E,
                                 stream)
        _build.check(rc, 'rf_flash_bwd_kv')
        if acc is not None and dq_acc is None:
            dq = acc.to(q_rot.dtype)
    if kernels in ('twokernel', 'dq'):
        dq = torch.empty_like(q_rot)
        rc = lib.rf_flash_bwd_dq(*ptrs, dq.data_ptr(), *shape_args, stream)
        _build.check(rc, 'rf_flash_bwd_dq')
    return dq, dk, dv


_bwd_variant = 'fused'


@contextlib.contextmanager
def flash_backward(variant: str):
    """Run the attention backward of graphs recorded inside the block with
    K8 (``'fused'``, the default) or K9 (``'twokernel'``)."""
    global _bwd_variant
    if variant not in BWD_VARIANTS:
        raise ValueError(f'flash backward {variant!r} is not one of {BWD_VARIANTS}')
    prev = _bwd_variant
    _bwd_variant = variant
    try:
        yield
    finally:
        _bwd_variant = prev


def _reduce_kv_grad(dx, bkv):
    """Transpose of the view fan-out: sum the per-view cotangents per scene."""
    b = dx.shape[0]
    if b == bkv:
        return dx
    return dx.reshape(bkv, b // bkv, *dx.shape[1:]).sum(dim=1)


def backward_variant() -> str:
    """The attention backward that graphs recorded now will run
    (:func:`flash_backward`)."""
    return _bwd_variant


class _RotKV(torch.autograd.Function):
    """rot_kv_broadcast with the VJP of the rotation and the fan-out: the
    cotangent rotated back with -sin and summed over the views."""

    @staticmethod
    def forward(ctx, k, cos, sin):
        ctx.save_for_backward(cos, sin)
        ctx.bkv = k.shape[0]
        return rot_kv_broadcast(k, cos, sin)

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.saved_tensors
        dk = apply_rope(g.contiguous(), cos[:, :, None, :], -sin[:, :, None, :])
        return _reduce_kv_grad(dk, ctx.bkv), None, None


def rotate_kv(k, cos, sin):
    """K rotated by the per-view tables and fanned out to their batch by K3
    (:func:`rot_kv_broadcast`), differentiable in k: k [Bkv, Sk, H, D],
    cos/sin [B, Sk, D] fp32 -> [B, Sk, H, D]."""
    if torch.is_grad_enabled() and k.requires_grad:
        return _RotKV.apply(k, cos, sin)
    return rot_kv_broadcast(k, cos, sin)


class _FlashRope(torch.autograd.Function):
    """flash_attention_rope with the JAX package's custom VJP
    (``_flash_rope_vjp_fwd`` / ``_flash_rope_vjp_bwd``): the forward keeps
    the output and logsumexp; the backward recomputes q rotated by the
    unscaled tables and K rotated at the q batch (K3), runs K8 or K9, rotates
    dq and dk back with -sin and sums dk and dv over the views.  The tables
    and the mask get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, cosq, sinq, cosk, sink):
        out, lse = flash_fwd_rope(q, rot_kv_broadcast(k, cosk, sink), v, mask, cosq, sinq,
                                  with_lse=True)
        ctx.save_for_backward(q, k, v, mask, cosq, sinq, cosk, sink, out, lse)
        ctx.variant = _bwd_variant
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, cosq, sinq, cosk, sink, out, lse = ctx.saved_tensors
        g = g.contiguous()
        q_rot = apply_rope(q, cosq[:, :, None, :], sinq[:, :, None, :])
        k_rot = rot_kv_broadcast(k, cosk, sink)
        delta = (g.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()
        dq_rot, dk_rot, dv = flash_bwd(q_rot, k_rot, v, mask, lse, delta, g, ctx.variant)
        dq = apply_rope(dq_rot, cosq[:, :, None, :], -sinq[:, :, None, :])
        dk = _reduce_kv_grad(apply_rope(dk_rot, cosk[:, :, None, :], -sink[:, :, None, :]),
                             k.shape[0])
        return dq, dk, _reduce_kv_grad(dv, v.shape[0]), None, None, None, None, None


def flash_attention_rope(q, k, v, mask, cosq, sinq, cosk, sink):
    """RoPE attention: K rotated by K3 at the q batch, then K1 (masked) or
    K2 (``mask is None``) with the q rotation in its prologue.  Where
    autograd tracks q, k or v, the forward also writes the logsumexp and the
    backward runs K8 or K9 (:func:`flash_backward`).

    q [B, Sq, H, D]; k/v [Bkv, Sk, H, D] with Bkv dividing B; mask [B, Sk]
    bool (True = attend) or None; tables [B, S, D] fp32, per view on both
    sides."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashRope.apply(q, k, v, mask, cosq, sinq, cosk, sink)
    k_rot = rot_kv_broadcast(k, cosk, sink)
    return flash_fwd_rope(q, k_rot, v, mask, cosq, sinq)


class _Flash(torch.autograd.Function):
    """flash_attention with the JAX package's custom VJP (``_flash_vjp_fwd``
    / ``_flash_vjp_bwd``): the forward runs K10 with the logsumexp and keeps
    it with the output; the backward computes delta = rowsum(dO*O) and runs
    K8 or K9 (:func:`flash_backward`) on q and k as given.  The mask gets no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        out, lse = flash_fwd(q, k, v, mask, with_lse=True)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.variant = _bwd_variant
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, out, lse = ctx.saved_tensors
        g = g.contiguous()
        delta = (g.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()
        dq, dk, dv = flash_bwd(q, k, v, mask, lse, delta, g, ctx.variant)
        return dq, dk, dv, None


def flash_attention(q, k, v, mask):
    """Attention without RoPE through K10 (masked, or unmasked with ``mask
    is None``); where autograd tracks q, k or v, the forward also writes the
    logsumexp and the backward runs K8 or K9 (:func:`flash_backward`).

    q [B, Sq, H, D]; k/v [B, Sk, H, D] at the q batch; mask [B, Sk] bool
    (True = attend) or None."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, mask)
    return flash_fwd(q, k, v, mask)
