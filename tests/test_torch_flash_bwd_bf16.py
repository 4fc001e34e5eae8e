"""The arithmetic of the bf16 flash backward (``csrc/flash_bwd_sm90.cu``: K8
in bf16, and K9's bf16 dK/dV kernel, the same code without dQ; and K9's
bf16 dQ kernel, ``csrc/flash_bwd_dq_sm90.cu``), emulated in torch on the
CPU, against the plain version and the JAX package's fused and two-kernel
backward (``_flash_bwd_fused``, ``_flash_bwd_twokernel``) run through their
Pallas kernels in interpret mode.

The kernel's products are wgmma with bf16 operands and fp32 accumulators.
The emulation follows it step by step:

  * q scaled by D^-0.5*log2(e) in fp32 and rounded to bf16;
  * S^T = K.q_s^T and dP^T = V.dO^T over the head dim, 16 a k step;
  * P = exp2(s2 + bias - lse*log2(e)) in fp32, dS = (dP - delta)*P rounded
    to bf16, and P rounded to bf16 before dV;
  * dV += P^T.dO and dK += dS^T.q_s over the q rows, 16 a k step, into one
    running accumulator over the whole q range (a block takes every q step
    of its key tile: the bf16 kernel does not split them over a cluster, as
    the fp32 kernel does, since its 102 blocks at the train step's stage-1
    site already fill one wave at one block an SM); dK times 1/log2(e) at
    the end;
  * dQ of each 128-key tile over its keys, 16 a k step, times D^-0.5, summed
    over the key tiles in fp32 in a shuffled order (the kernel's atomics run
    in no fixed order), then rounded to bf16; K9's dQ kernel instead takes
    S and dP with q's rows as the wgmma's rows (the same sums a k step) and
    adds dQ = dS.K over all the keys in order, 16 a k step, into one
    running accumulator (a block owns its q rows' whole key range), times
    D^-0.5, then rounded to bf16;
  * each k step adds the exact sum of its 16 products to its accumulator
    and rounds once, to nearest, or toward zero (``ROUNDINGS``: the tensor
    cores' adder is not specified; truncation is the pessimistic model).

Each gradient is held to the card's bar for the bf16 backward, 8 bf16 ulps
of max|ref| (``chip_smoke.py``: twice the bf16 attention tolerance), at the
kernel's tile edges: 2064 keys (the train step's stage-1 self-attention,
whose last tile holds 16 keys of 128), 129 and 1000 q rows (ragged 64-row q
steps), a masked tail of triangle tokens, a view fan-out of 4 and a batch
row whose keys are all masked.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from renderformer_tpu.ops.flash_attention import (
    _flash_bwd_fused, _flash_bwd_twokernel, _flash_fwd)
from renderformer_tpu_torch.ops.flash_attention import (
    LOG2E, NEG_INF, fan_out, flash_bwd_plain, flash_fwd, q_scale)
from test_torch_flash_bwd import _jax_lse
from test_torch_flash_fp32 import ROUNDINGS, _mma

D = 128
KEYS = 128  # keys a block of the kernel
KS = 16     # the depth of a wgmma k step


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One intra-op thread for this module's float64 emulation, as in
    ``test_torch_flash_bwd_fp32.py``: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bf16(x):
    return x.to(torch.bfloat16).float()


def _dot(a, b, eq, rounding):
    """sum over the last axis of a and b, KS a k step, each step rounded."""
    acc = torch.zeros(torch.einsum(eq, a[..., :1], b[..., :1]).shape)
    for kk in range(0, a.shape[-1], KS):
        sl = slice(kk, kk + KS)
        acc = _mma(acc, a[..., sl], b[..., sl], eq, rounding)
    return acc


def _sum_over_q(a, b, rounding):
    """sum over q of a [B, H, Sk, Sq] times b [B, H, Sq, D] as the kernel
    accumulates dV and dK: KS q rows a k step into one running accumulator."""
    pad = -a.shape[-1] % KS  # rows past Sq: P and dS are 0, q and dO zero-filled
    a, b = F.pad(a, (0, pad)), F.pad(b, (0, 0, 0, pad))
    return _dot(a, b.transpose(-1, -2), 'bhkq,bhdq->bhkd', rounding)


def _scores(q, k, v, mask, lse, delta, do, rounding):
    """The kernel's q_s, K, dO [B, H, S, D] and P^T, dS^T [B, H, Sk, Sq]."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qs = bf16(q.float() * np.float32(q_scale(d))).permute(0, 2, 1, 3)
    k4 = k.float().permute(0, 2, 1, 3)
    v4 = fan_out(v, b).float().permute(0, 2, 1, 3)
    do4 = do.float().permute(0, 2, 1, 3)
    bias = torch.zeros(b, sk) if mask is None else torch.where(mask, 0.0, NEG_INF).float()
    s = _dot(k4, qs, 'bhkd,bhqd->bhkq', rounding)
    dp = _dot(v4, do4, 'bhkd,bhqd->bhkq', rounding)
    p = torch.exp2((s + bias[:, None, :, None]) - (lse * np.float32(LOG2E))[:, :, None, :])
    return qs, k4, do4, p, bf16((dp - delta[:, :, None, :]) * p)


def _dq(ds, k4, rounding, seed, twokernel=False):
    """dQ [B, H, Sq, D]: one accumulator a tile of KEYS keys, summed over the
    tiles in a shuffled order (K8); with ``twokernel``, K9's dQ kernel: one
    accumulator over every key in order."""
    if twokernel:
        pad = -ds.shape[2] % KS  # keys past Sk: dS is 0, K zero-filled
        acc = _dot(F.pad(ds, (0, 0, 0, pad)).transpose(-1, -2),
                   F.pad(k4, (0, 0, 0, pad)).transpose(-1, -2), 'bhqk,bhdk->bhqd', rounding)
        return acc * np.float32(1 / np.sqrt(k4.shape[-1]))
    b, h, sk, sq = ds.shape
    nt = -(-sk // KEYS)
    pad = nt * KEYS - sk
    dst = F.pad(ds, (0, 0, 0, pad)).reshape(b, h, nt, KEYS, sq)
    kt = F.pad(k4, (0, 0, 0, pad)).reshape(b, h, nt, KEYS, k4.shape[-1])
    acc = _dot(dst.transpose(-1, -2), kt.transpose(-1, -2), 'bhtqk,bhtdk->bhtqd', rounding)
    acc = acc * np.float32(1 / np.sqrt(k4.shape[-1]))
    dq = torch.zeros(b, h, sq, k4.shape[-1])
    for t in np.random.default_rng(seed).permutation(nt):
        dq = dq + acc[:, :, t]
    return dq


def _bshd(*xs):
    return tuple(bf16(x).permute(0, 2, 1, 3).contiguous() for x in xs)


def emulate(q, k, v, mask, lse, delta, do, rounding='nearest', seed=0, twokernel=False):
    """The bf16 kernels' dq, dk, dv (bf16 values, as fp32) on q and k as the
    kernels take them (rotated, unscaled): q, do [B, Sq, H, D]; k [B, Sk, H,
    D]; v [Bkv, Sk, H, D]; mask [B, Sk] or None; lse, delta [B, H, Sq].  K8,
    or with ``twokernel`` K9 (dq from its dQ kernel)."""
    qs, k4, do4, p, ds = _scores(q, k, v, mask, lse, delta, do, rounding)
    dk = _sum_over_q(ds, qs, rounding) * np.float32(1 / LOG2E)
    dv = _sum_over_q(bf16(p), do4, rounding)
    return _bshd(_dq(ds, k4, rounding, seed, twokernel), dk, dv)


def _inputs(b, bkv, sq, sk, h, mask_kind, seed=0):
    """q, k [B, S, H, D], v [Bkv, Sk, H, D], dO, all bf16 values in fp32; the
    mask: None, a padded tail of triangle tokens ('tail'), random keys
    ('random', key 0 kept), or random keys with batch row 1 all masked
    ('zero_row')."""
    rng = np.random.default_rng(seed)

    def x(*shape):
        return bf16(torch.from_numpy(rng.normal(size=shape).astype(np.float32))).numpy()

    q, k, v, do = x(b, sq, h, D), x(b, sk, h, D), x(bkv, sk, h, D), x(b, sq, h, D)
    mask = None
    if mask_kind == 'tail':
        mask = np.ones((b, sk), bool)
        mask[:, 16 + 2048 * 3 // 4:] = False
    elif mask_kind in ('random', 'zero_row'):
        mask = rng.uniform(size=(b, sk)) > 0.3
        mask[:, 0] = True
        if mask_kind == 'zero_row':
            mask[1] = False
    return q, k, v, mask, do


def _torch_io(q, k, v, mask, do):
    """The backward's operands from the forward's plain version in bf16:
    (q, k, v, mask, lse, delta, do)."""
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do))
    tm = None if mask is None else torch.from_numpy(mask)
    out, lse = flash_fwd(tq, tk, fan_out(tv, q.shape[0]).contiguous(), tm, with_lse=True)
    delta = (tdo.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return tq, tk, tv, tm, lse, delta, tdo


def _check(got, want):
    """8 bf16 ulps of max|ref| per gradient; returns the worst share of the bar."""
    worst = 0.0
    for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
        assert g.shape == w.shape, name
        tol = 8 * 2.0 ** -8 * float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol, (name, err, tol)
        worst = max(worst, err / tol)
    return worst


# b, bkv, sq, sk, h, mask
EDGE_CASES = {
    'tail_2064x2064': (1, 1, 2064, 2064, 1, 'tail'),
    'tail_129x2064': (1, 1, 129, 2064, 1, 'tail'),
    'tail_1000x2064': (1, 1, 1000, 2064, 1, 'tail'),
    'reps4_tail_129x2064': (4, 1, 129, 2064, 1, 'tail'),
    'zero_row_129x200_h2': (3, 3, 129, 200, 2, 'zero_row'),
    'unmasked_1000x1000': (1, 1, 1000, 1000, 1, None),
}


@functools.lru_cache(maxsize=None)
def _edge(case):
    return _torch_io(*_inputs(*EDGE_CASES[case], seed=len(case)))


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('rounding', ROUNDINGS)
@pytest.mark.parametrize('case', sorted(EDGE_CASES))
def test_bf16_bwd_emulation_at_tile_edges_matches_plain(case, rounding, seed):
    """Two shuffled orders of dQ's key tiles a case."""
    io = _edge(case)
    _check(emulate(*io, rounding, seed=seed), flash_bwd_plain(*io))


@pytest.mark.parametrize('rounding', ROUNDINGS)
@pytest.mark.parametrize('case', sorted(EDGE_CASES))
def test_bf16_twokernel_emulation_at_tile_edges_matches_plain(case, rounding):
    """K9's dQ kernel: dQ over all 2064 keys in one accumulator."""
    io = _edge(case)
    _check(emulate(*io, rounding, twokernel=True), flash_bwd_plain(*io))


# b, sq, sk, h, mask: against the JAX kernels (v at the q batch)
JAX_CASES = {
    'tail_129x2064': (1, 129, 2064, 1, 'tail'),
    'random_100x70_h2': (2, 100, 70, 2, 'random'),
    'zero_row_129x200': (3, 129, 200, 1, 'zero_row'),
    'unmasked_130x129': (1, 130, 129, 1, None),
}


@pytest.mark.parametrize('variant', ['fused', 'twokernel'])
@pytest.mark.parametrize('case', sorted(JAX_CASES))
def test_bf16_bwd_emulation_matches_jax_kernels(case, variant):
    """K8's or K9's emulation against ``_flash_bwd_fused`` or
    ``_flash_bwd_twokernel`` (their Pallas kernels in interpret mode, 64-row
    and 64-key blocks, bf16) on the output and logsumexp of ``_flash_fwd``
    in interpret mode, with the pessimistic rounding."""
    b, sq, sk, h, mask_kind = JAX_CASES[case]
    q, k, v, mask, do = _inputs(b, b, sq, sk, h, mask_kind, seed=7)
    jmask = None if mask is None else jnp.asarray(mask)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    out, lse = _flash_fwd(jq, jk, jv, jmask, bq=64, bk=64, interpret=True, with_lse=True)
    kern = _flash_bwd_fused if variant == 'fused' else _flash_bwd_twokernel
    want = [torch.from_numpy(np.array(w.astype(jnp.float32)))
            for w in kern(jq, jk, jv, jmask, out, lse, jdo, 64, 64, True)]
    tdo = torch.from_numpy(do)
    delta = (tdo * torch.from_numpy(np.array(out.astype(jnp.float32)))).sum(-1)
    got = emulate(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                  None if mask is None else torch.from_numpy(mask),
                  torch.from_numpy(_jax_lse(lse, b, sq, h)), delta.transpose(1, 2).contiguous(),
                  tdo, 'toward_zero', twokernel=variant == 'twokernel')
    _check(got, want)
