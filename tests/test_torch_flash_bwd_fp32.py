"""The arithmetic of the fp32 flash backward's kernels (``csrc/flash_bwd.cu``:
K8 in fp32, K9's dK/dV kernel, the same code without dQ, and K9's dQ
kernel), emulated in torch on the CPU, against the plain version (exact
fp32) and the JAX package's fused and two-kernel backward
(``_flash_bwd_fused``, ``_flash_bwd_twokernel``) run through their Pallas
kernels in interpret mode.

The kernel takes all five products on the tensor cores as split TF32: an
operand x is hi + lo with hi = x truncated to TF32 (its low 13 bits
cleared) and lo = x - hi, which the tensor cores read truncated to TF32;
a*b = a_lo*b_hi + a_hi*b_lo + a_hi*b_hi.  (The fp32 forward rounds hi to
nearest, ``tests/test_torch_flash_fp32.py``: two instructions more a value,
half the error.)  The emulation follows the kernel step by step:

  * S^T = K.q_s^T and dP^T = V.dO^T over the head dim, 8 a k step: the
    hi*hi products in one fp32 accumulator, the two small products of each
    step (lo*hi first) in another, added before the key bias;
  * P = exp2(s2 + bias - lse*log2(e)) and dS = (dP - delta)*P in fp32;
  * dV += P^T.dO and dK += dS^T.q_s over the q rows in loop steps of 16:
    each step's products (8 q rows an mma k step, the small ones first) in
    a fresh accumulator that one fp32 add puts on the running sum; the steps
    of a key tile split into contiguous parts over the blocks of a cluster
    (the launch takes 1 or 2; 4 is held too), whose sums add in order; dK
    times 1/log2(e) at the end;
  * dQ of each 64-key tile in one accumulator (8 keys an mma k step, the
    small ones first), times D^-0.5, summed over the key tiles in fp32 in a
    shuffled order (the kernel's atomics run in no fixed order);
  * each mma adds the exact sum of its 8 products to its accumulator and
    rounds once, to nearest, or toward zero (``ROUNDINGS``: the tensor
    cores' adder is not specified; truncation is the pessimistic model).

K9's dQ kernel takes its three products the same way, q-major:

  * S = q_s.K^T and dP = dO.V^T over the head dim, 8 a k step, q's (or
    dO's) operand first: the small products q_lo*K_hi, then q_hi*K_lo, in
    an accumulator of their own, added before the key bias;
  * dQ = dS.K over the keys in loop steps of 16: each step's products (8
    keys an mma k step, the small ones first) in a fresh accumulator that
    one fp32 add puts on the running sum; the steps of a q tile split into
    contiguous parts over the blocks of a cluster (1, 2 or 4), whose partial
    sums add in rank order (the same order on every run); times D^-0.5 at
    the end.

Each gradient is held to the card's bar for the fp32 backward, 2^-15 of
max|ref| (``chip_smoke.py``: twice the fp32 attention tolerance), at the
train step's shapes (1024 rays against 2064 triangle tokens with a padded
tail masked, and 1024 unmasked, D 128), at ragged tiles (query and key
counts from {1, 33, 63, 65, 129}) and with a view fan-out.
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
from test_torch_flash_fp32 import ROUNDINGS, _mma, tf32_truncated

D = 128
BK = 64   # keys a block of the kernel owns
BQ = 16   # q rows a loop step of the fp32 kernel
BK_DQ = 16  # keys a loop step of K9's fp32 dQ kernel


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One intra-op thread for this module's float64 emulation: the suite
    runs in parallel workers, and these products, each small, lose far more
    to threads that wait on one another across busy cores than they gain
    (one case of the forward's emulation took 20x its one-thread time that
    way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def split(x):
    """(hi, lo) as the tensor cores take them: hi = x truncated to TF32, lo =
    x - hi read truncated to TF32."""
    hi = tf32_truncated(x)
    return hi, tf32_truncated(x - hi)


def _dot_split(a, b, eq, rounding):
    """sum over the head dim of a and b, split TF32 with the large and the
    small products in accumulators of their own (S^T and dP^T)."""
    ah, al = split(a)
    bh, bl = split(b)
    shape = torch.einsum(eq, a[..., :1], b[..., :1]).shape
    big, small = torch.zeros(shape), torch.zeros(shape)
    for kk in range(0, a.shape[-1], 8):
        sl = slice(kk, kk + 8)
        small = _mma(small, al[..., sl], bh[..., sl], eq, rounding)
        small = _mma(small, ah[..., sl], bl[..., sl], eq, rounding)
        big = _mma(big, ah[..., sl], bh[..., sl], eq, rounding)
    return big + small


def _sum_over_q(a, b, rounding, splits):
    """sum over q of a [B, H, Sk, Sq] times b [B, H, Sq, D] as the kernel
    accumulates dV and dK: per loop step of BQ rows a fresh accumulator,
    added to the running sum in fp32; the loop steps cut into ``splits``
    contiguous parts (the blocks of a cluster), whose sums add in order."""
    sq = a.shape[-1]
    pad = -sq % BQ  # rows past Sq: P and dS are 0 there, q and dO zero-filled
    a, b = F.pad(a, (0, pad)), F.pad(b, (0, 0, 0, pad))
    ah, al = split(a)
    bh, bl = split(b)
    eq = 'bhkq,bhqd->bhkd'
    nsteps = (sq + pad) // BQ
    total = torch.zeros(*a.shape[:-1], b.shape[-1])
    for part in range(splits):
        acc = torch.zeros_like(total)
        for step in range(nsteps * part // splits, nsteps * (part + 1) // splits):
            t = torch.zeros_like(acc)
            for j in range(step * BQ, step * BQ + BQ, 8):
                sl = slice(j, j + 8)
                t = _mma(t, al[..., sl], bh[..., sl, :], eq, rounding)
                t = _mma(t, ah[..., sl], bl[..., sl, :], eq, rounding)
                t = _mma(t, ah[..., sl], bh[..., sl, :], eq, rounding)
            acc = acc + t
        total = total + acc
    return total


def _scores(q, k, v, mask, lse, delta, do, rounding, q_major=False):
    """The kernel's P^T and dS^T [B, H, Sk, Sq], with q scaled and the
    operands in [B, H, S, D]: (qs, k4, do4, p, ds).  ``q_major``: S and dP
    as K9's dQ kernel takes them, q's and dO's operand first in each mma."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qs = (q * np.float32(q_scale(d))).permute(0, 2, 1, 3)
    k4 = k.permute(0, 2, 1, 3)
    v4 = fan_out(v, b).permute(0, 2, 1, 3)
    do4 = do.permute(0, 2, 1, 3)
    bias = torch.zeros(b, sk) if mask is None else torch.where(mask, 0.0, NEG_INF).float()
    if q_major:
        s = _dot_split(qs, k4, 'bhqd,bhkd->bhqk', rounding).transpose(-1, -2)
        dp = _dot_split(do4, v4, 'bhqd,bhkd->bhqk', rounding).transpose(-1, -2)
    else:
        s = _dot_split(k4, qs, 'bhkd,bhqd->bhkq', rounding)
        dp = _dot_split(v4, do4, 'bhkd,bhqd->bhkq', rounding)
    p = torch.exp2((s + bias[:, None, :, None]) - (lse * np.float32(LOG2E))[:, :, None, :])
    return qs, k4, do4, p, (dp - delta[:, :, None, :]) * p


def _dq(ds, k4, rounding, seed=0, splits=None):
    """dQ [B, H, Sq, D].  K8 (``splits`` None): one accumulator a 64-key
    tile, times D^-0.5, summed over the tiles in a shuffled order.  K9's dQ
    kernel: one fresh accumulator a 16-key step, added to the running sum in
    fp32; the steps cut into ``splits`` contiguous parts, whose partial sums
    add in rank order; times D^-0.5."""
    b, h, sk, sq = ds.shape
    d = k4.shape[-1]
    bk = BK if splits is None else BK_DQ
    nt = -(-sk // bk)
    pad = nt * bk - sk
    dst = F.pad(ds, (0, 0, 0, pad)).reshape(b, h, nt, bk, sq)
    kt = F.pad(k4, (0, 0, 0, pad)).reshape(b, h, nt, bk, d)
    dh, dl = split(dst)
    kh, kl = split(kt)
    acc = torch.zeros(b, h, nt, sq, d)
    eq = 'bhtkq,bhtkd->bhtqd'
    for kk in range(0, bk, 8):
        sl = slice(kk, kk + 8)
        acc = _mma(acc, dl[..., sl, :], kh[..., sl, :], eq, rounding)
        acc = _mma(acc, dh[..., sl, :], kl[..., sl, :], eq, rounding)
        acc = _mma(acc, dh[..., sl, :], kh[..., sl, :], eq, rounding)
    dq = torch.zeros(b, h, sq, d)
    if splits is None:
        acc = acc * np.float32(1 / np.sqrt(d))
        for t in np.random.default_rng(seed).permutation(nt):
            dq = dq + acc[:, :, t]
        return dq
    for part in range(splits):
        run = torch.zeros_like(dq)
        for t in range(nt * part // splits, nt * (part + 1) // splits):
            run = run + acc[:, :, t]
        dq = dq + run
    return dq * np.float32(1 / np.sqrt(d))


def _dkv(qs, do4, p, ds, rounding, splits):
    """dK and dV [B, H, Sk, D], the q steps split over ``splits`` blocks."""
    return (_sum_over_q(ds, qs, rounding, splits) * np.float32(1 / LOG2E),
            _sum_over_q(p, do4, rounding, splits))


def _bshd(*xs):
    return tuple(x.permute(0, 2, 1, 3).contiguous() for x in xs)


def emulate(q, k, v, mask, lse, delta, do, rounding='nearest', splits=1, seed=0,
            dq_splits=None):
    """The fp32 kernels' dq, dk, dv on q and k as the kernels take them
    (rotated, unscaled): q, do [B, Sq, H, D]; k [B, Sk, H, D]; v [Bkv, Sk,
    H, D]; mask [B, Sk] or None; lse, delta [B, H, Sq]; the q steps of a key
    tile split over ``splits`` blocks.  K8 by default; with ``dq_splits``
    the two-kernel form (K9), dq from its dQ kernel with a q tile's keys
    split over ``dq_splits`` blocks."""
    qs, k4, do4, p, ds = _scores(q, k, v, mask, lse, delta, do, rounding)
    if dq_splits is None:
        dq = _dq(ds, k4, rounding, seed)
    else:
        dq = _dq(_scores(q, k, v, mask, lse, delta, do, rounding, True)[4], k4, rounding,
                 splits=dq_splits)
    return _bshd(dq, *_dkv(qs, do4, p, ds, rounding, splits))


def _inputs(b, bkv, sq, sk, h, mask_kind, seed=0):
    """q, k [B, S, H, D], v [Bkv, Sk, H, D], dO; the mask: None, a padded
    tail of triangle tokens ('tail'), or random keys ('random', key 0 kept)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, D)).astype(np.float32)
    k = rng.normal(size=(b, sk, h, D)).astype(np.float32)
    v = rng.normal(size=(bkv, sk, h, D)).astype(np.float32)
    do = rng.normal(size=(b, sq, h, D)).astype(np.float32)
    mask = None
    if mask_kind == 'tail':
        mask = np.ones((b, sk), bool)
        mask[:, 16 + 2048 * 3 // 4:] = False
    elif mask_kind == 'random':
        mask = rng.uniform(size=(b, sk)) > 0.3
        mask[:, 0] = True
    return q, k, v, mask, do


def _torch_io(q, k, v, mask, do):
    """The backward's operands from the forward's plain version: (q, k, v,
    mask, lse, delta, do) as torch tensors."""
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tm = None if mask is None else torch.from_numpy(mask)
    out, lse = flash_fwd(tq, tk, fan_out(tv, q.shape[0]).contiguous(), tm, with_lse=True)
    delta = (tdo * out).sum(-1).transpose(1, 2).contiguous()
    return tq, tk, tv, tm, lse, delta, tdo


def _check(got, want):
    """2^-15 of max|ref| per gradient; returns the worst share of the bar."""
    worst = 0.0
    for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
        assert g.shape == w.shape, name
        tol = 2.0 ** -15 * float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= tol, (name, err, tol)
        worst = max(worst, err / tol)
    return worst


# the train step's fp32 sites at 1 head: cross-attention (1024 rays against
# 2064 triangle tokens, a padded tail masked) and ray self-attention
TRAIN_SITES = {'train_cross': (1024, 2064, 'tail'), 'train_ray_self': (1024, 1024, None)}


@functools.lru_cache(maxsize=None)
def _train_site(site, rounding):
    """A train site's plain gradients, and the emulation's dQ and scores,
    which the q split does not change: (want, dq, scores)."""
    sq, sk, mask_kind = TRAIN_SITES[site]
    io = _torch_io(*_inputs(1, 1, sq, sk, 1, mask_kind, seed=sq + sk))
    scores = _scores(*io, rounding)
    return flash_bwd_plain(*io), _dq(scores[4], scores[1], rounding, 0), scores


@pytest.mark.parametrize('splits', [1, 2, 4])
@pytest.mark.parametrize('rounding', ROUNDINGS)
@pytest.mark.parametrize('site', sorted(TRAIN_SITES))
def test_split_tf32_bwd_at_the_train_shapes_within_the_fp32_bar(site, rounding, splits):
    want, dq, (qs, _, do4, p, ds) = _train_site(site, rounding)
    _check(_bshd(dq, *_dkv(qs, do4, p, ds, rounding, splits)), want)


EDGES = (1, 33, 63, 65, 129)


@pytest.mark.parametrize('sk', EDGES)
@pytest.mark.parametrize('sq', EDGES)
def test_split_tf32_bwd_at_tile_edges(sq, sk):
    """Ragged q steps (16 rows) and key tiles (64 keys), random keys masked,
    with the pessimistic rounding; the q steps split over 2 blocks where
    there are 2."""
    io = _torch_io(*_inputs(1, 1, sq, sk, 1, 'random', seed=sq * 1000 + sk))
    splits = min(2, -(-sq // BQ))
    got, want = emulate(*io, 'toward_zero', splits, seed=sq), flash_bwd_plain(*io)
    if sk > 1:
        _check(got, want)
        return
    # One key: softmax has no gradient there (P = 1, so dS = dP - delta = 0
    # in exact arithmetic), and dq and dk are the rounding of dP - delta in
    # any arithmetic: exact fp32 sums in another order than the reference's
    # miss 2^-15 of max|ref| by orders of magnitude as well.  dv is held to
    # the bar; dq and dk to 2^-15 of the size of the terms that cancel,
    # sum_d |v_d dO_d| per q row carried through K and q as dS is.
    q, k, v, _, _, _, do = io
    _check(got[2:], want[2:])
    terms = (v[:, :1] * do).abs().sum(-1, keepdim=True)           # [1, Sq, 1, 1]
    dq_size = float((terms * k.abs()).max()) / np.sqrt(D)
    dk_size = float((terms * (q * np.float32(q_scale(D))).abs()).sum(1).max()) / LOG2E
    for g, w, size in ((got[0], want[0], dq_size), (got[1], want[1], dk_size)):
        assert float((g - w).abs().max()) <= 2.0 ** -15 * size


# b, bkv, sq, sk, h, mask
FAN_CASES = {
    'reps4_tail_97x2064': (4, 1, 97, 2064, 1, 'tail'),
    'reps2_random_130x200': (2, 1, 130, 200, 2, 'random'),
    'reps1_unmasked_3x_65x129': (3, 3, 65, 129, 1, None),
}


@pytest.mark.parametrize('rounding', ROUNDINGS)
@pytest.mark.parametrize('case', sorted(FAN_CASES))
def test_split_tf32_bwd_with_view_fan_out(case, rounding):
    """V at the scene batch, read at b / reps, and dK and dV at the q batch."""
    b, bkv, sq, sk, h, mask_kind = FAN_CASES[case]
    io = _torch_io(*_inputs(b, bkv, sq, sk, h, mask_kind, seed=11))
    _check(emulate(*io, rounding, 2, seed=b), flash_bwd_plain(*io))


# b, sq, sk, h, mask: K10's backward at the JAX kernel's block edges
JAX_CASES = {
    'masked_tail_64x2064': (1, 64, 2064, 1, 'tail'),
    'random_100x70_h2': (2, 100, 70, 2, 'random'),
    'unmasked_130x129': (1, 130, 129, 1, None),
}


@pytest.mark.parametrize('case', sorted(JAX_CASES))
def test_split_tf32_bwd_matches_jax_kernel(case):
    """Against ``_flash_bwd_fused`` (its Pallas kernel in interpret mode,
    64-row and 64-key blocks) on the output and logsumexp of ``_flash_fwd``
    in interpret mode."""
    b, sq, sk, h, mask_kind = JAX_CASES[case]
    q, k, v, mask, do = _inputs(b, b, sq, sk, h, mask_kind, seed=5)
    jmask = None if mask is None else jnp.asarray(mask)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    out, lse = _flash_fwd(jq, jk, jv, jmask, bq=64, bk=64, interpret=True, with_lse=True)
    want = [torch.from_numpy(np.asarray(w))
            for w in _flash_bwd_fused(jq, jk, jv, jmask, out, lse, jdo, 64, 64, True)]
    tdo = torch.from_numpy(do)
    delta = (tdo * torch.from_numpy(np.asarray(out))).sum(-1).transpose(1, 2).contiguous()
    got = emulate(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                  None if mask is None else torch.from_numpy(mask),
                  torch.from_numpy(_jax_lse(lse, b, sq, h)), delta, tdo, 'toward_zero', 2)
    _check(got, want)


# K9's dQ kernel (the two-kernel backward): its keys split over the 1, 2 or 4
# blocks of a cluster

@functools.lru_cache(maxsize=None)
def _train_site_q_major(site, rounding):
    """A train site's plain dq and the dQ kernel's dS^T and K [B, H, S, D]."""
    sq, sk, mask_kind = TRAIN_SITES[site]
    io = _torch_io(*_inputs(1, 1, sq, sk, 1, mask_kind, seed=sq + sk))
    _, k4, _, _, ds = _scores(*io, rounding, q_major=True)
    return flash_bwd_plain(*io)[0], ds, k4


def _dq_check(got, want):
    """dq [B, H, Sq, D] against the plain [B, Sq, H, D] at 2^-15 of max|ref|."""
    return _check(_bshd(got), (want,))


@pytest.mark.parametrize('splits', [1, 2, 4])
@pytest.mark.parametrize('rounding', ROUNDINGS)
@pytest.mark.parametrize('site', sorted(TRAIN_SITES))
def test_split_tf32_dq_kernel_at_the_train_shapes_within_the_fp32_bar(site, rounding, splits):
    want, ds, k4 = _train_site_q_major(site, rounding)
    _dq_check(_dq(ds, k4, rounding, splits=splits), want)


def test_split_tf32_dq_kernel_sums_in_rank_order():
    """The key split changes only the order of the fp32 adds: the partial
    sums of 2 and 4 blocks differ from 1 block's running sum in the last
    bits, and one split gives the same bits on every run."""
    want, ds, k4 = _train_site_q_major('train_ray_self', 'nearest')
    one, two, four = (_dq(ds, k4, 'nearest', splits=s) for s in (1, 2, 4))
    assert torch.equal(two, _dq(ds, k4, 'nearest', splits=2))
    assert not torch.equal(one, two) and not torch.equal(two, four)
    assert float((one - four).abs().max()) <= 2.0 ** -20 * float(one.abs().max())


@pytest.mark.parametrize('sk', EDGES)
@pytest.mark.parametrize('sq', EDGES)
def test_split_tf32_dq_kernel_at_tile_edges(sq, sk):
    """Ragged q tiles (64 rows) and key steps (16 keys), random keys masked,
    with the pessimistic rounding; the keys split over the most blocks the
    kernel takes (1, 2 or 4) that the key steps fill."""
    io = _torch_io(*_inputs(1, 1, sq, sk, 1, 'random', seed=sq * 1000 + sk))
    nkt = -(-sk // BK_DQ)
    splits = max(s for s in (1, 2, 4) if s <= nkt)
    _, k4, _, _, ds = _scores(*io, 'toward_zero', q_major=True)
    got, want = _dq(ds, k4, 'toward_zero', splits=splits), flash_bwd_plain(*io)[0]
    if sk > 1:
        _dq_check(got, want)
        return
    # One key: dq is the rounding of dP - delta in any arithmetic (see
    # test_split_tf32_bwd_at_tile_edges); held to 2^-15 of the size of the
    # terms that cancel, sum_d |v_d dO_d| per q row carried through K
    q, k, v, _, _, _, do = io
    terms = (v[:, :1] * do).abs().sum(-1, keepdim=True)
    size = float((terms * k.abs()).max()) / np.sqrt(D)
    assert float((_bshd(got)[0] - want).abs().max()) <= 2.0 ** -15 * size


@pytest.mark.parametrize('rounding', ROUNDINGS)
@pytest.mark.parametrize('case', sorted(FAN_CASES))
def test_split_tf32_twokernel_with_view_fan_out(case, rounding):
    """The two-kernel form: V at the scene batch, read at b / reps; dK and dV
    at the q batch; dQ with its keys split over 2 blocks."""
    b, bkv, sq, sk, h, mask_kind = FAN_CASES[case]
    io = _torch_io(*_inputs(b, bkv, sq, sk, h, mask_kind, seed=11))
    _check(emulate(*io, rounding, 2, dq_splits=2), flash_bwd_plain(*io))


@pytest.mark.parametrize('case', sorted(JAX_CASES))
def test_split_tf32_twokernel_matches_jax_kernels(case):
    """Against ``_flash_bwd_twokernel`` (its dQ and dK/dV Pallas kernels in
    interpret mode, 64-row and 64-key blocks) on the output and logsumexp of
    ``_flash_fwd`` in interpret mode; the dQ kernel's keys split over 4
    blocks."""
    b, sq, sk, h, mask_kind = JAX_CASES[case]
    q, k, v, mask, do = _inputs(b, b, sq, sk, h, mask_kind, seed=5)
    jmask = None if mask is None else jnp.asarray(mask)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    out, lse = _flash_fwd(jq, jk, jv, jmask, bq=64, bk=64, interpret=True, with_lse=True)
    want = [torch.from_numpy(np.asarray(w))
            for w in _flash_bwd_twokernel(jq, jk, jv, jmask, out, lse, jdo, 64, 64, True)]
    tdo = torch.from_numpy(do)
    delta = (tdo * torch.from_numpy(np.asarray(out))).sum(-1).transpose(1, 2).contiguous()
    got = emulate(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                  None if mask is None else torch.from_numpy(mask),
                  torch.from_numpy(_jax_lse(lse, b, sq, h)), delta, tdo, 'toward_zero', 2,
                  dq_splits=4)
    _check(got, want)
