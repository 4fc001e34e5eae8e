"""The arithmetic of the fp32 flash forward (``csrc/flash_attention.cu``:
K1/K2 and K10 in fp32), emulated in torch on the CPU, against the plain
version (exact fp32) and the JAX package's Pallas kernels in interpret mode
(``_flash_fwd_rope`` / ``_flash_fwd``).

The kernel takes both products on the tensor cores as split TF32: an
operand x is hi + lo with hi = x rounded to TF32 to nearest with ties away
from zero (``cvt.rna``'s rounding) and lo = x - hi truncated to TF32, and
a*b is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi.  The emulation follows the kernel
step by step:

  * S of a 32-key tile in two fp32 accumulators, the hi*hi products in one
    and the two small products of each 8-wide k step (lo*hi first) in the
    other, added before the key bias;
  * each mma adds the exact sum of its 8 products to its accumulator and
    rounds once, to nearest, or toward zero (``ROUNDINGS``: the tensor
    cores' adder is not specified; truncation is the pessimistic model);
  * the online softmax in exp2 per tile; P split after the exp2, and the
    tile's P.V per 8-key step, the small products first, into a fresh
    accumulator that one fused multiply-add adds to O * alpha;
  * the keys split into contiguous chunks of tiles (the blocks of a
    cluster), each chunk's unnormalised O, m and l merged by the logsumexp.

Everything is held to the unchanged bars of the card's checks: the output
within 2^-16 of max|ref|, the logsumexp within 1e-5 of max|lse| + 2e-5, at
the train step's head dim and magnitudes (D 128, 1024 queries against 2064
keys with a padded tail masked, or 1024 unmasked; and 4096 keys, the
fp32 render's longest range), at the kernel's tile
edges (query and key counts from {1, 63, 65, 129, 257}), with a batch row
whose mask is all zero (uniform over the real keys) and with a view fan-out
of 8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderformer_tpu.ops.flash_attention import _flash_fwd, _flash_fwd_rope
from renderformer_tpu_torch.encodings.rope import apply_rope
from renderformer_tpu_torch.ops.flash_attention import (
    LN2, NEG_INF, fan_out, flash_fwd_plain, flash_fwd_rope_plain, q_scale)
from test_torch_attention import _tables
from test_torch_flash_bwd import _jax_lse

D = 128
BK = 32      # keys a tile of the fp32 kernel
SPLITS = (1, 2, 4, 8)
ROUNDINGS = ('nearest', 'toward_zero')


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


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to 10 mantissa bits, to nearest with ties away from zero
    (``cvt.rna``): half a TF32 ulp added to the magnitude bits, the low 13
    bits cleared."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """fp32 truncated to 10 mantissa bits (the low 13 bits cleared)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32_truncated(x - hi)


def _round(exact: torch.Tensor, rounding: str) -> torch.Tensor:
    """float64 -> fp32 to nearest, or toward zero."""
    r = exact.float()
    if rounding == 'toward_zero':
        away = r.double().abs() > exact.abs()
        r = torch.where(away, torch.nextafter(r, torch.zeros_like(r)), r)
    return r


def _mma(acc, a, b, eq, rounding):
    """One mma step: acc + the exact sum of the products of TF32 operands
    (exact in float64), rounded once."""
    return _round(acc.double() + torch.einsum(eq, a.double(), b.double()), rounding)


def emulate(qs, k, v, mask, splits, rounding='nearest'):
    """The fp32 kernel's arithmetic on q already rotated (or scaled) by
    D^-0.5*log2(e): qs, k [B, Sq|Sk, H, D], v [Bkv, Sk, H, D], mask [B, Sk]
    or None; keys split into ``splits`` chunks of tiles.  Returns (out
    [B, Sq, H, D], lse [B, H, Sq])."""
    b, sq, h, d = qs.shape
    sk = k.shape[1]
    q4 = qs.permute(0, 2, 1, 3)                              # [B, H, Sq, D]
    k4 = k.permute(0, 2, 1, 3)
    v4 = fan_out(v, b).permute(0, 2, 1, 3)
    bias = torch.zeros(b, sk)
    if mask is not None:
        bias = torch.where(mask, 0.0, NEG_INF).float()
    qh, ql = split(q4)
    nkt = -(-sk // BK)
    parts = []
    for c in range(splits):
        o = torch.zeros(b, h, sq, d)
        m = torch.full((b, h, sq, 1), NEG_INF)
        l = torch.zeros(b, h, sq, 1)
        for kt in range(nkt * c // splits, nkt * (c + 1) // splits):
            k0, k1 = kt * BK, min(sk, kt * BK + BK)
            kh, kl = split(k4[:, :, k0:k1])
            s_hi = torch.zeros(b, h, sq, k1 - k0)
            s_lo = torch.zeros_like(s_hi)
            for kk in range(0, d, 8):
                sl = slice(kk, kk + 8)
                eq = 'bhqd,bhkd->bhqk'
                s_lo = _mma(s_lo, ql[..., sl], kh[..., sl], eq, rounding)
                s_lo = _mma(s_lo, qh[..., sl], kl[..., sl], eq, rounding)
                s_hi = _mma(s_hi, qh[..., sl], kh[..., sl], eq, rounding)
            s = (s_hi + s_lo) + bias[:, None, None, k0:k1]
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            m, l = m_new, l * alpha + p.sum(-1, keepdim=True)
            ph, pl = split(p)
            vh, vl = split(v4[:, :, k0:k1])
            ot = torch.zeros_like(o)
            for j in range(0, k1 - k0, 8):
                sl = slice(j, j + 8)
                eq = 'bhqk,bhkd->bhqd'
                ot = _mma(ot, pl[..., sl], vh[:, :, sl], eq, rounding)
                ot = _mma(ot, ph[..., sl], vl[:, :, sl], eq, rounding)
                ot = _mma(ot, ph[..., sl], vh[:, :, sl], eq, rounding)
            o = (o.double() * alpha.double() + ot.double()).float()  # one FFMA
        parts.append((o, m, l))
    big = torch.stack([m for _, m, _ in parts]).amax(0)
    w = [torch.exp2(m - big) for _, m, _ in parts]
    lsum = sum(wc * l for wc, (_, _, l) in zip(w, parts))
    out = sum(wc * o for wc, (o, _, _) in zip(w, parts)) / lsum
    lse = (big * LN2 + torch.log(lsum))[..., 0]
    return out.permute(0, 2, 1, 3).contiguous(), lse


def _inputs(b, bkv, sq, sk, h, masked, zero_row, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, D)).astype(np.float32)
    k = rng.normal(size=(b, sk, h, D)).astype(np.float32)
    v = rng.normal(size=(bkv, sk, h, D)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.uniform(size=(b, sk)) > 0.3
        mask[:, 0] = True
        if zero_row:
            mask[1] = False
    return q, k, v, mask, tuple(np.array(t) for t in _tables(rng, b, sq, D))


def _scaled_q(q, tabs, rope):
    """q as the kernel's prologue leaves it in shared memory."""
    qt = torch.from_numpy(q)
    if not rope:
        return qt * q_scale(D)
    c, s = (torch.from_numpy(t) * q_scale(D) for t in tabs)
    return apply_rope(qt, c[:, :, None, :], s[:, :, None, :])


def _plain(q, k, v, mask, tabs, rope):
    args = [torch.from_numpy(x) for x in (q, k, v)]
    tmask = None if mask is None else torch.from_numpy(mask)
    if rope:
        c, s = (torch.from_numpy(t) for t in tabs)
        return flash_fwd_rope_plain(*args, tmask, c, s)
    return flash_fwd_plain(*args, tmask)


def _check(got, want, rows=None):
    """The card's bars: out within 2^-16 of max|ref|, lse within 1e-5 of
    max|lse| + 2e-5 (rows whose keys are all masked left out of the lse
    bar, as ``chip_smoke.py`` does)."""
    (out, lse), (ref, ref_lse) = got, want
    rows = list(range(out.shape[0])) if rows is None else rows
    tol = 2.0 ** -16 * float(ref.abs().max())
    err = float((out - ref).abs().max())
    assert err <= tol, (err, tol)
    lse_tol = 1e-5 * float(ref_lse[rows].abs().max()) + 2e-5
    assert float((lse[rows] - ref_lse[rows]).abs().max()) <= lse_tol
    return err / tol


# the train step's fp32 sites at 2 heads: cross-attention (1024 rays against
# 2064 triangle tokens, the last quarter of the triangles a padded tail) and
# ray self-attention (1024 rays, unmasked)
TRAIN_SITES = {'train_cross': (1024, 2064, True), 'train_ray_self': (1024, 1024, False)}
# and the longest key range the fp32 kernel sees, the 512^2 render's ray
# self-attention (4096 keys; 256 of its queries)
SITES = {**TRAIN_SITES, 'render_ray_self_keys': (256, 4096, False)}


@pytest.mark.parametrize('rounding', ROUNDINGS)
@pytest.mark.parametrize('splits', SPLITS)
@pytest.mark.parametrize('site', sorted(SITES))
def test_split_tf32_at_main_path_shapes_within_the_fp32_bar(site, splits, rounding):
    sq, sk, masked = SITES[site]
    q, k, v, _, tabs = _inputs(1, 1, sq, sk, 2, False, False, seed=splits)
    mask = None
    if masked:
        mask = np.ones((1, sk), bool)
        mask[:, 16 + 2048 * 3 // 4:] = False
    qs = _scaled_q(q, tabs, rope=True)
    got = emulate(qs, torch.from_numpy(k), torch.from_numpy(v),
                  None if mask is None else torch.from_numpy(mask), splits, rounding)
    # the plain version is exact fp32 (its logits from the same rotated q)
    _check(got, _plain(q, k, v, mask, tabs, rope=True))


@pytest.mark.parametrize('rope', [True, False])
@pytest.mark.parametrize('site', sorted(TRAIN_SITES))
def test_split_tf32_at_the_train_shapes_matches_jax_kernel(site, rope):
    """Against the Pallas kernel in interpret mode (64-row, 64-key blocks),
    with the key split the card takes at these grids (8)."""
    sq, sk, masked = TRAIN_SITES[site]
    q, k, v, _, tabs = _inputs(1, 1, sq, sk, 1, False, False, seed=3)
    mask = None
    if masked:
        mask = np.ones((1, sk), bool)
        mask[:, 16 + 2048 * 3 // 4:] = False
    jmask = None if mask is None else jnp.asarray(mask)
    if rope:
        rng = np.random.default_rng(4)
        ktabs = tuple(np.array(t) for t in _tables(rng, 1, sk, D))
        jout, jlse = _flash_fwd_rope(*(jnp.asarray(x) for x in (q, k, v)), jmask,
                                     *(jnp.asarray(t) for t in tabs + ktabs), bq=64, bk=64,
                                     interpret=True, with_lse=True)
        # the port's kernel takes K already rotated by K3 at these tables
        c, s = (torch.from_numpy(t) for t in ktabs)
        kt = apply_rope(torch.from_numpy(k), c[:, :, None, :], s[:, :, None, :])
    else:
        jout, jlse = _flash_fwd(*(jnp.asarray(x) for x in (q, k, v)), jmask, bq=64, bk=64,
                                interpret=True, with_lse=True)
        kt = torch.from_numpy(k)
    want = (torch.from_numpy(np.asarray(jout)), torch.from_numpy(_jax_lse(jlse, 1, sq, 1)))
    got = emulate(_scaled_q(q, tabs, rope), kt, torch.from_numpy(v),
                  None if mask is None else torch.from_numpy(mask), 8)
    _check(got, want)


EDGES = (1, 63, 65, 129, 257)


@pytest.mark.parametrize('splits', [1, 8])
@pytest.mark.parametrize('sk', EDGES)
@pytest.mark.parametrize('sq', EDGES)
def test_split_tf32_at_tile_edges(sq, sk, splits):
    """Ragged query and key tiles, and key chunks of which some may hold no
    tile (8 chunks of ceil(Sk / 32) tiles), masked, at the q batch."""
    q, k, v, mask, tabs = _inputs(1, 1, sq, sk, 1, True, False, seed=sq * 1000 + sk)
    tm = torch.from_numpy(mask)
    got = emulate(_scaled_q(q, tabs, rope=False), torch.from_numpy(k), torch.from_numpy(v), tm,
                  splits)
    _check(got, _plain(q, k, v, mask, tabs, rope=False))


# b, bkv, sq, sk, h, masked, whether batch row 1's mask is all zero
FAN_CASES = {
    'reps8_masked_257x129': (8, 1, 257, 129, 2, True, False),
    'reps8_zero_row_65x257': (8, 1, 65, 257, 1, True, True),
    'reps2_zero_row_129x63': (2, 1, 129, 63, 2, True, True),
    'reps1_unmasked_63x65': (3, 3, 63, 65, 1, False, False),
}


@pytest.mark.parametrize('splits', [1, 4])
@pytest.mark.parametrize('case', sorted(FAN_CASES))
def test_split_tf32_with_view_fan_out_and_a_keyless_row(case, splits):
    b, bkv, sq, sk, h, masked, zero_row = FAN_CASES[case]
    q, k, v, mask, tabs = _inputs(b, bkv, sq, sk, h, masked, zero_row, seed=7)
    tm = None if mask is None else torch.from_numpy(mask)
    got = emulate(_scaled_q(q, tabs, rope=True), torch.from_numpy(k), torch.from_numpy(v), tm,
                  splits)
    want = _plain(q, k, v, mask, tabs, rope=True)
    rows = [i for i in range(b) if not (zero_row and i == 1)]
    _check(got, want, rows)
    if zero_row:
        # the row with no key: uniform over the Sk real keys in every chunk
        # merge, lse -1e30*ln2 + ln(Sk)
        mean = fan_out(torch.from_numpy(v), b)[1].double().mean(0)  # [h, D]
        torch.testing.assert_close(got[0][1].double(), mean.expand(sq, h, D), atol=1e-6,
                                   rtol=0)
        torch.testing.assert_close(got[1][1].double(),
                                   torch.full((h, sq), -1e30 * LN2 + np.log(sk),
                                              dtype=torch.float64), atol=0, rtol=1e-6)
