"""The arithmetic of the fp32 Swin window attention kernels
(``csrc/swin_attention_f32.cu``: K6 and its backward K6^T in fp32), emulated
in torch on the CPU, against the port's plain versions (exact fp32), the JAX
package's Pallas kernel in interpret mode (``_swin_fwd``) and the VJP of its
jnp reference (``_ref_paired``, which ``_swin_op_bwd`` takes).

Both kernels take every product on the tensor cores as split TF32, as the
fp32 flash kernels do (``test_torch_flash_fp32.py``): an operand x is hi +
lo with hi = x truncated to TF32 (``split_tf32_trunc``, as the fp32 flash
backward takes it; hi rounded to nearest as ``split_tf32`` is emulated
beside it, ``SPLITS``) and lo = x - hi truncated to TF32, and a*b is
a_lo*b_hi + a_hi*b_lo + a_hi*b_hi.  The emulation follows the kernels step
by step:

  * S = Q K^T and dP = dO V^T over the head dim in 8-wide k steps, the
    hi*hi products in one fp32 accumulator and the two small products of
    each step (lo*hi first) in another, added before the mask;
  * P V, dQ = dS K, dK = dS^T q and dV = P^T dO in 8-wide k steps over the
    keys or the queries, each step's three products (the small ones first)
    into one accumulator over the whole window;
  * each mma adds the exact sum of its 8 products to its accumulator and
    rounds once, to nearest or toward zero (``ROUNDINGS``);
  * the softmax's row sums, and rowsum(P o dP), in the kernels' order: a
    thread's keys (8j + 2t, 8j + 2t + 1) in turn, then the quad's partials
    added by two shuffles; in K6^T each half of the keys so, the two
    halves' sums then added.

Everything is held to the unchanged bar of the card's checks, 2^-16 of
max|ref| per output, at the swin-large train step's head dim and
magnitudes (D 128, unit normal inputs) on windows of its 64 x 64 grid
unshifted and shifted by 4: windows 6, 7, 56, 57, 62 and 63, which hold
every region pattern of the shifted grid (one region, two split across a
column or a row, four in the corner).  One more case shows that the bar
bites: a single TF32 product (no lo terms) reads far above it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderformer_tpu.ops.swin_attention import (
    _pair_bias_shifted, _pair_bias_unshifted, _ref_paired, _swin_fwd)
from renderformer_tpu_torch.ops.swin_attention import (
    LN2, NEG_INF, q_scale, region_table, swin_window_attention_bwd_plain,
    swin_window_attention_plain)
from test_torch_flash_fp32 import ROUNDINGS, _mma, _one_thread, tf32, tf32_truncated  # noqa: F401

D, H, GRID = 128, 2, 64
WINDOWS = [6, 7, 56, 57, 62, 63]  # consecutive pairs, as the JAX kernel pairs them
SPLITS = ('rounded', 'truncated')  # hi of split_tf32 / split_tf32_trunc
KERNEL_SPLIT = 'truncated'         # the kernels' choice: split_tf32_trunc


def _split(x, kind):
    hi = tf32(x) if kind == 'rounded' else tf32_truncated(x)
    return hi, tf32_truncated(x - hi)


def _scores(a, b, rounding, kind, terms=3):
    """a b^T over the head dim as S and dP take it: hi*hi in one
    accumulator, the small products of each 8-wide step in another."""
    ah, al = _split(a, kind)
    bh, bl = _split(b, kind)
    big = torch.zeros(a.shape[:-1] + b.shape[-2:-1])
    small = torch.zeros_like(big)
    eq = '...qd,...kd->...qk'
    for c in range(0, a.shape[-1], 8):
        s = slice(c, c + 8)
        if terms == 3:
            small = _mma(small, al[..., s], bh[..., s], eq, rounding)
            small = _mma(small, ah[..., s], bl[..., s], eq, rounding)
        big = _mma(big, ah[..., s], bh[..., s], eq, rounding)
    return big + small


def _matmul(a, b, rounding, kind, terms=3):
    """a b into one accumulator, in 8-wide k steps, each step's products
    small first (lo*hi, hi*lo, hi*hi)."""
    ah, al = _split(a, kind)
    bh, bl = _split(b, kind)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    eq = '...mk,...kn->...mn'
    for c in range(0, a.shape[-1], 8):
        s = slice(c, c + 8)
        if terms == 3:
            acc = _mma(acc, al[..., s], bh[..., s, :], eq, rounding)
            acc = _mma(acc, ah[..., s], bl[..., s, :], eq, rounding)
        acc = _mma(acc, ah[..., s], bh[..., s, :], eq, rounding)
    return acc


def _quad_sum(x, y=None, halves=1):
    """Row sums of x [..., 64] (of fmaf(x, y, acc) with y) as the kernels
    take them: the keys in ``halves`` contiguous parts, a part's sum by a
    quad of threads (thread t adds its keys 8j + 2t and 8j + 2t + 1 of the
    part for j in turn, then the partials meet by the xor-1 and xor-2
    shuffles), the parts' sums added in order."""
    xs = x.reshape(*x.shape[:-1], halves, 8 // halves, 4, 2)
    ys = None if y is None else y.reshape(xs.shape)
    part = torch.zeros(xs.shape[:-3] + (4,))
    for j in range(8 // halves):
        for e in range(2):
            if ys is None:
                part = part + xs[..., j, :, e]
            else:  # one rounding, as fmaf
                part = (xs[..., j, :, e].double() * ys[..., j, :, e].double()
                        + part.double()).float()
    pair = part[..., 0::2] + part[..., 1::2]
    sums = pair[..., 0] + pair[..., 1]
    total = sums[..., 0]
    for h in range(1, halves):
        total = total + sums[..., h]
    return total[..., None]


def _softmax(q, k, bias, rounding, kind, terms=3, halves=1):
    """(q scaled and rounded, P) as the kernels compute them: q [W, H, 64, D]
    unscaled, bias [W, 64, 64] or None; the row sums over ``halves`` parts
    of the keys."""
    qs = q * q_scale(D)
    s = _scores(qs, k, rounding, kind, terms)
    if bias is not None:
        s = s + bias[:, None]
    e = torch.exp2(s - s.amax(-1, keepdim=True))
    return qs, e / _quad_sum(e, halves=halves)


def emulate_fwd(q, k, v, bias, rounding='nearest', kind=KERNEL_SPLIT, terms=3):
    """The fp32 K6's arithmetic: out [W, H, 64, D]."""
    _, p = _softmax(q, k, bias, rounding, kind, terms)
    return _matmul(p, v, rounding, kind, terms)


def emulate_bwd(q, k, v, do, bias, rounding='nearest', kind=KERNEL_SPLIT, terms=3):
    """The fp32 K6^T's arithmetic: (dq, dk, dv) [W, H, 64, D].  Each row's
    keys are split over two warps, whose sums meet in shared memory."""
    qs, p = _softmax(q, k, bias, rounding, kind, terms, halves=2)
    dp = _scores(do, v, rounding, kind, terms)
    ds = (p * (dp - _quad_sum(p, dp, halves=2))) * LN2
    dq = _matmul(ds, k, rounding, kind, terms) * q_scale(D)
    dk = _matmul(ds.transpose(-1, -2), qs, rounding, kind, terms)
    dv = _matmul(p.transpose(-1, -2), do, rounding, kind, terms)
    return dq, dk, dv


def _inputs(seed, n=4):
    """n unit normal [W, 64, H*D] fp32 arrays of the six windows."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(len(WINDOWS), 64, H * D)).astype(np.float32) for _ in range(n)]


def _heads(x):
    """[W, 64, H*D] -> [W, H, 64, D]."""
    return torch.from_numpy(x).reshape(len(WINDOWS), 64, H, D).transpose(1, 2).contiguous()


def _flat(x):
    """[W, H, 64, D] -> [W, 64, H*D] numpy."""
    return x.transpose(1, 2).reshape(len(WINDOWS), 64, H * D).numpy()


def _regions(shift):
    """The six windows' rows of the region table, or None unshifted."""
    if not shift:
        return None
    return region_table(GRID, GRID, 8, shift, torch.device('cpu'))[WINDOWS].contiguous()


def _bias(regions):
    if regions is None:
        return None
    same = regions[:, :, None] == regions[:, None, :]
    return torch.where(same, 0.0, NEG_INF).float()


def _jax_bias(shift):
    """The JAX kernel's pair bias of the three window pairs."""
    if not shift:
        return jnp.asarray(_pair_bias_unshifted())
    return jnp.asarray(_pair_bias_shifted(GRID, GRID, 8, shift)[[w // 2 for w in WINDOWS[::2]]])


def _within(got, want, what):
    """max |got - want| against 2^-16 of max|want|; returns the share of
    the bar used."""
    want = np.asarray(want, np.float32)
    tol = 2.0 ** -16 * float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol, (what, err, tol)
    return err / tol


@pytest.mark.parametrize('kind', SPLITS)
@pytest.mark.parametrize('rounding', ROUNDINGS)
@pytest.mark.parametrize('shift', [0, 4])
def test_fwd_split_tf32_within_the_fp32_bar(shift, rounding, kind):
    q, k, v = _inputs(shift, 3)
    regions = _regions(shift)
    got = _flat(emulate_fwd(_heads(q), _heads(k), _heads(v), _bias(regions), rounding, kind))
    plain = swin_window_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)), H, regions)
    _within(got, plain.numpy(), 'plain')
    jout = _swin_fwd(*(jnp.asarray(x) for x in (q, k, v)), _jax_bias(shift), pairs_per_block=1,
                     interpret=True)
    _within(got, jout, 'jax kernel')


@pytest.mark.parametrize('kind', SPLITS)
@pytest.mark.parametrize('rounding', ROUNDINGS)
@pytest.mark.parametrize('shift', [0, 4])
def test_bwd_split_tf32_within_the_fp32_bar(shift, rounding, kind):
    q, k, v, do = _inputs(10 + shift)
    regions = _regions(shift)
    got = emulate_bwd(*(_heads(x) for x in (q, k, v, do)), _bias(regions), rounding, kind)
    plain = swin_window_attention_bwd_plain(*(torch.from_numpy(x) for x in (q, k, v, do)), H,
                                            regions)
    bias = _jax_bias(shift)
    _, vjp = jax.vjp(lambda a, b, c: _ref_paired(a, b, c, bias),
                     *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    for name, g, p, j in zip(('dq', 'dk', 'dv'), got, plain, jgrads):
        _within(_flat(g), p.numpy(), f'{name} against plain')
        _within(_flat(g), j, f'{name} against the jax vjp')


@pytest.mark.parametrize('shift', [0, 4])
def test_a_single_tf32_product_misses_the_bar(shift):
    """Without the lo terms (one TF32 product, as the tensor cores' plain
    TF32 mode takes fp32) the outputs read far above 2^-16 of max|ref|."""
    q, k, v, do = _inputs(20 + shift)
    regions = _regions(shift)
    tq, tk, tv, tdo = (_heads(x) for x in (q, k, v, do))
    out = _flat(emulate_fwd(tq, tk, tv, _bias(regions), terms=1))
    plain = swin_window_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)), H,
                                        regions).numpy()
    with pytest.raises(AssertionError):
        _within(out, plain, 'fwd')
    assert np.abs(out - plain).max() > 8 * 2.0 ** -16 * np.abs(plain).max()
    grads = emulate_bwd(tq, tk, tv, tdo, _bias(regions), terms=1)
    plains = swin_window_attention_bwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v, do)), H, regions)
    for g, p in zip(grads, plains):
        g, p = _flat(g), p.numpy()
        assert np.abs(g - p).max() > 8 * 2.0 ** -16 * np.abs(p).max()
