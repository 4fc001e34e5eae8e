"""The training side of the port's RoPE flash attention against the JAX
package on the CPU: the logsumexp of the forward's plain version (K1/K2 with
LSE), the gradients of ``flash_attention_rope`` (its autograd Function
around the plain backward of K8/K9) against ``jax.vjp`` of the JAX function,
whose backward runs K8 in Pallas interpret mode, and the plain backward
against K8 and K9 called directly.  Cases are ``test_torch_attention``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderformer_tpu.ops.flash_attention import (
    _bcast_kv, _flash_bwd_fused, _flash_bwd_twokernel, _flash_fwd_rope, _rot_bhsd)
from renderformer_tpu.ops.flash_attention import flash_attention_rope as jax_flash_rope
from renderformer_tpu_torch.ops.flash_attention import (
    flash_attention_rope, flash_backward, flash_bwd, flash_bwd_dkv_plain, flash_bwd_dq_plain,
    flash_bwd_plain, flash_fwd_rope, rot_kv_broadcast)
from test_torch_attention import DTYPES, FLASH_CASES, _t, _tables

BQ = BK = 64


def _inputs(case, seed=0):
    b, bkv, sq, sk, h, d, masked = FLASH_CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(bkv, sk, h, d)).astype(np.float32)
    v = rng.normal(size=(bkv, sk, h, d)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.uniform(size=(b, sk)) > 0.3
        mask[:, 0] = True
    cq, sq_ = _tables(rng, b, sq, d)
    ck, sk_ = _tables(rng, b, sk, d)
    g = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    return q, k, v, mask, (cq, sq_, ck, sk_), g


def _jax_lse(lse, b, sq, h):
    """[B, sq_p, H*LANES] lane-replicated -> [B, H, Sq]."""
    lse = np.asarray(lse).reshape(b, lse.shape[1], h, -1)[:, :sq, :, 0]
    return np.ascontiguousarray(lse.transpose(0, 2, 1))


def _grad_tol(precision, want):
    """fp32: the JAX kernel's 64-key blocks against one-pass sums, summation
    order only: 2e-5 of max|want| plus 1e-5 relative.  bf16: both round q, P
    and dS to bf16 before their products, but at P values that differ in the
    last fp32 bits (the logsumexp of an online against a one-pass softmax),
    so a rounding can flip; each output then rounds once to bf16: 8 bf16 ulps
    of max|want| (8 * 2^-8)."""
    amax = float(np.abs(want).max())
    if precision == 'fp32':
        return dict(atol=2e-5 * amax, rtol=1e-5)
    return dict(atol=8 * 2.0 ** -8 * amax, rtol=0)


@pytest.mark.parametrize('precision', ['fp32', 'bf16'])
@pytest.mark.parametrize('case', sorted(FLASH_CASES))
def test_plain_lse_matches_jax_kernel(case, precision):
    jdt, tdt = DTYPES[precision]
    q, k, v, mask, tabs, _ = _inputs(case)
    b, sq, h, _ = q.shape
    jmask = None if mask is None else jnp.asarray(mask)
    _, want = _flash_fwd_rope(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                              jmask, *[jnp.asarray(t) for t in tabs], bq=BQ, bk=BK,
                              interpret=True, with_lse=True)
    want = _jax_lse(want, b, sq, h)
    cq, sq_, ck, sk_ = (_t(t) for t in tabs)
    with torch.no_grad():
        k_rot = rot_kv_broadcast(_t(k, tdt), ck, sk_)
        out, got = flash_fwd_rope(_t(q, tdt), k_rot, _t(v, tdt),
                                  None if mask is None else torch.from_numpy(mask), cq, sq_,
                                  with_lse=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, h, sq)
    # m*ln2 + ln(l) in fp32: an online against a one-pass maximum and sum
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize('precision', ['fp32', 'bf16'])
@pytest.mark.parametrize('case', sorted(FLASH_CASES))
def test_autograd_matches_jax_vjp(case, precision):
    jdt, tdt = DTYPES[precision]
    q, k, v, mask, tabs, g = _inputs(case, seed=1)
    jmask = None if mask is None else jnp.asarray(mask)
    jt = [jnp.asarray(t) for t in tabs]

    def f(q_, k_, v_):
        return jax_flash_rope(q_, k_, v_, jmask, *jt, bq=BQ, bk=BK, interpret=True)

    _, vjp = jax.vjp(f, jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt))
    wants = [np.asarray(w.astype(jnp.float32)) for w in vjp(jnp.asarray(g, jdt))]

    tq, tk, tv = (_t(x, tdt).requires_grad_(True) for x in (q, k, v))
    out = flash_attention_rope(tq, tk, tv, None if mask is None else torch.from_numpy(mask),
                               *(_t(t) for t in tabs))
    gots = torch.autograd.grad(out, (tq, tk, tv), _t(g, tdt))
    for name, got, want, x in zip('qkv', gots, wants, (tq, tk, tv)):
        assert got.dtype == tdt and got.shape == x.shape, name
        np.testing.assert_allclose(got.float().numpy(), want, err_msg=f'd{name}',
                                   **_grad_tol(precision, want))


@pytest.mark.parametrize('precision', ['fp32', 'bf16'])
@pytest.mark.parametrize('variant', ['fused', 'twokernel'])
@pytest.mark.parametrize('case', ['masked_cross_reps4_d128', 'ragged_sk200',
                                  'unmasked_self_d64_xla_rotate'])
def test_plain_bwd_matches_jax_kernels(case, variant, precision):
    """The plain backward against K8 (``_flash_bwd_fused``) or K9
    (``_flash_bwd_twokernel``) on the same rotated q and k, output and
    logsumexp."""
    jdt, tdt = DTYPES[precision]
    q, k, v, mask, tabs, g = _inputs(case, seed=2)
    b, sq, h, _ = q.shape
    reps = b // k.shape[0]
    jmask = None if mask is None else jnp.asarray(mask)
    jt = [jnp.asarray(t) for t in tabs]
    jq, jk, jv, jg = (jnp.asarray(x, jdt) for x in (q, k, v, g))
    out, lse = _flash_fwd_rope(jq, jk, jv, jmask, *jt, bq=BQ, bk=BK, interpret=True,
                               with_lse=True)
    q_rot = _rot_bhsd(jq, jt[0], jt[1])
    k_rot = _rot_bhsd(_bcast_kv(jk, reps), jt[2], jt[3])
    v_b = _bcast_kv(jv, reps)
    kern = _flash_bwd_fused if variant == 'fused' else _flash_bwd_twokernel
    wants = [np.asarray(w.astype(jnp.float32))
             for w in kern(q_rot, k_rot, v_b, jmask, out, lse, jg, BQ, BK, True)]

    def tt(x):
        return _t(np.asarray(x.astype(jnp.float32)), tdt)

    tg, tout = tt(jg), tt(out)
    delta = (tg.float() * tout.float()).sum(-1).transpose(1, 2).contiguous()
    gots = flash_bwd(tt(q_rot), tt(k_rot), _t(v, tdt),
                     None if mask is None else torch.from_numpy(mask),
                     torch.from_numpy(_jax_lse(lse, b, sq, h)), delta, tg, variant)
    for name, got, want in zip('qkv', gots, wants):
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), want, err_msg=f'd{name}',
                                   **_grad_tol(precision, want))


@pytest.mark.parametrize('precision', ['fp32', 'bf16'])
@pytest.mark.parametrize('case', ['masked_cross_reps4_d128', 'ragged_sk200',
                                  'unmasked_self_d64_xla_rotate'])
def test_plain_bwd_parts_are_the_whole(case, precision):
    """The plain versions of K9's dQ and dK/dV kernels are the parts of the
    whole plain backward, bit for bit."""
    _, tdt = DTYPES[precision]
    q, k, v, mask, (cq, sq_, ck, sk_), g = _inputs(case, seed=3)
    tmask = None if mask is None else torch.from_numpy(mask)
    tq, tg, tv = _t(q, tdt), _t(g, tdt), _t(v, tdt)
    k_rot = rot_kv_broadcast(_t(k, tdt), _t(ck), _t(sk_))
    out, lse = flash_fwd_rope(tq, k_rot, tv, tmask, _t(cq), _t(sq_), with_lse=True)
    delta = (tg.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    q_rot = rot_kv_broadcast(tq, _t(cq), _t(sq_))
    io = (q_rot, k_rot, tv, tmask, lse, delta, tg)
    dq, dk, dv = flash_bwd_plain(*io)
    assert torch.equal(flash_bwd_dq_plain(*io), dq)
    got_dk, got_dv = flash_bwd_dkv_plain(*io)
    assert torch.equal(got_dk, dk) and torch.equal(got_dv, dv)


def test_backward_variant_checked():
    with pytest.raises(ValueError):
        with flash_backward('threekernel'):
            pass
    z = torch.zeros
    with pytest.raises(ValueError):
        flash_bwd(z(1, 4, 1, 8), z(1, 4, 1, 8), z(1, 4, 1, 8), None, z(1, 1, 4), z(1, 1, 4),
                  z(1, 4, 1, 8), 'atomic')
    with pytest.raises(ValueError):  # lse in [B, Sq, H] instead of [B, H, Sq]
        flash_bwd(z(1, 4, 2, 8), z(1, 4, 2, 8), z(1, 4, 2, 8), None, z(1, 4, 2), z(1, 2, 4),
                  z(1, 4, 2, 8))
