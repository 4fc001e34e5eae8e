"""The plain versions of kernels K1/K2 (flash forward with fused q-RoPE) and
K3 (K broadcast-rotate), and the attention modules of the port, against
the JAX package on the CPU.  The JAX kernels run in Pallas interpret mode
as tests/test_flash_attention.py runs them; the JAX modules at impl='xla'.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderformer_tpu.encodings.rope import make_cos_sin as jax_make_cos_sin
from renderformer_tpu.nn import attention as jattn
from renderformer_tpu.ops.flash_attention import _rot_kv_broadcast
from renderformer_tpu.ops.flash_attention import flash_attention_rope as jax_flash_rope
from renderformer_tpu_torch.convert import jax_params_to_state_dict
from renderformer_tpu_torch.nn import attention as tattn
from renderformer_tpu_torch.ops.flash_attention import (
    flash_attention_rope, flash_fwd_rope, rot_kv_broadcast)

DTYPES = {'fp32': (jnp.float32, torch.float32), 'bf16': (jnp.bfloat16, torch.bfloat16)}


def _attn_tol(precision, want):
    """fp32: the JAX kernel's 64-key online softmax vs the plain one-pass
    softmax differ in summation order only.  bf16: both round q and P to
    bf16, but P against a different running maximum, and the output rounds
    once to bf16: 4 bf16 ulps of the largest output (4 * 2^-8 * max|want|)."""
    if precision == 'fp32':
        return dict(atol=2e-5, rtol=1e-5)
    return dict(atol=4 * 2.0 ** -8 * float(np.abs(want).max()), rtol=0)


def _tables(rng, b, s, d):
    pos = (rng.normal(size=(b, s, 9)) * 0.3).astype(np.float32)
    # 9 * rope_dim / 2 angles must fit in d / 2
    c, sn = jax_make_cos_sin(jnp.asarray(pos), rope_dim=12 if d >= 108 else 6, head_dim=d)
    return np.asarray(c[:, :, 0]), np.asarray(sn[:, :, 0])


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


# b, bkv, sq, sk, h, d, masked — JAX takes its broadcast-rotate kernel arm for
# d % 128 == 0 with reps > 1 or h % 8 == 0, else its XLA rotate arm
FLASH_CASES = {
    'masked_self_reps1_d128_rotkernel': (1, 1, 128, 128, 8, 128, True),
    'masked_cross_reps4_d128': (4, 1, 64, 96, 2, 128, True),
    'unmasked_self_d64_xla_rotate': (2, 2, 128, 128, 2, 64, False),
    'ragged_sk200': (2, 1, 64, 200, 2, 128, True),
    'masked_cross_reps2_d64': (2, 1, 64, 80, 2, 64, True),
}


@pytest.mark.parametrize('precision', ['fp32', 'bf16'])
@pytest.mark.parametrize('case', sorted(FLASH_CASES))
def test_flash_rope_plain_matches_jax_kernel(case, precision):
    b, bkv, sq, sk, h, d, masked = FLASH_CASES[case]
    jdt, tdt = DTYPES[precision]
    rng = np.random.default_rng(0)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(bkv, sk, h, d)).astype(np.float32)
    v = rng.normal(size=(bkv, sk, h, d)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.uniform(size=(b, sk)) > 0.3
        mask[:, 0] = True
    cq, sq_ = _tables(rng, b, sq, d)
    ck, sk_ = _tables(rng, b, sk, d)
    want = jax_flash_rope(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        None if mask is None else jnp.asarray(mask), jnp.asarray(cq), jnp.asarray(sq_),
        jnp.asarray(ck), jnp.asarray(sk_), bq=64, bk=64, interpret=True)
    with torch.no_grad():
        got = flash_attention_rope(
            _t(q, tdt), _t(k, tdt), _t(v, tdt),
            None if mask is None else torch.from_numpy(mask),
            _t(cq), _t(sq_), _t(ck), _t(sk_))
    assert got.dtype == tdt
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, **_attn_tol(precision, want))


@pytest.mark.parametrize('precision', ['fp32', 'bf16'])
@pytest.mark.parametrize('bkv,reps,sk,h', [(1, 4, 70, 2), (2, 1, 128, 3)])
def test_rot_kv_plain_matches_jax_kernel(bkv, reps, sk, h, precision):
    jdt, tdt = DTYPES[precision]
    d = 128
    b = bkv * reps
    rng = np.random.default_rng(1)
    k = rng.normal(size=(bkv, sk, h, d)).astype(np.float32)
    c, s = _tables(rng, b, sk, d)
    sk_p = -(-sk // 128) * 128
    want = _rot_kv_broadcast(jnp.asarray(k, jdt), jnp.asarray(c), jnp.asarray(s), sk_p,
                             interpret=True)
    want = np.asarray(want.astype(jnp.float32)).reshape(b, sk_p, -1, d)[:, :sk, :h]
    with torch.no_grad():
        got = rot_kv_broadcast(_t(k, tdt), _t(c), _t(s))
    # the same fp32 products and sum, rounded once to the dtype; XLA may fuse
    # a product into an FMA, which moves a bf16 result by one ulp (2^-7 rel.)
    tol = dict(atol=1e-6, rtol=0) if precision == 'fp32' else dict(atol=1e-6, rtol=2 ** -7)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize('precision', ['fp32', 'bf16'])
@pytest.mark.parametrize('masked', [False, True])
def test_sdpa_matches_jax_sdpa_xla(masked, precision):
    jdt, tdt = DTYPES[precision]
    rng = np.random.default_rng(6)
    b, sq, sk, h, d = 2, 24, 40, 3, 32
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32) for s in (sq, sk, sk))
    mask = None
    if masked:
        mask = rng.uniform(size=(b, 1, 1, sk)) > 0.3
        mask[..., 0] = True
    want = jattn.sdpa_xla(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                          None if mask is None else jnp.asarray(mask))
    got = tattn.sdpa(_t(q, tdt), _t(k, tdt), _t(v, tdt),
                     None if mask is None else torch.from_numpy(mask))
    assert got.dtype == tdt
    want = np.asarray(want.astype(jnp.float32))
    # fp32: summation order; bf16: P rounds to bf16 in both, then a bf16
    # product whose accumulation order differs: 4 bf16 ulps of max|want|
    tol = (dict(atol=2e-6, rtol=1e-5) if precision == 'fp32'
           else dict(atol=4 * 2.0 ** -8 * float(np.abs(want).max()), rtol=0))
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def _load(module, jax_params):
    module.load_state_dict(jax_params_to_state_dict(jax.tree.map(np.asarray, jax_params)))
    return module.eval()


MOD_TOL = dict(atol=2e-5, rtol=1e-5)  # fp32, summation order


def _inputs(rng, b, s, c):
    return rng.normal(size=(b, s, c)).astype(np.float32)


@pytest.mark.parametrize('cross', [False, True])
def test_multihead_attention(cross):
    rng = np.random.default_rng(2)
    dim, heads, ctx_dim = 128, 2, 96
    b, bkv, sq, sk = 4, (2 if cross else 4), 24, (40 if cross else 24)
    jm = jattn.MultiHeadAttention(dim, heads, kv_dim=ctx_dim if cross else None,
                                  qk_norm=True)
    params = jm.init(jax.random.key(0))
    tm = _load(tattn.MultiHeadAttention(dim, heads, ctx_dim if cross else None,
                                        qk_norm=True), params)
    x = _inputs(rng, b, sq, dim)
    kv = _inputs(rng, bkv, sk, ctx_dim) if cross else x
    mask = rng.uniform(size=(b, sk)) > 0.2
    mask[:, 0] = True
    cq, sq_ = _tables(rng, b, sq, dim // heads)
    ck, sk_ = _tables(rng, b, sk, dim // heads) if cross else (cq, sq_)
    want = jm(params, jnp.asarray(x), jnp.asarray(kv), jnp.asarray(kv), jnp.asarray(mask),
              jnp.asarray(cq)[:, :, None], jnp.asarray(sq_)[:, :, None],
              jnp.asarray(ck)[:, :, None], jnp.asarray(sk_)[:, :, None], impl='xla')
    with torch.no_grad():
        got = tm(_t(x), _t(kv), _t(kv), torch.from_numpy(mask), _t(cq), _t(sq_),
                 _t(ck), _t(sk_))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOD_TOL)


def test_attention_layer_cross_with_self_attention():
    rng = np.random.default_rng(3)
    dim, heads, ctx_dim, ffn = 128, 2, 96, 192
    b, bkv, sq, sk = 4, 1, 16, 30
    jl = jattn.AttentionLayer(dim, heads, ffn, kv_dim=ctx_dim, qk_norm=True,
                              add_self_attn=True)
    params = jl.init(jax.random.key(1))
    tl = _load(tattn.AttentionLayer(dim, heads, ffn, kv_dim=ctx_dim, qk_norm=True,
                                    add_self_attn=True), params)
    x = _inputs(rng, b, sq, dim)
    ctx = _inputs(rng, bkv, sk, ctx_dim)
    mask = np.ones((b, sk), bool)
    mask[:, -5:] = False
    cq, sq_ = _tables(rng, b, sq, dim // heads)
    ck, sk_ = _tables(rng, b, sk, dim // heads)
    want = jl(params, jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(mask),
              jnp.asarray(cq)[:, :, None], jnp.asarray(sq_)[:, :, None],
              jnp.asarray(ck)[:, :, None], jnp.asarray(sk_)[:, :, None], impl='xla')
    with torch.no_grad():
        got = tl(_t(x), _t(ctx), torch.from_numpy(mask), _t(cq), _t(sq_), _t(ck), _t(sk_))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOD_TOL)


@pytest.mark.parametrize('activation', ['swiglu', 'gelu'])
def test_transformer_encoder(activation):
    rng = np.random.default_rng(4)
    dim, heads, ffn, layers = 128, 2, 160, 2
    b, s = 2, 20
    je = jattn.TransformerEncoder(layers, heads, dim, ffn, activation=activation,
                                  rope_dim=6, qk_norm=True)
    params = je.init(jax.random.key(2))
    te = _load(tattn.TransformerEncoder(layers, heads, dim, ffn, rope_dim=6,
                                        activation=activation, qk_norm=True), params)
    x = _inputs(rng, b, s, dim)
    mask = np.ones((b, s), bool)
    mask[1, -6:] = False
    pos = (rng.normal(size=(b, s, 9)) * 0.3).astype(np.float32)
    want = je(params, jnp.asarray(x), mask=jnp.asarray(mask),
              triangle_pos=jnp.asarray(pos), impl='xla')
    with torch.no_grad():
        got = te(_t(x), torch.from_numpy(mask), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOD_TOL)


def test_transformer_decoder_with_taps():
    rng = np.random.default_rng(5)
    dim, heads, ffn, ctx_dim, layers = 128, 2, 160, 96, 4
    b, bkv, s, sk = 4, 2, 16, 22
    jd = jattn.TransformerDecoder(layers, heads, dim, ffn, ctx_dim=ctx_dim,
                                  qk_norm=True, rope_dim=6)
    params = jd.init(jax.random.key(3))
    td = _load(tattn.TransformerDecoder(layers, heads, dim, ffn, ctx_dim=ctx_dim,
                                        rope_dim=6, qk_norm=True), params)
    x = _inputs(rng, b, s, dim)
    ctx = _inputs(rng, bkv, sk, ctx_dim)
    mask = np.ones((b, sk), bool)
    mask[:, -4:] = False
    tri_pos = (rng.normal(size=(b, sk, 9)) * 0.3).astype(np.float32)
    ray_pos = (rng.normal(size=(b, s, 9)) * 0.3).astype(np.float32)
    taps = (0, 2, 3)
    want, want_taps = jd(params, jnp.asarray(x), jnp.asarray(ctx), mask=jnp.asarray(mask),
                         triangle_pos=jnp.asarray(tri_pos), ray_pos=jnp.asarray(ray_pos),
                         out_layers=taps, impl='xla')
    with torch.no_grad():
        got, got_taps = td(_t(x), _t(ctx), torch.from_numpy(mask), _t(tri_pos),
                           _t(ray_pos), out_layers=taps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOD_TOL)
    assert len(got_taps) == len(want_taps) == 3
    for g, w in zip(got_taps, want_taps):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MOD_TOL)


def _flash_args(b=4, bkv=2, sq=8, sk=8, h=2, d=16):
    z = torch.zeros
    return [z(b, sq, h, d), z(b, sk, h, d), z(bkv, sk, h, d),
            torch.ones(b, sk, dtype=torch.bool), z(b, sq, d), z(b, sq, d)]


@pytest.mark.parametrize('bad', ['v_batch', 'mask_batch', 'cos_batch', 'k_batch',
                                 'strided_q', 'grad'])
def test_wrapper_checks_raise(bad):
    args = _flash_args()
    err = ValueError
    if bad == 'v_batch':
        args[2] = torch.zeros(3, 8, 2, 16)  # 3 does not divide 4
    elif bad == 'mask_batch':
        args[3] = torch.ones(2, 8, dtype=torch.bool)
    elif bad == 'cos_batch':
        args[4] = torch.zeros(2, 8, 16)
    elif bad == 'k_batch':
        args[1] = torch.zeros(2, 8, 2, 16)
    elif bad == 'strided_q':
        args[0] = torch.zeros(4, 2, 8, 16).transpose(1, 2)
    elif bad == 'grad':
        args[0].requires_grad_(True)
        err = RuntimeError
    with pytest.raises(err):
        flash_fwd_rope(*args)


def test_rot_kv_checks_raise():
    with pytest.raises(ValueError):  # k batch 3 does not divide table batch 4
        rot_kv_broadcast(torch.zeros(3, 8, 2, 16), torch.zeros(4, 8, 16),
                         torch.zeros(4, 8, 16))
    with pytest.raises(ValueError):  # table rows differ from k rows
        rot_kv_broadcast(torch.zeros(2, 8, 2, 16), torch.zeros(4, 9, 16),
                         torch.zeros(4, 9, 16))
