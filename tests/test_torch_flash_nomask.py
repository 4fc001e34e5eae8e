"""The port's flash attention without RoPE (kernel K10's plain version, and
its autograd Function around the plain backward of K8/K9) against the JAX
package on the CPU: the forward and its logsumexp against the Pallas kernels
``_fwd_kernel`` / ``_fwd_kernel_nomask`` in interpret mode (``_flash_fwd`` and
``flash_attention`` with 64-row and 64-key blocks), and the gradients
against ``jax.vjp`` of that ``flash_attention``, whose backward runs K8 or K9
in interpret mode.  Query and key counts are not multiples of 64; the JAX
package pads the keys to its block and forces its masked kernel, the port's
unmasked form masks the ragged tile by bounds.  The attention modules built
without RoPE, which hold K10, against the JAX modules at ``impl='xla'``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderformer_tpu.nn import attention as jattn
from renderformer_tpu.ops.flash_attention import _flash_fwd
from renderformer_tpu.ops.flash_attention import flash_attention as jax_flash
from renderformer_tpu_torch.nn import attention as tattn
from renderformer_tpu_torch.ops.flash_attention import (
    flash_attention, flash_backward, flash_fwd, flash_fwd_plain)
from test_torch_attention import DTYPES, MOD_TOL, _attn_tol, _inputs as _acts, _load, _t
from test_torch_flash_bwd import _grad_tol, _jax_lse

BQ = BK = 64

# b, sq, sk, h, d, masked
CASES = {
    'masked_self_ragged': (2, 100, 100, 2, 128, True),
    'masked_cross_d64': (1, 70, 130, 2, 64, True),
    'unmasked_self_tiles': (1, 128, 128, 3, 64, False),
    'unmasked_cross_odd_sk': (2, 90, 75, 2, 128, False),
    'unmasked_sk2064': (1, 64, 2064, 1, 128, False),
    'masked_sk2064': (1, 40, 2064, 1, 64, True),
}


def _inputs(case, seed=0):
    b, sq, sk, h, d, masked = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, h, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, h, d)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.uniform(size=(b, sk)) > 0.3
        mask[:, 0] = True
    g = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    return q, k, v, mask, g


@pytest.mark.parametrize('precision', ['fp32', 'bf16'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_forward_matches_jax_kernel(case, precision):
    jdt, tdt = DTYPES[precision]
    q, k, v, mask, _ = _inputs(case)
    b, sq, h, _ = q.shape
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    jmask = None if mask is None else jnp.asarray(mask)
    want = np.asarray(jax_flash(jq, jk, jv, jmask, bq=BQ, bk=BK, interpret=True)
                      .astype(jnp.float32))
    _, want_lse = _flash_fwd(jq, jk, jv, jmask, bq=BQ, bk=BK, interpret=True, with_lse=True)
    want_lse = _jax_lse(want_lse, b, sq, h)
    tmask = None if mask is None else torch.from_numpy(mask)
    with torch.no_grad():
        got, got_lse = flash_fwd(_t(q, tdt), _t(k, tdt), _t(v, tdt), tmask, with_lse=True)
        assert torch.equal(flash_fwd(_t(q, tdt), _t(k, tdt), _t(v, tdt), tmask), got)
    assert got.dtype == tdt and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), want, **_attn_tol(precision, want))
    assert got_lse.dtype == torch.float32 and tuple(got_lse.shape) == (b, h, sq)
    # m*ln2 + ln(l) in fp32: an online against a one-pass maximum and sum
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize('variant', ['fused', 'twokernel'])
@pytest.mark.parametrize('precision', ['fp32', 'bf16'])
@pytest.mark.parametrize('case', ['masked_self_ragged', 'masked_cross_d64',
                                  'unmasked_cross_odd_sk', 'unmasked_self_tiles'])
def test_autograd_matches_jax_vjp(case, precision, variant, monkeypatch):
    """The JAX package picks K8 or K9 by RFTPU_FUSED_BWD, the port by
    flash_backward; on the CPU both run the plain backward."""
    jdt, tdt = DTYPES[precision]
    q, k, v, mask, g = _inputs(case, seed=1)
    jmask = None if mask is None else jnp.asarray(mask)
    monkeypatch.setenv('RFTPU_FUSED_BWD', '1' if variant == 'fused' else '0')

    def f(q_, k_, v_):
        return jax_flash(q_, k_, v_, jmask, bq=BQ, bk=BK, interpret=True)

    _, vjp = jax.vjp(f, *(jnp.asarray(x, jdt) for x in (q, k, v)))
    wants = [np.asarray(w.astype(jnp.float32)) for w in vjp(jnp.asarray(g, jdt))]

    tq, tk, tv = (_t(x, tdt).requires_grad_(True) for x in (q, k, v))
    with flash_backward(variant):
        out = flash_attention(tq, tk, tv, None if mask is None else torch.from_numpy(mask))
        gots = torch.autograd.grad(out, (tq, tk, tv), _t(g, tdt))
    for name, got, want, x in zip('qkv', gots, wants, (tq, tk, tv)):
        assert got.dtype == tdt and got.shape == x.shape, name
        np.testing.assert_allclose(got.float().numpy(), want, err_msg=f'd{name}',
                                   **_grad_tol(precision, want))


def test_plain_is_the_rope_free_function():
    """K10's plain version is softmax(q k^T / sqrt(D)) v in fp32, the
    -1e30 bias giving masked keys no weight."""
    q, k, v, mask, _ = _inputs('masked_cross_d64', seed=2)
    tq, tk, tv = _t(q), _t(k), _t(v)
    tm = torch.from_numpy(mask)
    got, _ = flash_fwd_plain(tq, tk, tv, tm)
    want = torch.nn.functional.scaled_dot_product_attention(
        tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
        attn_mask=tm[:, None, None, :]).transpose(1, 2)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)  # summation order


@pytest.mark.parametrize('bad', ['kv_batch', 'v_len', 'mask_batch', 'strided_q', 'grad'])
def test_wrapper_checks_raise(bad):
    z = torch.zeros
    args = [z(4, 8, 2, 16), z(4, 6, 2, 16), z(4, 6, 2, 16), torch.ones(4, 6, dtype=torch.bool)]
    err = ValueError
    if bad == 'kv_batch':  # K10 takes k and v at the q batch
        args[1], args[2] = z(2, 6, 2, 16), z(2, 6, 2, 16)
    elif bad == 'v_len':
        args[2] = z(4, 7, 2, 16)
    elif bad == 'mask_batch':
        args[3] = torch.ones(2, 6, dtype=torch.bool)
    elif bad == 'strided_q':
        args[0] = z(4, 2, 8, 16).transpose(1, 2)
    elif bad == 'grad':
        args[0].requires_grad_(True)
        err = RuntimeError
    with pytest.raises(err):
        flash_fwd(*args)


@pytest.mark.parametrize('cross', [False, True])
def test_multihead_attention_without_rope(cross):
    """Cross attention at a context batch that divides the query batch: the
    port fans K/V out to the query batch, as the JAX ``bcast_kv``."""
    rng = np.random.default_rng(3)
    dim, heads, ctx_dim = 128, 2, 96
    b, bkv, sq, sk = 4, (2 if cross else 4), 24, (40 if cross else 24)
    jm = jattn.MultiHeadAttention(dim, heads, kv_dim=ctx_dim if cross else None, qk_norm=True)
    params = jm.init(jax.random.key(0))
    tm = _load(tattn.MultiHeadAttention(dim, heads, ctx_dim if cross else None, qk_norm=True),
               params)
    x = _acts(rng, b, sq, dim)
    kv = _acts(rng, bkv, sk, ctx_dim) if cross else x
    mask = rng.uniform(size=(b, sk)) > 0.2
    mask[:, 0] = True
    want = jm(params, jnp.asarray(x), jnp.asarray(kv), jnp.asarray(kv), jnp.asarray(mask),
              impl='xla')
    with torch.no_grad():
        got = tm(_t(x), _t(kv), _t(kv), torch.from_numpy(mask), None, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOD_TOL)


def test_encoder_and_decoder_without_rope():
    rng = np.random.default_rng(4)
    dim, heads, ffn, ctx_dim = 128, 2, 160, 96
    je = jattn.TransformerEncoder(2, heads, dim, ffn, qk_norm=True)
    jd = jattn.TransformerDecoder(3, heads, dim, ffn, ctx_dim=ctx_dim, qk_norm=True)
    pe, pd = je.init(jax.random.key(1)), jd.init(jax.random.key(2))
    assert 'rope_freqs' not in pe and 'rope_freqs' not in pd
    te = _load(tattn.TransformerEncoder(2, heads, dim, ffn, rope_dim=None, qk_norm=True), pe)
    td = _load(tattn.TransformerDecoder(3, heads, dim, ffn, ctx_dim=ctx_dim, rope_dim=None,
                                        qk_norm=True), pd)
    assert te.rope_emb is None and td.rope_emb is None
    x, ctx = _acts(rng, 2, 20, dim), _acts(rng, 2, 22, ctx_dim)
    mask = np.ones((2, 22), bool)
    mask[1, -6:] = False
    self_mask = np.ascontiguousarray(mask[:, :20])
    want = je(pe, jnp.asarray(x), mask=jnp.asarray(self_mask), impl='xla')
    want_d, want_taps = jd(pd, jnp.asarray(x), jnp.asarray(ctx), mask=jnp.asarray(mask),
                           out_layers=(1, 2), impl='xla')
    with torch.no_grad():
        got = te(_t(x), torch.from_numpy(self_mask), None)
        got_d, got_taps = td(_t(x), _t(ctx), torch.from_numpy(mask), None, None,
                             out_layers=(1, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOD_TOL)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **MOD_TOL)
    for g, w in zip(got_taps, want_taps):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MOD_TOL)
