"""The plain versions of the flash forward, ``flash_fwd_rope_plain`` (K1/K2,
q rotated in the prologue) and ``flash_fwd_plain`` (K10), at the tile edges
of the bf16 Hopper kernel (``csrc/flash_fwd_sm90.cu``: 64- and 128-row q
tiles, 64- and 128-key tiles), against the JAX package's Pallas kernels in
interpret mode (``_flash_fwd_rope`` and ``_flash_fwd`` with 64-row and
64-key blocks) on the CPU.  On the card ``chip_smoke.py`` holds the kernel
against these plain versions at the same kinds of edges.

Query and key counts come from {1, 63, 65, 127, 129, 257}: masked and
unmasked, with a view fan-out (reps > 1), and with a batch row whose mask is
all zero.  Output and logsumexp come from one call of each side; the
wrappers without the logsumexp must return the same output.

A fully masked row is uniform over the real keys in the port (-1e30 on
masked keys, -inf past Sk).  The JAX package pads the keys to its block and
masks the padding with -1e30 too, so its fully masked row is uniform over
the padded count and reads sum(v) / Sk_padded.  That row is held to the
port's own semantics, and JAX's reading is checked against the padded count
so that the difference stays explained.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderformer_tpu.ops.flash_attention import _flash_fwd, _flash_fwd_rope
from renderformer_tpu_torch.ops.flash_attention import (
    LN2, flash_fwd, flash_fwd_rope, rot_kv_broadcast)
from test_torch_attention import DTYPES, _attn_tol, _t, _tables
from test_torch_flash_bwd import _jax_lse

BQ = BK = 64
D = 128

# b, bkv, sq, sk, h, masked, whether batch row 1 is fully masked
CASES = {
    'sq1_sk1': (1, 1, 1, 1, 1, False, False),
    'sq63_sk65_masked': (1, 1, 63, 65, 2, True, False),
    'sq65_sk63_reps2_full_row': (2, 1, 65, 63, 1, True, True),
    'sq127_sk129': (1, 1, 127, 129, 1, False, False),
    'sq129_sk127_full_row': (2, 2, 129, 127, 1, True, True),
    'sq257_sk129_reps2_masked': (2, 1, 257, 129, 1, True, False),
    'sq129_sk257': (1, 1, 129, 257, 1, False, False),
    'sq1_sk257_reps3_full_row': (3, 1, 1, 257, 1, True, True),
}


def _inputs(case, seed=0):
    b, bkv, sq, sk, h, masked, full_row = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, D)).astype(np.float32)
    k = rng.normal(size=(bkv, sk, h, D)).astype(np.float32)
    v = rng.normal(size=(bkv, sk, h, D)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.uniform(size=(b, sk)) > 0.3
        mask[:, 0] = True
        if full_row:
            mask[1] = False
    tabs = _tables(rng, b, sq, D) + _tables(rng, b, sk, D)
    return q, k, v, mask, tabs


def _run_jax(kind, q, k, v, mask, tabs, jdt):
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    jmask = None if mask is None else jnp.asarray(mask)
    if kind == 'rope':
        out, lse = _flash_fwd_rope(jq, jk, jv, jmask, *[jnp.asarray(t) for t in tabs],
                                   bq=BQ, bk=BK, interpret=True, with_lse=True)
    else:
        out, lse = _flash_fwd(jq, jk, jv, jmask, bq=BQ, bk=BK, interpret=True, with_lse=True)
    b, sq, h, _ = q.shape
    return np.asarray(out.astype(jnp.float32)), _jax_lse(lse, b, sq, h)


def _run_port(kind, q, k, v, mask, tabs, tdt):
    tmask = None if mask is None else torch.from_numpy(mask)
    with torch.no_grad():
        if kind == 'rope':
            cq, sq_, ck, sk_ = (_t(t) for t in tabs)
            k_rot = rot_kv_broadcast(_t(k, tdt), ck, sk_)
            args = (_t(q, tdt), k_rot, _t(v, tdt), tmask, cq, sq_)
            out, lse = flash_fwd_rope(*args, with_lse=True)
            assert torch.equal(flash_fwd_rope(*args), out)
        else:
            args = (_t(q, tdt), _t(k, tdt), _t(v, tdt), tmask)
            out, lse = flash_fwd(*args, with_lse=True)
            assert torch.equal(flash_fwd(*args), out)
    return out, lse


@pytest.mark.parametrize('precision', ['fp32', 'bf16'])
@pytest.mark.parametrize('kind', ['rope', 'nomask_kernel_k10'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_forward_at_tile_edges_matches_jax_kernel(case, kind, precision):
    jdt, tdt = DTYPES[precision]
    b, bkv, sq, sk, h, masked, full_row = CASES[case]
    q, k, v, mask, tabs = _inputs(case)
    if kind != 'rope':
        # K10 takes k and v at the q batch: the fan-out written out
        k, v = (np.repeat(x, b // bkv, axis=0) for x in (k, v))
    want, want_lse = _run_jax(kind, q, k, v, mask, tabs, jdt)
    got, got_lse = _run_port(kind, q, k, v, mask, tabs, tdt)
    assert got.dtype == tdt and got.shape == q.shape
    assert got_lse.dtype == torch.float32 and tuple(got_lse.shape) == (b, h, sq)
    got, got_lse = got.float().numpy(), got_lse.numpy()

    rows = [i for i in range(b) if not (full_row and i == 1)]
    np.testing.assert_allclose(got[rows], want[rows], **_attn_tol(precision, want[rows]))
    # m*ln2 + ln(l) in fp32: an online against a one-pass maximum and sum
    np.testing.assert_allclose(got_lse[rows], want_lse[rows], atol=2e-5, rtol=1e-5)
    if not full_row:
        return

    # the fully masked row: P = 1 on every real key, out = mean(v) over Sk,
    # cast; lse = -1e30 * ln2 + ln(Sk)
    vb = _t(v, tdt).float().numpy()[1 // (b // v.shape[0])].astype(np.float64)
    mean = vb.mean(axis=0)  # [h, D]
    one_ulp = 2.0 ** -8 * np.abs(mean).max() if precision == 'bf16' else 1e-6
    np.testing.assert_allclose(got[1], np.broadcast_to(mean, got[1].shape), atol=one_ulp,
                               rtol=0)
    np.testing.assert_allclose(got_lse[1], -1e30 * LN2 + np.log(sk), rtol=1e-6)
    sk_p = -(-sk // BK) * BK
    np.testing.assert_allclose(want[1], np.broadcast_to(mean * sk / sk_p, want[1].shape),
                               atol=one_ulp, rtol=0)
