"""The port's fused RMSNorm (kernel K11's plain versions and the autograd
Function around them) against the JAX package's Pallas kernels
``_fwd_kernel`` / ``_bwd_kernel`` in interpret mode on the CPU, as
``tests/test_fused_norm.py`` runs them: forward, dx and ds, in fp32 and
bf16, at row counts that fill a block and that do not, with both eps values
of the model's norms; the backward at each (x, scale) dtype pair, with ds
in the scale's dtype; the backward kernel's grid plan; and the port's shape
gate against the JAX one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderformer_tpu.ops.fused_norm import fused_rms_norm as jax_fused
from renderformer_tpu.ops.fused_norm import fused_rms_norm_supported as jax_supported
from renderformer_tpu_torch.nn.core import ATTN_EPS, TORCH_DEFAULT_RMS_EPS, RMSNorm
from renderformer_tpu_torch.ops.fused_norm import (
    BLOCK_WARPS, CLUSTER, bwd_plan, fused_rms_norm, fused_rms_norm_supported, rms_norm_bwd,
    rms_norm_fwd, rms_norm_fwd_plain)
from test_torch_attention import DTYPES

SHAPES = [(2, 256, 128), (4, 96, 256), (771, 128)]  # 512 and 384 rows; 771 pads in JAX
EPS = {'attn': ATTN_EPS, 'torch_default': TORCH_DEFAULT_RMS_EPS}


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 3.0).astype(np.float32)
    scale = rng.normal(size=shape[-1:]).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    return x, scale, g


def _bf16_ulp(a):
    """One bf16 ulp of each element of ``a`` (2^-7 of its binade)."""
    a = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize('eps', sorted(EPS))
@pytest.mark.parametrize('precision', ['fp32', 'bf16'])
@pytest.mark.parametrize('shape', SHAPES)
def test_plain_forward_matches_jax_kernel(shape, precision, eps):
    jdt, tdt = DTYPES[precision]
    x, scale, _ = _inputs(shape, 0)
    want = np.asarray(jax_fused(jnp.asarray(x, jdt), jnp.asarray(scale), EPS[eps],
                                interpret=True).astype(jnp.float32))
    got = fused_rms_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(scale), EPS[eps])
    assert got.dtype == tdt and got.shape == x.shape
    got = got.float().numpy()
    if precision == 'fp32':
        # the same fp32 ops; the sum of squares in another order
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    else:
        # both round x*bf16(inv) and then *bf16(s) to bf16; inv from sums in
        # another order can round to the other bf16 neighbour: 1 ulp
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()


@pytest.mark.parametrize('eps', sorted(EPS))
@pytest.mark.parametrize('precision', ['fp32', 'bf16'])
@pytest.mark.parametrize('shape', SHAPES)
def test_autograd_matches_jax_vjp(shape, precision, eps):
    """dx and ds of the autograd Function (K11's plain backward) against
    jax.vjp of the interpret-mode kernel; ds comes back in the scale's
    dtype (the scale in the compute dtype, as under a train step)."""
    jdt, tdt = DTYPES[precision]
    x, scale, g = _inputs(shape, 1)
    _, vjp = jax.vjp(lambda a, s: jax_fused(a, s, EPS[eps], interpret=True),
                     jnp.asarray(x, jdt), jnp.asarray(scale, jdt))
    want_dx, want_ds = (np.asarray(w.astype(jnp.float32)) for w in vjp(jnp.asarray(g, jdt)))
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    ts = torch.from_numpy(scale).to(tdt).requires_grad_(True)
    y = fused_rms_norm(tx, ts, EPS[eps])
    dx, ds = torch.autograd.grad(y, (tx, ts), torch.from_numpy(g).to(tdt))
    assert dx.dtype == tdt and ds.dtype == tdt
    dx, ds = dx.float().numpy(), ds.float().numpy()
    if precision == 'fp32':
        # fp32 in both; row sums and the ds sum over rows in another order
        np.testing.assert_allclose(dx, want_dx, atol=1e-5 * np.abs(want_dx).max(), rtol=1e-5)
        np.testing.assert_allclose(ds, want_ds, atol=1e-5 * np.abs(want_ds).max(), rtol=1e-5)
    else:
        # fp32 arithmetic rounded once to bf16 in both; a sum in another order
        # can land on the other bf16 neighbour: 1 ulp
        assert (np.abs(dx - want_dx) <= _bf16_ulp(want_dx)).all()
        assert (np.abs(ds - want_ds) <= _bf16_ulp(want_ds)).all()


DTYPE_PAIRS = [('fp32', 'fp32'), ('fp32', 'bf16'), ('bf16', 'fp32'), ('bf16', 'bf16')]


@pytest.mark.parametrize('x_prec,scale_prec', DTYPE_PAIRS)
@pytest.mark.parametrize('rows', [256, 1000, 2064])
def test_backward_matches_jax_vjp_at_each_dtype_pair(rows, x_prec, scale_prec):
    """K11's backward (its plain version, the CPU path of ``rms_norm_bwd``)
    returns ds in the scale's dtype, as ``jax.vjp`` of the interpret-mode
    kernel does, at every (x, scale) dtype pair; 1000 rows are no multiple
    of a block's 8 warps."""
    (jdt, tdt), (jsdt, tsdt) = DTYPES[x_prec], DTYPES[scale_prec]
    x, scale, g = _inputs((rows, 256), 3)
    _, vjp = jax.vjp(lambda a, s: jax_fused(a, s, ATTN_EPS, interpret=True),
                     jnp.asarray(x, jdt), jnp.asarray(scale, jsdt))
    want_dx, want_ds = (np.asarray(w.astype(jnp.float32)) for w in vjp(jnp.asarray(g, jdt)))
    dx, ds = rms_norm_bwd(torch.from_numpy(x).to(tdt), torch.from_numpy(scale).to(tsdt),
                          torch.from_numpy(g).to(tdt), ATTN_EPS)
    assert dx.dtype == tdt and ds.dtype == tsdt and ds.shape == (256,)
    dx, ds = dx.float().numpy(), ds.float().numpy()
    # fp32: sums in another order, 1e-5 of max|want|; bf16: rounded once,
    # which can land on the other neighbour, 1 ulp of each ds element and
    # (chip_smoke.py's bar) of max|dx|: dx = gs*inv - x*coef cancels, so a
    # dx near zero keeps the fp32 error of its two terms
    for got, want, prec in ((dx, want_dx, x_prec), (ds, want_ds, scale_prec)):
        if prec == 'fp32':
            np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=1e-5)
        elif got is dx:
            assert np.abs(got - want).max() <= _bf16_ulp(np.abs(want).max())
        else:
            assert (np.abs(got - want) <= _bf16_ulp(want)).all()


# the nerf train step's K11 sites (embed, stage 1, rays, tris), the renders'
# largest, and small row counts
PLAN_ROWS = [2048, 2064, 1024, 8 * 4096, 1, 7, 257, 1000]


def _rows_taken(r, blocks, per_block):
    """{(block, warp): rows} as the backward kernel's row loop takes them:
    block b's rows [b * per_block, (b + 1) * per_block), every 8th for a
    warp (csrc/fused_norm.cu)."""
    return {(b, w): list(range(b * per_block + w, min(r, (b + 1) * per_block), BLOCK_WARPS))
            for b in range(blocks) for w in range(BLOCK_WARPS)}


@pytest.mark.parametrize('capacity', [8, 128, 264])
@pytest.mark.parametrize('rows', PLAN_ROWS)
def test_backward_plan_covers_every_row_once(rows, capacity):
    """The backward kernel's grid: whole clusters of at most ``capacity``
    blocks; every row taken by one warp exactly once; the blocks with no
    row, which add zeros to ds, are fewer than a cluster and all in the
    last one."""
    blocks, per_block = bwd_plan(rows, capacity)
    assert blocks % CLUSTER == 0 and CLUSTER <= blocks <= capacity
    taken = _rows_taken(rows, blocks, per_block)
    assert len(taken) == blocks * BLOCK_WARPS
    flat = sorted(r for rs in taken.values() for r in rs)
    assert flat == list(range(rows))
    idle = [b for b in range(blocks) if not any(taken[b, w] for w in range(BLOCK_WARPS))]
    assert len(idle) < CLUSTER and all(b >= blocks - CLUSTER for b in idle)
    # no block takes more than its share of the card's
    assert per_block == -(-rows // min(capacity, -(-rows // BLOCK_WARPS)))


def test_backward_plan_refuses_a_capacity_off_the_clusters():
    with pytest.raises(ValueError):
        bwd_plan(2064, 132)
    with pytest.raises(ValueError):
        bwd_plan(0, 128)


@pytest.mark.parametrize('shape', [(4, 256, 768), (2, 16, 768), (4, 100), (300, 128),
                                   (255, 256), (768,), (3, 86, 1024)])
@pytest.mark.parametrize('scale_len', ['match', 'mismatch'])
def test_gate_agrees_with_jax(shape, scale_len):
    d = shape[-1] + (0 if scale_len == 'match' else 1)
    want = jax_supported(jnp.zeros(shape), jnp.ones((d,)))
    assert fused_rms_norm_supported(torch.zeros(shape), torch.ones(d)) == want


@pytest.mark.parametrize('precision', ['fp32', 'bf16'])
def test_fused_module_equals_torch_op_norm(precision):
    """RMSNorm with ``fused`` set takes K11 (its plain version on the CPU),
    whose arithmetic is the torch-op norm's: bit for bit; below the gate it
    keeps the torch-op norm."""
    _, tdt = DTYPES[precision]
    x, scale, _ = _inputs((3, 100, 256), 2)
    norm = RMSNorm(256, ATTN_EPS)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
    norm = norm.to(tdt)
    tx = torch.from_numpy(x).to(tdt)
    with torch.no_grad():
        want = norm(tx)
        norm.fused = True
        assert torch.equal(norm(tx), want)
        assert torch.equal(rms_norm_fwd_plain(tx.reshape(-1, 256), norm.weight, ATTN_EPS),
                           want.reshape(-1, 256))


def test_wrappers_check_shapes():
    z = torch.zeros
    with pytest.raises(ValueError):  # 3-D input to the [R, D] wrapper
        rms_norm_fwd(z(2, 4, 8), z(8), 1e-6)
    with pytest.raises(ValueError):  # scale length
        rms_norm_fwd(z(4, 8), z(7), 1e-6)
    with pytest.raises(ValueError):  # cotangent shape
        rms_norm_bwd(z(4, 8), z(8), z(4, 9), 1e-6)
    with pytest.raises(RuntimeError):  # a forward kernel alone under autograd
        rms_norm_fwd(z(4, 8, requires_grad=True), z(8), 1e-6)
