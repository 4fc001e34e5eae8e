"""Kernels K3 (the K broadcast-rotate), K5 (resize into space-to-depth
layout), K6 (Swin window attention), K7 (shifted-window regroup), the
forward's logsumexp (K1/K2), the flash backward (K8, K9; the bf16 kernel at
its tile edges), the transposed resize (K4^T), the flash
forward without RoPE (K10), the fp32 flash forward's key splits and tile
edges, and the fused RMSNorm (K11; its backward also at the nerf train
step's sites, call to call and in a CUDA graph) against their plain
versions on a CUDA card, at small sizes, and one tiny-config train step
through them.  They skip without one.  This file imports no JAX, so on
a machine with a card and no JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from renderformer_tpu_torch.ops import LAUNCHES, reference_kernels
from renderformer_tpu_torch.encodings.rope import make_cos_sin
from renderformer_tpu_torch.ops.flash_attention import (
    flash_bwd, flash_fwd, flash_fwd_rope, rot_kv_broadcast)
from renderformer_tpu_torch.ops.fused_norm import rms_norm_bwd, rms_norm_fwd
from renderformer_tpu_torch.ops.fused_resize import resize_bilinear, resize_bilinear_t, resize_s2d
from renderformer_tpu_torch.ops.shifted_regroup import shifted_regroup
from renderformer_tpu_torch.ops.swin_attention import region_table, swin_window_attention

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _randn(shape, dtype, dev, seed=0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).to(dev).to(dtype)


def _both(fn):
    """(kernel result, plain result, kernel launches)."""
    with torch.no_grad():
        before = dict(LAUNCHES)
        got = fn()
        torch.cuda.synchronize()
        launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
        with reference_kernels():
            want = fn()
    return got, want, launched


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
def test_resize_s2d_kernel_matches_plain(cuda, dtype):
    x = _randn((2, 12, 20, 64), dtype, cuda)
    got, want, launched = _both(lambda: resize_s2d(x, (24, 40)))
    assert launched == {'resize_s2d': 1}
    # the same fp32 lerps, rounded once: bit for bit
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,x_shape,out_hw', [
    (torch.bfloat16, (8, 256, 256, 128), (512, 512)),  # the renders' site
    (torch.float32, (1, 128, 128, 128), (256, 256)),   # the train step's site
    (torch.bfloat16, (1, 3, 5, 8), (2, 6)),            # OH 2: one s2d row; C 8
    (torch.float32, (2, 1, 4, 4), (4, 8)),             # IH 1; C 4 in fp32
    (torch.bfloat16, (3, 7, 9, 8), (10, 14)),          # B 3, downsampled H
    (torch.float32, (1, 9, 300, 4), (6, 1030)),        # a row of 515 pixels
    (torch.bfloat16, (2, 5, 7, 24), (6, 10)),          # a block of 252 threads (21 pixels)
    (torch.float32, (1, 4, 6, 512), (8, 12)),          # a block of 512 threads (1 pixel)
])
def test_resize_s2d_kernel_is_bit_exact_at_sites_and_edges(cuda, dtype, x_shape, out_hw):
    x = _randn(x_shape, dtype, cuda)
    got, want, launched = _both(lambda: resize_s2d(x, out_hw))
    assert launched == {'resize_s2d': 1}
    assert got.shape == (x_shape[0], out_hw[0] // 2, out_hw[1] // 2, 4 * x_shape[3])
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['resize_bilinear', 'resize_s2d', 'resize_bilinear_t'])
def test_resize_kernels_refuse_what_they_do_not_take(cuda, name):
    """K4, K5 and K4^T raise on a CUDA tensor they cannot take: no plain
    fallback."""
    fn = {'resize_bilinear': lambda x: resize_bilinear(x, (8, 8)),
          'resize_s2d': lambda x: resize_s2d(x, (8, 8)),
          'resize_bilinear_t': lambda x: resize_bilinear_t(x, (2, 2))}[name]
    bad = [_randn((1, 4, 4, 6), torch.float32, cuda),          # C * 4 bytes, not 16-byte vectors
           _randn((1, 4, 4, 8), torch.float16, cuda),          # no fp16 kernel
           _randn((1, 4, 4, 8), torch.float32, cuda).transpose(1, 2),  # not contiguous
           torch.zeros(129, device=cuda)[1:].view(1, 4, 4, 8),  # 4 bytes past 16-byte alignment
           _randn((4, 4, 8), torch.float32, cuda)]             # not [B, H, W, C]
    with torch.no_grad():
        for x in bad:
            with pytest.raises(ValueError):
                fn(x)
        assert fn(_randn((1, 4, 4, 8), torch.float32, cuda)).is_cuda


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('inverse', [False, True])
def test_regroup_kernel_matches_plain(cuda, dtype, inverse):
    x = _randn((2, 32 * 16, 256), dtype, cuda)
    got, want, launched = _both(lambda: shifted_regroup(x, (32, 16), 8, inverse=inverse))
    assert launched == {'shifted_regroup': 1}
    assert torch.equal(got, want)  # a permutation


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shift', [0, 4])
def test_swin_kernel_matches_plain(cuda, dtype, shift):
    h, w, b, c = 16, 24, 2, 256           # 6 windows a view, 2 heads of 128
    bw = b * (h // 8) * (w // 8)
    q, k, v = (_randn((bw, 64, c), dtype, cuda, seed=i) for i in range(3))
    regions = region_table(h, w, 8, shift, cuda) if shift else None
    got, want, launched = _both(
        lambda: swin_window_attention(q, k, v, num_heads=2, regions=regions))
    assert launched == {'swin_window_attention': 1}
    amax = float(want.float().abs().max())
    # bf16: q and P round in both, sums in another order: 4 ulps of max|ref|;
    # fp32: summation order, 2^-16 of max|ref|
    tol = amax * (4 * 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -16)
    assert float((got.float() - want.float()).abs().max()) <= tol


def _tables(b, s, dev, seed):
    pos = torch.from_numpy(np.random.default_rng(seed).normal(size=(b, s, 9)).astype(
        np.float32) * 0.3).to(dev)
    c, sn = make_cos_sin(pos, 12, 128)
    return c[:, :, 0].contiguous(), sn[:, :, 0].contiguous()


def _attn_tol(want, dtype, ulps=4):
    """bf16: q, P (and dS) round to bf16 in both at P values that differ in
    the last fp32 bits, and each output rounds once: ``ulps`` bf16 ulps of
    max|want|; fp32: sums in another order (atomics in a run-dependent one),
    2^-16 of max|want|."""
    amax = float(want.float().abs().max())
    return amax * (ulps * 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -16)


# b, bkv, sq, sk, h, masked: ragged tiles on both sides, a view fan-out
BWD_CASES = [(2, 1, 100, 70, 2, True), (1, 1, 64, 64, 1, False), (3, 3, 37, 130, 2, True)]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('case', range(len(BWD_CASES)))
def test_flash_lse_and_backward_kernels_match_plain(cuda, dtype, case):
    b, bkv, sq, sk, h, masked = BWD_CASES[case]
    d = 128
    q, do = (_randn((b, sq, h, d), dtype, cuda, seed=s) for s in (1, 2))
    k, v = (_randn((bkv, sk, h, d), dtype, cuda, seed=s) for s in (3, 4))
    mask = None
    if masked:
        mask = torch.from_numpy(np.random.default_rng(5).uniform(size=(b, sk)) > 0.3).to(cuda)
        mask[:, 0] = True
    cq, sq_ = _tables(b, sq, cuda, 6)
    ck, sk_ = _tables(b, sk, cuda, 7)
    with torch.no_grad():
        k_rot = rot_kv_broadcast(k, ck, sk_)
    got, want, launched = _both(lambda: flash_fwd_rope(q, k_rot, v, mask, cq, sq_,
                                                       with_lse=True))
    assert launched == {'flash_fwd_rope_mask' if masked else 'flash_fwd_rope_nomask': 1}
    assert float((got[0].float() - want[0].float()).abs().max()) <= _attn_tol(want[0], dtype)
    # m*ln2 + ln(l) in fp32: an online against a one-pass maximum and sum
    torch.testing.assert_close(got[1], want[1], atol=2e-5, rtol=1e-5)
    out, lse = want
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    for variant, names in (('fused', {'flash_bwd_mask' if masked else 'flash_bwd_nomask'}),
                           ('twokernel', {'flash_bwd_dq', 'flash_bwd_dkv'})):
        got, want, launched = _both(
            lambda: flash_bwd(q, k_rot, v, mask, lse, delta, do, variant))
        assert launched == {n: 1 for n in names}
        for name, gt, wt in zip('qkv', got, want):
            assert gt.dtype == dtype and gt.shape == wt.shape, name
            err = float((gt.float() - wt.float()).abs().max())
            assert err <= _attn_tol(wt, dtype, ulps=8), (variant, name, err)


# the bf16 backward (csrc/flash_bwd_sm90.cu) at its tile edges: b, bkv, sq,
# sk, h, mask; 2064 keys leave a 16-key last tile of 128, 129 and 1000 q rows
# ragged 64-row q steps; 'zero_row' masks random keys and all of batch row 1
BF16_BWD_EDGES = {
    'tail_129x2064': (1, 1, 129, 2064, 1, 'tail'),
    'tail_1000x2064_h6': (1, 1, 1000, 2064, 6, 'tail'),
    'reps4_tail_129x2064_h2': (4, 1, 129, 2064, 2, 'tail'),
    'zero_row_129x200_h2': (3, 3, 129, 200, 2, 'zero_row'),
    'unmasked_1000x1000': (1, 1, 1000, 1000, 1, None),
    'b8_h8_tail_1000x2064': (8, 8, 1000, 2064, 8, 'tail'),
}


@pytest.mark.cuda
@pytest.mark.parametrize('variant', ['fused', 'dkv'])
@pytest.mark.parametrize('case', sorted(BF16_BWD_EDGES))
def test_bf16_backward_kernel_at_tile_edges_matches_plain(cuda, case, variant):
    """K8 and K9's dK/dV kernel in bf16 against the plain backward, 8 bf16
    ulps of max|ref| per gradient (chip_smoke.py's bar)."""
    from renderformer_tpu_torch import _build
    from renderformer_tpu_torch.ops.flash_attention import fan_out, launch_flash_bwd
    b, bkv, sq, sk, h, mask_kind = BF16_BWD_EDGES[case]
    bf = torch.bfloat16
    q, do = (_randn((b, sq, h, 128), bf, cuda, seed=s) for s in (1, 2))
    k = _randn((b, sk, h, 128), bf, cuda, seed=3)
    v = _randn((bkv, sk, h, 128), bf, cuda, seed=4)
    mask = None
    if mask_kind == 'tail':
        mask = torch.ones(b, sk, dtype=torch.bool, device=cuda)
        mask[:, 1552:] = False
    elif mask_kind == 'zero_row':
        mask = torch.from_numpy(np.random.default_rng(5).uniform(size=(b, sk)) > 0.3).to(cuda)
        mask[:, 0] = True
        mask[1] = False
    with torch.no_grad():
        with reference_kernels():
            out, lse = flash_fwd(q, k, fan_out(v, b).contiguous(), mask, with_lse=True)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        io = (q, k, v, mask, lse, delta, do)
        with reference_kernels():
            want = flash_bwd(*io)
        got = launch_flash_bwd(_build.library(), variant, *io)
        torch.cuda.synchronize()
    for name, gt, wt in zip('qkv', got, want):
        if gt is None:
            continue
        assert gt.dtype == bf and gt.shape == wt.shape, name
        err = float((gt.float() - wt.float()).abs().max())
        assert err <= _attn_tol(wt, bf, ulps=8), (name, err)


# K3 at the model's head counts, with and without a view fan-out, at ragged
# key counts: b, bkv, sk, h, d; d 24 and 6 take the element-wise chunks
ROT_CASES = [(1, 1, 2064, 6, 128), (8, 1, 257, 6, 128), (8, 8, 129, 8, 128),
             (8, 1, 65, 8, 128), (2, 1, 33, 3, 24), (3, 3, 17, 2, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('case', range(len(ROT_CASES)))
def test_rot_kv_kernel_matches_plain(cuda, dtype, case):
    """K3 against its plain version: the same fp32 products and sum, one
    ulp of max|ref| for a product rounded to its other neighbour."""
    b, bkv, sk, h, d = ROT_CASES[case]
    k = _randn((bkv, sk, h, d), dtype, cuda, seed=1)
    theta = torch.from_numpy(np.random.default_rng(2).uniform(-np.pi, np.pi, size=(b, sk, d)))
    c, sn = (f(theta).float().to(cuda) for f in (torch.cos, torch.sin))
    got, want, launched = _both(lambda: rot_kv_broadcast(k, c, sn))
    assert launched == {'rot_kv_broadcast': 1}
    tol = float(want.float().abs().max()) * (2.0 ** -7 if dtype == torch.bfloat16
                                             else 2.0 ** -22)
    assert float((got.float() - want.float()).abs().max()) <= tol


# b, sq, sk, h, masked: ragged q and key tiles, a key count that is no tile
# multiple in the unmasked form
K10_CASES = [(2, 100, 70, 2, True), (1, 64, 64, 1, False), (3, 37, 130, 2, False),
             (1, 40, 2064, 1, True)]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('with_lse', [False, True])
@pytest.mark.parametrize('case', range(len(K10_CASES)))
def test_flash_fwd_kernel_matches_plain(cuda, dtype, with_lse, case):
    b, sq, sk, h, masked = K10_CASES[case]
    q = _randn((b, sq, h, 128), dtype, cuda, seed=1)
    k, v = (_randn((b, sk, h, 128), dtype, cuda, seed=s) for s in (2, 3))
    mask = None
    if masked:
        mask = torch.from_numpy(np.random.default_rng(4).uniform(size=(b, sk)) > 0.3).to(cuda)
        mask[:, 0] = True
    got, want, launched = _both(lambda: flash_fwd(q, k, v, mask, with_lse=with_lse))
    assert launched == {'flash_fwd_mask' if masked else 'flash_fwd_nomask': 1}
    out, ref = (got[0], want[0]) if with_lse else (got, want)
    assert float((out.float() - ref.float()).abs().max()) <= _attn_tol(ref, dtype)
    if with_lse:
        # m*ln2 + ln(l) in fp32: an online against a one-pass maximum and sum
        torch.testing.assert_close(got[1], want[1], atol=2e-5, rtol=1e-5)


# the bf16 Hopper forward's tile edges: b, bkv, sq, sk, h, masked; a masked
# case with b > 1 zeroes batch row 1's mask; h 8 at 2064 rows takes the
# 64-row plan on a 132-SM card, the rest the 128-row plan
TILE_CASES = [(2, 1, 129, 257, 2, True), (1, 1, 257, 129, 2, False), (3, 3, 1, 63, 1, True),
              (1, 1, 2064, 2064, 8, True)]


@pytest.mark.cuda
@pytest.mark.parametrize('rope', [True, False])
@pytest.mark.parametrize('with_lse', [False, True])
@pytest.mark.parametrize('case', range(len(TILE_CASES)))
def test_flash_fwd_bf16_tile_edges_match_plain(cuda, rope, with_lse, case):
    b, bkv, sq, sk, h, masked = TILE_CASES[case]
    dtype = torch.bfloat16
    q = _randn((b, sq, h, 128), dtype, cuda, seed=1)
    k, v = (_randn((bkv, sk, h, 128), dtype, cuda, seed=s) for s in (2, 3))
    mask, keep = None, list(range(b))
    if masked:
        mask = torch.from_numpy(np.random.default_rng(4).uniform(size=(b, sk)) > 0.3).to(cuda)
        mask[:, 0] = True
        if b > 1:
            mask[1] = False
            keep.remove(1)
    if rope:
        cq, sq_ = _tables(b, sq, cuda, 6)
        ck, sk_ = _tables(b, sk, cuda, 7)
        with torch.no_grad():
            k_rot = rot_kv_broadcast(k, ck, sk_)
        fn = lambda: flash_fwd_rope(q, k_rot, v, mask, cq, sq_, with_lse=with_lse)  # noqa: E731
        name = 'flash_fwd_rope_mask' if masked else 'flash_fwd_rope_nomask'
    else:
        kb, vb = (x.repeat_interleave(b // bkv, dim=0) for x in (k, v))
        fn = lambda: flash_fwd(q, kb, vb, mask, with_lse=with_lse)  # noqa: E731
        name = 'flash_fwd_mask' if masked else 'flash_fwd_nomask'
    got, want, launched = _both(fn)
    assert launched == {name: 1}
    out, ref = (got[0], want[0]) if with_lse else (got, want)
    # a fully masked row is uniform over its keys in both
    assert float((out.float() - ref.float()).abs().max()) <= _attn_tol(ref, dtype)
    if with_lse:
        # m*ln2 + ln(l) in fp32; a fully masked row's -1e30*ln2 + ln(Sk) to 1e-6
        torch.testing.assert_close(got[1][keep], want[1][keep], atol=2e-5, rtol=1e-5)
        torch.testing.assert_close(got[1], want[1], atol=0, rtol=1e-6)


# the fp32 forward's key splits and tile edges: b, bkv, sq, sk, h, masked; a
# masked case with b > 1 zeroes batch row 1's mask.  The train step's sites
# (1 x 1024 rays x 6 heads) split their keys across clusters of blocks on a
# 132-SM card; the others run one block a q tile
F32_CASES = [(1, 1, 1024, 2064, 6, True), (1, 1, 1024, 1024, 6, False),
             (8, 1, 129, 257, 2, True), (2, 2, 65, 63, 1, True), (1, 1, 1, 1, 1, False),
             (1, 1, 257, 4096, 1, False)]


@pytest.mark.cuda
@pytest.mark.parametrize('rope', [True, False])
@pytest.mark.parametrize('with_lse', [False, True])
@pytest.mark.parametrize('case', range(len(F32_CASES)))
def test_flash_fwd_fp32_splits_and_edges_match_plain(cuda, rope, with_lse, case):
    b, bkv, sq, sk, h, masked = F32_CASES[case]
    dtype = torch.float32
    q = _randn((b, sq, h, 128), dtype, cuda, seed=1)
    k, v = (_randn((bkv, sk, h, 128), dtype, cuda, seed=s) for s in (2, 3))
    mask, keep = None, list(range(b))
    if masked:
        mask = torch.from_numpy(np.random.default_rng(4).uniform(size=(b, sk)) > 0.3).to(cuda)
        mask[:, 0] = True
        if b > 1:
            mask[1] = False
            keep.remove(1)
    if rope:
        cq, sq_ = _tables(b, sq, cuda, 6)
        ck, sk_ = _tables(b, sk, cuda, 7)
        with torch.no_grad():
            k_rot = rot_kv_broadcast(k, ck, sk_)
        fn = lambda: flash_fwd_rope(q, k_rot, v, mask, cq, sq_, with_lse=with_lse)  # noqa: E731
        name = 'flash_fwd_rope_mask' if masked else 'flash_fwd_rope_nomask'
    else:
        kb, vb = (x.repeat_interleave(b // bkv, dim=0) for x in (k, v))
        fn = lambda: flash_fwd(q, kb, vb, mask, with_lse=with_lse)  # noqa: E731
        name = 'flash_fwd_mask' if masked else 'flash_fwd_nomask'
    got, want, launched = _both(fn)
    assert launched == {name: 1}
    out, ref = (got[0], want[0]) if with_lse else (got, want)
    # split TF32 against exact fp32; a fully masked row is uniform over its
    # keys in both, whatever the key split
    assert float((out - ref).abs().max()) <= _attn_tol(ref, dtype)
    if with_lse:
        torch.testing.assert_close(got[1][keep], want[1][keep], atol=2e-5, rtol=1e-5)
        torch.testing.assert_close(got[1], want[1], atol=0, rtol=1e-6)


def _ulp_tol(want, dtype):
    """One bf16 ulp of max|want| (2^-7 of its binade); fp32 2^-20 of it."""
    amax = float(want.float().abs().max())
    if dtype == torch.bfloat16:
        return 2.0 ** (np.floor(np.log2(amax)) - 7)
    return amax * 2.0 ** -20


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('rows,d', [(771, 128), (2064, 768), (256, 1024)])
def test_rms_norm_kernels_match_plain(cuda, dtype, rows, d):
    x = _randn((rows, d), dtype, cuda, seed=1) * 3
    scale = _randn((d,), torch.float32, cuda, seed=2)
    g = _randn((rows, d), dtype, cuda, seed=3)
    got, want, launched = _both(lambda: rms_norm_fwd(x, scale, 1e-6))
    assert launched == {'rms_norm_fwd': 1}
    # the same arithmetic; inv from sums in another order can round bf16(inv)
    # to the other neighbour
    assert float((got.float() - want.float()).abs().max()) <= _ulp_tol(want, dtype)
    got, want, launched = _both(lambda: rms_norm_bwd(x, scale, g, 1e-6))
    assert launched == {'rms_norm_bwd': 1}
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    assert float((got[0].float() - want[0].float()).abs().max()) <= _ulp_tol(want[0], dtype)
    # ds: per-block partials summed, against one sum over the rows
    assert float((got[1] - want[1]).abs().max()) <= 1e-5 * float(want[1].abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
def test_rms_norm_kernels_take_a_bf16_scale_as_its_fp32_cast(cuda, dtype):
    """The kernels widen a bf16 scale in registers: bit for bit the result
    of its fp32 cast."""
    x = _randn((2064, 768), dtype, cuda, seed=1) * 3
    g = _randn((2064, 768), dtype, cuda, seed=3)
    scale = _randn((768,), torch.bfloat16, cuda, seed=2)
    with torch.no_grad():
        assert torch.equal(rms_norm_fwd(x, scale, 1e-6), rms_norm_fwd(x, scale.float(), 1e-6))
        got, want = rms_norm_bwd(x, scale, g, 1e-6), rms_norm_bwd(x, scale.float(), g, 1e-6)
    # ds comes in the scale's dtype: the same fp32 sum, rounded once to bf16
    assert got[1].dtype == torch.bfloat16 and want[1].dtype == torch.float32
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1].bfloat16())


# the nerf train step's sites (R rows of 768), a row count one past a block's
# warps, one that is not a multiple of 8, and the render's largest site
NORM_ROWS = [2048, 2064, 1024, 257, 1000, 8 * 4096]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('rows', NORM_ROWS)
def test_rms_norm_bwd_kernel_matches_plain_at_sites(cuda, dtype, rows):
    """K11's backward with the scale in x's dtype, as the paths give it: dx
    within the forward's tolerance, ds (of the scale's fp32 cast, an fp32
    sum) within 1e-5 of max|ds|, and ds in the scale's dtype that sum
    rounded once."""
    x = _randn((rows, 768), dtype, cuda, seed=1) * 3
    scale = (1 + 0.1 * _randn((768,), torch.float32, cuda, seed=2)).to(dtype)
    g = _randn((rows, 768), dtype, cuda, seed=3)
    got, want, launched = _both(lambda: rms_norm_bwd(x, scale.float(), g, 1e-6))
    assert launched == {'rms_norm_bwd': 1}
    assert float((got[0].float() - want[0].float()).abs().max()) <= _ulp_tol(want[0], dtype)
    # ds: sums over warps, blocks and clusters, against one sum over the rows
    assert float((got[1] - want[1]).abs().max()) <= 1e-5 * float(want[1].abs().max())
    with torch.no_grad():
        dx, ds = rms_norm_bwd(x, scale, g, 1e-6)
    assert ds.dtype == dtype and torch.equal(ds, got[1].to(dtype)) and torch.equal(dx, got[0])


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
def test_rms_norm_bwd_kernel_is_one_deterministic_launch(cuda, dtype):
    """One launch a call, and two calls give the same bits in dx and ds."""
    x = _randn((2064, 768), dtype, cuda, seed=1)
    scale = _randn((768,), dtype, cuda, seed=2)
    g = _randn((2064, 768), dtype, cuda, seed=3)
    with torch.no_grad():
        before = LAUNCHES['rms_norm_bwd']
        a = rms_norm_bwd(x, scale, g, 1e-6)
        torch.cuda.synchronize()
        assert LAUNCHES['rms_norm_bwd'] == before + 1
        b = rms_norm_bwd(x, scale, g, 1e-6)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_rms_norm_bwd_kernel_refuses_rows_it_does_not_take(cuda):
    """The backward kernel takes rows of a multiple of 64 columns (its
    cluster's slices hold whole 16-byte chunks): it raises on 96, no plain
    fallback."""
    x = _randn((256, 96), torch.float32, cuda)
    with torch.no_grad(), pytest.raises(ValueError):
        rms_norm_bwd(x, _randn((96,), torch.float32, cuda), x, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize('warm_capture_stream', [True, False])
@pytest.mark.parametrize('d,dtype', [(768, torch.float32), (128, torch.bfloat16),
                                     (128, torch.float32)])
def test_rms_norm_bwd_kernel_in_a_cuda_graph(cuda, warm_capture_stream, d, dtype):
    """A CUDA graph of two calls, replayed three times, gives the eager
    calls' bits each time: captured on a stream that ran the kernel before,
    and as the usual idiom does, warmed up on a side stream and captured on
    ``torch.cuda.graph``'s own stream.  At D = 128 ds is as small as the
    kernel's other allocations of a call, so one block of the allocator
    given to two of them would show."""
    x = _randn((1024, d), dtype, cuda, seed=1)
    scale = _randn((d,), dtype, cuda, seed=2)
    g1 = _randn((1024, d), dtype, cuda, seed=3)
    g2 = _randn((1024, d), dtype, cuda, seed=4)
    with torch.no_grad():
        eager = [rms_norm_bwd(x, scale, g, 1e-6) for g in (g1, g2)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            rms_norm_bwd(x, scale, g1, 1e-6)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side if warm_capture_stream else None):
            outs = [rms_norm_bwd(x, scale, g, 1e-6) for g in (g1, g2)]
        for _ in range(3):
            for o in outs:
                o[0].zero_()
                o[1].zero_()
            graph.replay()
            torch.cuda.synchronize()
            for (dx, ds), (edx, eds) in zip(outs, eager):
                assert torch.equal(dx, edx) and torch.equal(ds, eds)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('in_hw,out_hw', [((16, 16), (32, 32)), ((12, 20), (23, 41))])
def test_resize_transposed_kernel_matches_plain(cuda, dtype, in_hw, out_hw):
    g = _randn((2, *out_hw, 64), dtype, cuda)
    got, want, launched = _both(lambda: resize_bilinear_t(g, in_hw))
    assert launched == {'resize_bilinear_t': 1}
    # the same nonzero products in fp32, summed in another order, rounded once
    tol = float(want.float().abs().max()) * (2.0 ** -8 if dtype == torch.bfloat16 else 1e-6)
    assert float((got.float() - want.float()).abs().max()) <= tol
    # and it is the VJP of K4 and K5
    x = _randn((2, *in_hw, 64), dtype, cuda).requires_grad_(True)
    y = resize_bilinear(x, out_hw)
    gx, = torch.autograd.grad(y, x, g)
    assert torch.equal(gx, got)


@pytest.mark.cuda
def test_tiny_train_step_on_the_card(cuda):
    """Two steps of the tiny config (head dim 128) through the kernels, fused
    and two-kernel backward, against the plain versions."""
    from renderformer_tpu_torch import RenderFormerConfig
    from renderformer_tpu_torch.models.renderformer import RenderFormer
    from renderformer_tpu_torch.nn.core import init_weights
    from renderformer_tpu_torch.training import state as ts

    cfg = RenderFormerConfig(latent_dim=256, num_layers=2, num_heads=2, dim_feedforward=256,
                             num_register_tokens=4, view_transformer_latent_dim=256,
                             view_transformer_ffn_hidden_dim=256, view_transformer_n_heads=2,
                             view_transformer_n_layers=4, dpt_features=128,
                             dpt_out_channels=[32, 64, 128, 128])
    rng = np.random.default_rng(0)
    n, res = 40, 64
    batch = {'triangles': rng.normal(size=(1, n, 3, 3)).astype(np.float32) * 0.3,
             'texture': rng.uniform(0, 1, (1, n, 13, 32, 32)).astype(np.float32),
             'mask': np.ones((1, n), bool), 'vn': rng.normal(size=(1, n, 3, 3)).astype(
                 np.float32),
             'c2w': np.tile(np.eye(4, dtype=np.float32), (1, 1, 1, 1)),
             'fov': np.full((1, 1, 1), 40.0, np.float32),
             'gt': rng.uniform(0, 1, (1, 1, res, res, 3)).astype(np.float32)}
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}
    results = {}
    for variant in ('fused', 'twokernel', 'plain'):
        model = init_weights(RenderFormer(cfg), torch.Generator().manual_seed(0)).to(cuda)
        tc = ts.TrainConfig(resolution=res, learning_rate=1e-4, remat=True,
                            flash_bwd='fused' if variant == 'plain' else variant)
        tx = ts.make_optimizer(tc)
        state = ts.TrainState.create(model, tx, tc)
        step, _ = ts.make_train_step(model, tx, tc)
        before = dict(LAUNCHES)
        if variant == 'plain':
            with reference_kernels():
                metrics = [step(state, batch)[1] for _ in range(2)]
        else:
            metrics = [step(state, batch)[1] for _ in range(2)]
        launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        if variant == 'fused':
            assert launched['flash_bwd_mask'] > 0 and launched['flash_bwd_dq'] == 0
        if variant == 'twokernel':
            assert launched['flash_bwd_dq'] > 0 and launched['flash_bwd_mask'] == 0
        if variant != 'plain':
            assert launched['resize_bilinear_t'] > 0
        assert all(np.isfinite(m['loss']) and np.isfinite(m['grad_norm']) for m in metrics)
        results[variant] = metrics
    for variant in ('fused', 'twokernel'):
        for got, want in zip(results[variant], results['plain']):
            # bf16 stage 1: the kernels and the plain versions round at other points
            assert got['loss'] == pytest.approx(want['loss'], rel=1e-2)
            assert got['grad_norm'] == pytest.approx(want['grad_norm'], rel=5e-2)
