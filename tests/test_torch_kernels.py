"""Kernels K3 (the K broadcast-rotate), K4 (the bilinear resize, bit for
bit at its sites and edges), K5 (resize into space-to-depth layout), K6
(Swin window attention) and its backward K6^T (deterministic; in fp32 also
at the edges of their persistent grids), K7
(shifted-window regroup) and its VJP, the forward's
logsumexp (K1/K2), the flash backward (K8, K9; the bf16 kernel at its tile
edges; K9's dQ kernel at the train step's sites, its tile edges and view
fan-outs, one deterministic launch a call and in a CUDA graph), the
transposed resize (K4^T, also on g in space-to-depth layout, deterministic
and one kernel in K5's backward), the flash forward without RoPE (K10), the
fp32 flash forward's key splits and tile edges, and the fused RMSNorm (K11;
its backward also at the nerf train step's sites, call to call and in a
CUDA graph) against their plain versions on a CUDA card, at small sizes,
one tiny-config train step through them, and a tiny Swin train step under
``deterministic=True``, the same bits in two runs.  They skip without one.  This
file imports no JAX, so on a machine with a card and no JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import re

import numpy as np
import pytest
import torch

from renderformer_tpu_torch.ops import LAUNCHES, reference_kernels
from renderformer_tpu_torch.encodings.rope import make_cos_sin
from renderformer_tpu_torch.ops.flash_attention import (
    flash_bwd, flash_fwd, flash_fwd_rope, rot_kv_broadcast)
from renderformer_tpu_torch.ops.fused_norm import rms_norm_bwd, rms_norm_fwd
from renderformer_tpu_torch.ops.fused_resize import (
    resize_bilinear, resize_bilinear_plain, resize_bilinear_t, resize_s2d, resize_s2d_t)
from renderformer_tpu_torch.ops.s2d_conv import depth_to_space, space_to_depth
from renderformer_tpu_torch.ops.shifted_regroup import shifted_regroup
from renderformer_tpu_torch.ops.swin_attention import (
    region_table, swin_window_attention, swin_window_attention_bwd)

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
@pytest.mark.parametrize('dtype,x_shape,out_hw', [
    (torch.bfloat16, (8, 32, 32, 128), (64, 64)),      # the renders' three sites
    (torch.bfloat16, (8, 64, 64, 128), (128, 128)),
    (torch.bfloat16, (8, 128, 128, 128), (256, 256)),  # streaming stores
    (torch.float32, (1, 16, 16, 128), (32, 32)),       # the train step's three sites
    (torch.float32, (1, 32, 32, 128), (64, 64)),
    (torch.float32, (1, 64, 64, 128), (128, 128)),
    (torch.float32, (2, 1, 4, 4), (4, 8)),             # IH 1; C 4 in fp32
    (torch.bfloat16, (1, 5, 7, 8), (6, 1)),            # OW 1; C 8 in bf16
    (torch.bfloat16, (3, 9, 11, 16), (5, 6)),          # B 3, downsampled
    (torch.float32, (1, 9, 300, 4), (6, 2060)),        # a row of more than one block
    (torch.bfloat16, (2, 5, 7, 24), (6, 10)),          # a block of 255 threads (85 pixels)
    (torch.float32, (1, 4, 6, 2048), (8, 12)),         # a block of 512 threads (1 pixel)
])
def test_resize_kernel_is_bit_exact_at_sites_and_edges(cuda, dtype, x_shape, out_hw):
    """K4 is the plain resize in fp32 rounded once to x's dtype, bit for bit,
    in one launch."""
    x = _randn(x_shape, dtype, cuda)
    with torch.no_grad():
        before = LAUNCHES['resize_bilinear']
        got = resize_bilinear(x, out_hw)
        torch.cuda.synchronize()
        assert LAUNCHES['resize_bilinear'] == before + 1
        want = resize_bilinear_plain(x.float(), out_hw).to(dtype)
    assert got.shape == (x_shape[0], *out_hw, x_shape[3])
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,x_shape,out_hw', [
    (torch.bfloat16, (8, 256, 256, 128), (512, 512)),  # K5's two sites
    (torch.float32, (1, 128, 128, 128), (256, 256)),
    (torch.bfloat16, (3, 7, 9, 8), (10, 14)),
])
def test_resize_s2d_is_resize_then_space_to_depth(cuda, dtype, x_shape, out_hw):
    """depth_to_space of K5's output is K4's output, bit for bit."""
    x = _randn(x_shape, dtype, cuda)
    with torch.no_grad():
        assert torch.equal(depth_to_space(resize_s2d(x, out_hw)), resize_bilinear(x, out_hw))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,in_hw,out_hw,c', [
    (torch.float32, (128, 128), (256, 256), 128),      # the train step's s2d site
    (torch.bfloat16, (128, 128), (256, 256), 128),
    (torch.float32, (12, 20), (24, 42), 4),            # C 4 fp32
    (torch.bfloat16, (7, 9), (10, 14), 8),             # C 8 bf16, downsampled H
    (torch.float32, (12, 20), (46, 82), 16),           # tables wider than 4 taps
    (torch.float32, (1, 3), (2, 4), 4),                # IH 1
])
def test_resize_transposed_kernel_reads_s2d_in_place(cuda, dtype, in_hw, out_hw, c):
    """K4^T on g in space-to-depth layout is, bit for bit, K4^T on the
    depth_to_space copy of g, in one launch."""
    g = _randn((2, out_hw[0] // 2, out_hw[1] // 2, 4 * c), dtype, cuda)
    with torch.no_grad():
        before = dict(LAUNCHES)
        got = resize_s2d_t(g, in_hw)
        torch.cuda.synchronize()
        launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
        assert launched == {'resize_bilinear_t': 1}
        want = resize_bilinear_t(depth_to_space(g).contiguous(), in_hw)
    assert got.shape == (2, *in_hw, c)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['resize_bilinear', 'resize_bilinear_t', 'resize_s2d_t'])
def test_resize_kernels_are_deterministic(cuda, name):
    """K4 and K4^T (g NHWC or in s2d layout) give the same bits from two
    calls and from three replays of a CUDA graph of one call."""
    fn, shape = {
        'resize_bilinear': (lambda t: resize_bilinear(t, (128, 128)), (8, 64, 64, 128)),
        'resize_bilinear_t': (lambda t: resize_bilinear_t(t, (128, 128)), (1, 256, 256, 128)),
        'resize_s2d_t': (lambda t: resize_s2d_t(t, (128, 128)), (1, 128, 128, 512)),
    }[name]
    for dtype in DTYPES:
        x = _randn(shape, dtype, cuda)
        with torch.no_grad():
            a = fn(x)
            assert torch.equal(fn(x), a)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn(x)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                out = fn(x)
            for _ in range(3):
                out.zero_()
                graph.replay()
                torch.cuda.synchronize()
                assert torch.equal(out, a)


@pytest.mark.cuda
def test_resize_s2d_backward_is_one_kernel(cuda):
    """K5's backward launches K4^T once on the space-to-depth cotangent as
    it comes, and no depth_to_space copy (the profiler's kernels)."""
    from torch.profiler import ProfilerActivity, profile
    x = _randn((1, 128, 128, 128), torch.float32, cuda).requires_grad_(True)
    g = _randn((1, 128, 128, 512), torch.float32, cuda, seed=1)
    y = resize_s2d(x, (256, 256))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gx, = torch.autograd.grad(y, x, g)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    assert len(kernels) == 1 and 'resize_t_kernel' in next(iter(kernels)), kernels
    assert sum(kernels.values()) == 1
    with torch.no_grad():
        assert torch.equal(gx, resize_bilinear_t(depth_to_space(g).contiguous(), (128, 128)))


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['resize_bilinear', 'resize_s2d', 'resize_bilinear_t',
                                  'resize_s2d_t'])
def test_resize_kernels_refuse_what_they_do_not_take(cuda, name):
    """K4, K5 and K4^T (g NHWC or in s2d layout) raise on a CUDA tensor they
    cannot take: no plain fallback."""
    fn = {'resize_bilinear': lambda x: resize_bilinear(x, (8, 8)),
          'resize_s2d': lambda x: resize_s2d(x, (8, 8)),
          'resize_bilinear_t': lambda x: resize_bilinear_t(x, (2, 2)),
          'resize_s2d_t': lambda x: resize_s2d_t(x, (2, 2))}[name]
    bad = [_randn((1, 4, 4, 6), torch.float32, cuda),          # C * 4 bytes, not 16-byte vectors
           _randn((1, 4, 4, 8), torch.float16, cuda),          # no fp16 kernel
           _randn((1, 4, 4, 8), torch.float32, cuda).transpose(1, 2),  # not contiguous
           torch.zeros(129, device=cuda)[1:].view(1, 4, 4, 8),  # 4 bytes past 16-byte alignment
           _randn((4, 4, 8), torch.float32, cuda)]             # not [B, H, W, C]
    with torch.no_grad():
        for x in bad:
            with pytest.raises(ValueError):
                fn(x)
        # s2d g: 4C channels of 16-byte vectors
        good = (1, 4, 4, 16) if name == 'resize_s2d_t' else (1, 4, 4, 8)
        assert fn(_randn(good, torch.float32, cuda)).is_cuda


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


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shift', [0, 4])
def test_swin_bwd_kernel_matches_plain(cuda, dtype, shift):
    """K6^T against its plain version, the same bits in two launches, and
    the gradient that autograd of K6 takes."""
    h, w, b, c = 16, 24, 2, 256           # 6 windows a view, 2 heads of 128
    bw = b * (h // 8) * (w // 8)
    q, k, v, do = (_randn((bw, 64, c), dtype, cuda, seed=i) for i in range(4))
    regions = region_table(h, w, 8, shift, cuda) if shift else None

    def bwd():
        return swin_window_attention_bwd(q, k, v, do, num_heads=2, regions=regions)

    got, want, launched = _both(bwd)
    assert launched == {'swin_window_attention_bwd': 1}
    for g, r in zip(got, want):
        amax = float(r.float().abs().max())
        # bf16: P and dS round in both, a sum in another order can round dS
        # to its neighbour: 8 ulps of max|ref|, as K8's; fp32: summation
        # order, 2^-16 of max|ref|
        tol = amax * (8 * 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -16)
        assert float((g.float() - r.float()).abs().max()) <= tol
    with torch.no_grad():
        again = bwd()
    assert all(torch.equal(a, g) for a, g in zip(again, got))  # no atomics
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(LAUNCHES)
    out = swin_window_attention(*leaves, num_heads=2, regions=regions)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert {n: LAUNCHES[n] - before[n] for n in LAUNCHES if LAUNCHES[n] != before[n]} == {
        'swin_window_attention': 1, 'swin_window_attention_bwd': 1}
    assert all(torch.equal(a, g) for a, g in zip(grads, got))


# window counts around the fp32 kernels' persistent grids (K6: two blocks an
# SM, K6^T: one), in SMs: (SMs multiplied, tiles added)
SWIN_GRID_EDGES = {'one': (0, 1), 'sms-1': (1, -1), 'sms': (1, 0), 'sms+1': (1, 1),
                   '2sms-1': (2, -1), '2sms': (2, 0), '2sms+1': (2, 1), '4sms+3': (4, 3)}


@pytest.mark.cuda
@pytest.mark.parametrize('shift', [0, 4])
@pytest.mark.parametrize('edge', sorted(SWIN_GRID_EDGES))
def test_swin_fp32_kernels_at_grid_edges_match_plain(cuda, edge, shift):
    """The fp32 K6 and K6^T walk the (window, head) tiles over a persistent
    grid of the blocks the card holds at once: at one head of 128, tile
    counts just below, at and above one and two SMs' worth of blocks, and
    a ragged count of several rounds, against their plain versions (2^-16
    of max|ref|), with the two launches of K6^T the same bits.  Shifted:
    one 8 x 8 window shifted by 4, whose four regions repeat in every
    window of the batch."""
    mul, add = SWIN_GRID_EDGES[edge]
    bw = mul * torch.cuda.get_device_properties(cuda).multi_processor_count + add
    q, k, v, do = (_randn((bw, 64, 128), torch.float32, cuda, seed=i) for i in range(4))
    regions = region_table(8, 8, 8, shift, cuda) if shift else None
    got, want, launched = _both(
        lambda: swin_window_attention(q, k, v, num_heads=1, regions=regions))
    assert launched == {'swin_window_attention': 1}
    assert float((got - want).abs().max()) <= 2.0 ** -16 * float(want.abs().max())

    def bwd():
        return swin_window_attention_bwd(q, k, v, do, num_heads=1, regions=regions)

    got, want, launched = _both(bwd)
    assert launched == {'swin_window_attention_bwd': 1}
    for g, r in zip(got, want):
        assert float((g - r).abs().max()) <= 2.0 ** -16 * float(r.abs().max())
    with torch.no_grad():
        again = bwd()
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('inverse', [False, True])
def test_regroup_vjp_is_the_inverse_regroup(cuda, dtype, inverse):
    x = _randn((2, 32 * 16, 256), dtype, cuda).requires_grad_(True)
    g = _randn((2, 32 * 16, 256), dtype, cuda, seed=1)
    before = LAUNCHES['shifted_regroup']
    gx, = torch.autograd.grad(shifted_regroup(x, (32, 16), 8, inverse=inverse), x, g)
    torch.cuda.synchronize()
    assert LAUNCHES['shifted_regroup'] == before + 2  # the regroup and its VJP
    with torch.no_grad(), reference_kernels():
        want = shifted_regroup(g, (32, 16), 8, inverse=not inverse)
    assert torch.equal(gx, want)  # a permutation


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


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_fused_backward_adds_dq_into_a_given_sum(cuda, dtype):
    """K8 given dq_acc (a ring's sum of its K/V slices' dQ) adds into it by
    its atomics: the sum less what it held is the dQ of a plain call before
    its cast, within the kernel's bar; dK and dV as without it."""
    from renderformer_tpu_torch.ops.flash_attention import fan_out
    b, sq, sk, h = 2, 257, 516, 3
    q, do = (_randn((b, sq, h, 128), dtype, cuda, seed=s) for s in (1, 2))
    k, v = (_randn((b, sk, h, 128), dtype, cuda, seed=s) for s in (3, 4))
    mask = torch.ones(b, sk, dtype=torch.bool, device=cuda)
    mask[1] = False
    with torch.no_grad():
        with reference_kernels():
            out, lse = flash_fwd(q, k, fan_out(v, b).contiguous(), mask, with_lse=True)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        io = (q, k, v, mask, lse, delta, do)
        prior = _randn((b, sq, h, 128), torch.float32, cuda, seed=5)
        acc = prior.clone()
        dq, dk, dv = flash_bwd(*io)
        got = flash_bwd(*io, dq_acc=acc)
        torch.cuda.synchronize()
    assert got[0] is None
    for gt, wt in ((got[1], dk), (got[2], dv)):
        assert float((gt.float() - wt.float()).abs().max()) <= _attn_tol(wt, dtype, ulps=8)
    err = float((acc - prior - dq.float()).abs().max())
    assert err <= _attn_tol(dq, dtype, ulps=8)


# K9's dQ kernel (csrc/flash_bwd.cu in fp32, csrc/flash_bwd_dq_sm90.cu in
# bf16): b, bkv, sq, sk, h, mask.  The train step's three sites; ragged q
# tiles (64 or 128 rows) and key steps (16 or 64 keys), with a padded tail or
# random keys masked ('zero_row': and all of batch row 1); view
# fan-outs; and a grid of 1024 q tiles, which the fp32 kernel does not split.
DQ_CASES = {
    'train_stage1_self': (1, 1, 2064, 2064, 6, 'tail'),
    'train_cross': (1, 1, 1024, 2064, 6, 'tail'),
    'train_ray_self': (1, 1, 1024, 1024, 6, None),
    'tail_129x2064': (1, 1, 129, 2064, 1, 'tail'),
    'reps4_tail_97x2064_h2': (4, 1, 97, 2064, 2, 'tail'),
    'reps2_random_65x33_h3': (2, 1, 65, 33, 3, 'random'),
    'zero_row_129x200_h2': (3, 3, 129, 200, 2, 'zero_row'),
    'random_33x17': (1, 1, 33, 17, 1, 'random'),
    'unmasked_1000x1000': (1, 1, 1000, 1000, 1, None),
    'b8_h8_tail_1000x2064': (8, 8, 1000, 2064, 8, 'tail'),
}


def _dq_io(case, dtype, dev):
    """The dQ kernel's operands at a case of DQ_CASES, lse and delta from the
    plain forward: (q, k, v, mask, lse, delta, dO)."""
    b, bkv, sq, sk, h, mask_kind = DQ_CASES[case]
    q, do = (_randn((b, sq, h, 128), dtype, dev, seed=s) for s in (1, 2))
    k = _randn((b, sk, h, 128), dtype, dev, seed=3)
    v = _randn((bkv, sk, h, 128), dtype, dev, seed=4)
    mask = None
    if mask_kind == 'tail':
        mask = torch.ones(b, sk, dtype=torch.bool, device=dev)
        mask[:, 1552:] = False
    elif mask_kind in ('random', 'zero_row'):
        mask = torch.from_numpy(np.random.default_rng(5).uniform(size=(b, sk)) > 0.3).to(dev)
        mask[:, 0] = True
        if mask_kind == 'zero_row':
            mask[1] = False
    from renderformer_tpu_torch.ops.flash_attention import fan_out
    with torch.no_grad(), reference_kernels():
        out, lse = flash_fwd(q, k, fan_out(v, b).contiguous(), mask, with_lse=True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, mask, lse, delta, do


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('case', sorted(DQ_CASES))
def test_dq_kernel_matches_plain(cuda, case, dtype):
    """K9's dQ kernel alone against the plain dq, within chip_smoke.py's bar:
    8 bf16 ulps / 2^-15 of max|ref|."""
    from renderformer_tpu_torch import _build
    from renderformer_tpu_torch.ops.flash_attention import flash_bwd_dq_plain, launch_flash_bwd
    io = _dq_io(case, dtype, cuda)
    with torch.no_grad():
        got = launch_flash_bwd(_build.library(), 'dq', *io)[0]
        want = flash_bwd_dq_plain(*io)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    amax = float(want.float().abs().max())
    tol = amax * (8 * 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -15)
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.cuda
def test_dq_kernel_plans(cuda):
    """The fp32 kernel splits the keys of the train step's 96 q tiles over a
    cluster, and not those of 1024 tiles; the bf16 kernel never splits."""
    from renderformer_tpu_torch.ops.flash_attention import flash_bwd_dq_rows, flash_bwd_dq_splits
    f32, bf = torch.float32, torch.bfloat16
    assert flash_bwd_dq_rows(f32, 1, 1024, 6) == 64
    assert flash_bwd_dq_splits(f32, 1, 1024, 2064, 6) in (2, 4)
    assert flash_bwd_dq_splits(f32, 1, 1024, 1024, 6) in (2, 4)
    assert flash_bwd_dq_splits(f32, 8, 1000, 2064, 8) == 1
    assert flash_bwd_dq_splits(f32, 1, 33, 1, 1) == 1  # one key step
    assert flash_bwd_dq_rows(bf, 1, 2064, 6) in (64, 128)
    assert flash_bwd_dq_splits(bf, 1, 2064, 2064, 6) == 1


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('case', ['train_stage1_self', 'train_cross', 'train_ray_self',
                                  'reps4_tail_97x2064_h2'])
def test_dq_kernel_is_one_deterministic_launch(cuda, case, dtype, tmp_path):
    """One dQ kernel on the card a call (the one node of a CUDA graph of a
    call, read from the graph's DOT dump), and the same bits from two calls
    and from three replays of that graph, with the keys split over a
    cluster or not."""
    from renderformer_tpu_torch import _build
    from renderformer_tpu_torch.ops.flash_attention import launch_flash_bwd
    io = _dq_io(case, dtype, cuda)
    lib = _build.library()
    with torch.no_grad():
        a = launch_flash_bwd(lib, 'dq', *io)[0]
        b = launch_flash_bwd(lib, 'dq', *io)[0]
        torch.cuda.synchronize()
        assert torch.equal(a, b)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            launch_flash_bwd(lib, 'dq', *io)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, stream=side):
            out = launch_flash_bwd(lib, 'dq', *io)[0]
        dot = tmp_path / 'dq.dot'
        graph.debug_dump(str(dot))
        text = dot.read_text()
        nodes = set(re.findall(r'"(graph_\d+_node_\d+)"', text))
        assert len(nodes) == 1 and 'flash_bwd_dq' in text, text[:3000]
        graph.instantiate()
        for _ in range(3):
            out.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, a)


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
@pytest.mark.parametrize('swin', [False, True])
def test_default_render_runs_every_norm_through_the_kernel(cuda, swin):
    """A bf16 render at the default runtime launches K11's forward once for
    each RMSNorm forward call, which forward hooks count (every site passes
    the gate: widths of 256, 300 triangles + 4 registers, 2 views of 16 x 16
    ray tokens), and gives the image of the ``fused_norm=False`` render
    within one bf16 ulp of each value."""
    from renderformer_tpu_torch import RenderFormerConfig, RenderingPipeline, RuntimeConfig
    from renderformer_tpu_torch.models.renderformer import RenderFormer
    from renderformer_tpu_torch.nn.core import RMSNorm, init_weights

    cfg = RenderFormerConfig(latent_dim=256, num_layers=2, num_heads=2, dim_feedforward=256,
                             num_register_tokens=4, view_transformer_latent_dim=256,
                             view_transformer_ffn_hidden_dim=256, view_transformer_n_heads=2,
                             view_transformer_n_layers=4, view_transformer_use_swin_attn=swin,
                             dpt_features=128, dpt_out_channels=[32, 64, 128, 128])
    model = init_weights(RenderFormer(cfg), torch.Generator().manual_seed(0))
    calls = [0]

    def count(*_):
        calls[0] += 1

    for m in model.modules():
        if isinstance(m, RMSNorm):
            m.register_forward_hook(count)
    rng = np.random.default_rng(0)
    n, v = 300, 2
    c2w = np.tile(np.eye(4, dtype=np.float32), (1, v, 1, 1))
    c2w[0, :, 2, 3] = 2.0
    scene = (rng.normal(size=(1, n, 3, 3)).astype(np.float32) * 0.3,
             rng.uniform(0, 1, (1, n, 13, 32, 32)).astype(np.float32), np.ones((1, n), bool),
             rng.normal(size=(1, n, 3, 3)).astype(np.float32), c2w,
             np.full((1, v, 1), 40.0, np.float32))
    imgs = {}
    for runtime in (RuntimeConfig(), RuntimeConfig(fused_norm=False)):
        pipe = RenderingPipeline(model, runtime, device=cuda)
        before, calls[0] = LAUNCHES['rms_norm_fwd'], 0
        imgs[runtime.fused_norm] = pipe.render(*scene, resolution=128, precision='bf16')
        torch.cuda.synchronize()
        launched = LAUNCHES['rms_norm_fwd'] - before
        assert calls[0] > 0 and launched == (calls[0] if runtime.fused_norm else 0)
    got, want = (imgs[k].float().cpu().numpy() for k in (True, False))
    assert np.isfinite(got).all()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), np.finfo(np.float32).tiny))) - 7)
    assert (np.abs(got - want) <= ulp).all()


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('layout,in_hw,out_hw', [
    ('nhwc', (16, 16), (32, 32)), ('nhwc', (12, 20), (23, 41)),
    ('s2d', (16, 16), (32, 32)), ('s2d', (12, 20), (24, 42))])
def test_resize_transposed_kernel_matches_plain(cuda, dtype, layout, in_hw, out_hw):
    g = _randn((2, *out_hw, 64), dtype, cuda)
    fwd, bwd = resize_bilinear, resize_bilinear_t
    if layout == 's2d':  # K5's VJP, on g in space-to-depth layout
        g = space_to_depth(g).contiguous()
        fwd, bwd = resize_s2d, resize_s2d_t
    got, want, launched = _both(lambda: bwd(g, in_hw))
    assert launched == {'resize_bilinear_t': 1}
    # the same nonzero products in fp32, summed in another order, rounded once
    tol = float(want.float().abs().max()) * (2.0 ** -8 if dtype == torch.bfloat16 else 1e-6)
    assert float((got.float() - want.float()).abs().max()) <= tol
    # and it is the VJP of K4 (K5)
    x = _randn((2, *in_hw, 64), dtype, cuda).requires_grad_(True)
    y = fwd(x, out_hw)
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


@pytest.mark.cuda
def test_tiny_swin_train_step_is_deterministic(cuda):
    """A tiny Swin model (head dim 128, a 16x16 grid of 2x2 windows) under
    deterministic=True: K6, K6^T, K7 and K9 launch, two steps from the same
    state give the same bits, and the step is the plain versions' step."""
    from renderformer_tpu_torch import RenderFormerConfig
    from renderformer_tpu_torch.models.renderformer import RenderFormer
    from renderformer_tpu_torch.nn.core import init_weights
    from renderformer_tpu_torch.training import state as ts

    cfg = RenderFormerConfig(latent_dim=256, num_layers=2, num_heads=2, dim_feedforward=256,
                             num_register_tokens=4, view_transformer_latent_dim=256,
                             view_transformer_ffn_hidden_dim=256, view_transformer_n_heads=2,
                             view_transformer_n_layers=4, view_transformer_use_swin_attn=True,
                             dpt_features=128, dpt_out_channels=[32, 64, 128, 128])
    rng = np.random.default_rng(0)
    n, res = 40, 128
    batch = {'triangles': rng.normal(size=(1, n, 3, 3)).astype(np.float32) * 0.3,
             'texture': rng.uniform(0, 1, (1, n, 13, 32, 32)).astype(np.float32),
             'mask': np.ones((1, n), bool), 'vn': rng.normal(size=(1, n, 3, 3)).astype(
                 np.float32),
             'c2w': np.tile(np.eye(4, dtype=np.float32), (1, 1, 1, 1)),
             'fov': np.full((1, 1, 1), 40.0, np.float32),
             'gt': rng.uniform(0, 1, (1, 1, res, res, 3)).astype(np.float32)}
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}
    tc = ts.TrainConfig(resolution=res, learning_rate=1e-4, remat=True, deterministic=True)
    runs = []
    for plain in (False, False, True):
        model = init_weights(RenderFormer(cfg), torch.Generator().manual_seed(0)).to(cuda)
        tx = ts.make_optimizer(tc)
        state = ts.TrainState.create(model, tx, tc)
        step, _ = ts.make_train_step(model, tx, tc)
        before = dict(LAUNCHES)
        if plain:
            with reference_kernels():
                metrics = step(state, batch)[1]
        else:
            metrics = step(state, batch)[1]
        torch.cuda.synchronize()
        launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
        if not plain:
            # 4 decoder layers, 2 of them shifted: K6 twice a layer (the
            # forward and the remat recomputation), K6^T once; K7 twice a
            # shifted layer in the forward, again recomputed, again as its
            # VJP; K9 at the 2 encoder and 4 decoder attention sites
            assert launched['swin_window_attention'] == 8
            assert launched['swin_window_attention_bwd'] == 4
            assert launched['shifted_regroup'] == 12
            assert launched['flash_bwd_dq'] == 6 and 'flash_bwd_mask' not in launched
        runs.append((metrics, [p.detach().clone() for p in model.parameters()]))
    (m0, p0), (m1, p1), (mp, _) = runs
    assert m0 == m1 and all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert np.isfinite(m0['loss']) and np.isfinite(m0['grad_norm'])
    # bf16 stage 1: the kernels and the plain versions round at other points
    assert m0['loss'] == pytest.approx(mp['loss'], rel=1e-2)
    assert m0['grad_norm'] == pytest.approx(mp['grad_norm'], rel=5e-2)
