"""The plain version of kernel K4 (align_corners bilinear resize), its VJP
(the plain version of K4^T, also behind K5's VJP) and the DPT head with the
plain output tail, against the JAX package on the CPU.  The JAX kernels run
in Pallas interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderformer_tpu.nn.conv import resize_bilinear_align_corners as jax_resize
from renderformer_tpu.nn.dpt import DPTHead as JaxDPTHead
from renderformer_tpu.ops.fused_resize import fused_resize, fused_resize_s2d
from renderformer_tpu_torch.convert import jax_params_to_state_dict
from renderformer_tpu_torch.nn.conv import resize_bilinear_align_corners
from renderformer_tpu_torch.nn.dpt import DPTHead
from renderformer_tpu_torch.ops.fused_resize import (
    MIN_BLOCKS, TAP_SMEM, adjoint_taps, interp_matrix, resize_bilinear, resize_bilinear_t,
    resize_s2d, resize_s2d_t, row_plan)
from renderformer_tpu_torch.ops.s2d_conv import depth_to_space, space_to_depth

# the four x2 upsamples of the refinenets at 512^2, with a narrow C
RATIOS = [(32, 64), (64, 128), (128, 256), (256, 512)]


@pytest.mark.parametrize('n_in,n_out', RATIOS)
def test_resize_plain_matches_jax_fp32(n_in, n_out):
    rng = np.random.default_rng(n_in)
    b, c = (2, 16) if n_in <= 64 else (1, 8)
    x = rng.normal(size=(b, n_in, n_in, c)).astype(np.float32)
    with torch.no_grad():
        got = resize_bilinear(torch.from_numpy(x), (n_out, n_out)).numpy()
    # same (i0, i1, frac) tables and the same fp32 lerps as the gather path
    want = np.asarray(jax_resize(jnp.asarray(x), (n_out, n_out)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if n_in <= 64:  # the interpret-mode kernel is slow at the larger sizes
        kern = np.asarray(fused_resize(jnp.asarray(x), (n_out, n_out), interpret=True))
        # the banded-matmul kernel sums the same two taps per axis
        np.testing.assert_allclose(got, kern, atol=1e-6, rtol=0)


@pytest.mark.parametrize('n_in,n_out', RATIOS[:2])
def test_resize_plain_matches_jax_bf16(n_in, n_out):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, n_in, n_in, 16)).astype(np.float32)
    with torch.no_grad():
        got = resize_bilinear(torch.from_numpy(x).bfloat16(), (n_out, n_out))
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax_resize(jnp.asarray(x, jnp.bfloat16), (n_out, n_out))
                      .astype(jnp.float32))
    # both round the same lerps in bf16; bounded by two bf16 ulps at |x| < 8
    np.testing.assert_allclose(got.float().numpy(), want, atol=2 * 2 ** -5, rtol=0)
    kern = np.asarray(fused_resize(jnp.asarray(x, jnp.bfloat16), (n_out, n_out),
                                   interpret=True).astype(jnp.float32))
    # the banded kernel rounds its H pass to bf16 at other points
    np.testing.assert_allclose(got.float().numpy(), kern, atol=6e-2, rtol=2e-2)


def test_resize_identity_and_non_square():
    x = torch.randn(1, 8, 12, 16)
    assert resize_bilinear_align_corners(x, (8, 12)) is x
    rng = np.random.default_rng(3)
    xn = rng.normal(size=(1, 8, 12, 16)).astype(np.float32)
    with torch.no_grad():
        got = resize_bilinear_align_corners(torch.from_numpy(xn), (16, 24)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_resize(jnp.asarray(xn), (16, 24))),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize('patch', [(8, 8), (4, 6)])
def test_dpt_head_plain_tail_matches_jax(monkeypatch, patch):
    monkeypatch.setenv('RFTPU_DPT_TAIL', 'plain')
    ph, pw = patch
    in_ch, feats, oc = 32, 16, (8, 16, 32, 64)
    jh = JaxDPTHead(in_channels=in_ch, features=feats, out_channels=oc, out_dim=3)
    params = jh.init(jax.random.key(0))
    th = DPTHead(in_ch, feats, oc, 3)
    th.load_state_dict(jax_params_to_state_dict(jax.tree.map(np.asarray, params)))
    rng = np.random.default_rng(4)
    taps = [rng.normal(size=(2, ph * pw, in_ch)).astype(np.float32) for _ in range(4)]
    run = jax.jit(lambda p, t: jh(p, t, ph, pw, patch_size=8))
    want = np.asarray(run(params, [jnp.asarray(t) for t in taps]))
    with torch.no_grad():
        got = th([torch.from_numpy(t) for t in taps], ph, pw, patch_size=8).numpy()
    assert got.shape == (2, ph * 8, pw * 8, 3)
    # fp32 convs in another summation order
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def _vjp_tol(dtype, want):
    """fp32: the same nonzero weights summed in another order (the JAX
    kernel's banded matmuls): 1e-6 of max|want|.  bf16: the JAX kernel rounds
    its H pass to bf16, the port's sums stay fp32 and round once: 2 bf16
    ulps of max|want|."""
    amax = float(np.abs(want).max())
    return dict(atol=(1e-6 if dtype == 'fp32' else 2 * 2.0 ** -8) * amax, rtol=0)


@pytest.mark.parametrize('layout', ['nhwc', 's2d'])
@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('n_in,out_hw', [(16, (32, 32)), (32, (64, 64)), (16, (24, 40))])
def test_resize_vjp_matches_jax_transposed_kernel(n_in, out_hw, dtype, layout):
    """The VJP of K4 (layout nhwc) and of K5 (s2d: g in space-to-depth
    layout, through K5's backward route) against JAX's interpret-mode
    kernels."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == 'fp32' else (jnp.bfloat16,
                                                                     torch.bfloat16)
    rng = np.random.default_rng(n_in)
    x = rng.normal(size=(2, n_in, n_in + 8, 16)).astype(np.float32)
    g = rng.normal(size=(2, *out_hw, 16)).astype(np.float32)
    jfn, tfn = fused_resize, resize_bilinear
    if layout == 's2d':
        jfn, tfn = fused_resize_s2d, resize_s2d
        g = np.asarray(space_to_depth(torch.from_numpy(g)))
    _, vjp = jax.vjp(lambda a: jfn(a, out_hw, interpret=True), jnp.asarray(x, jdt))
    want = np.asarray(vjp(jnp.asarray(g, jdt))[0].astype(jnp.float32))
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    got, = torch.autograd.grad(tfn(tx, out_hw), tx, torch.from_numpy(g).to(tdt))
    assert got.dtype == tdt and got.shape == tx.shape
    np.testing.assert_allclose(got.float().numpy(), want, **_vjp_tol(dtype, want))


@pytest.mark.parametrize('route', ['autograd', 'resize_s2d_t'])
@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
def test_resize_s2d_vjp_matches_jax(dtype, route):
    """K5's VJP at C 128 through autograd of resize_s2d and through
    resize_s2d_t called on the space-to-depth cotangent itself."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == 'fp32' else (jnp.bfloat16,
                                                                     torch.bfloat16)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, 16, 16, 128)).astype(np.float32)
    g = rng.normal(size=(1, 16, 16, 512)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: fused_resize_s2d(a, (32, 32), interpret=True),
                     jnp.asarray(x, jdt))
    want = np.asarray(vjp(jnp.asarray(g, jdt))[0].astype(jnp.float32))
    tg = torch.from_numpy(g).to(tdt)
    if route == 'autograd':
        tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
        got, = torch.autograd.grad(resize_s2d(tx, (32, 32)), tx, tg)
    else:
        got = resize_s2d_t(tg, (16, 16))
    assert got.dtype == tdt and got.shape == (1, 16, 16, 128)
    np.testing.assert_allclose(got.float().numpy(), want, **_vjp_tol(dtype, want))


# (kernel, x or g shape, output or input size, dtype): the main path's sites
# of K4 (the renders' three bf16 upsamples, the train step's three fp32), K5
# (the render's and the train step's) and K4^T (the train step's four, g
# NHWC or in s2d layout), and the edge shapes of the kernels' cuda tests
PLAN_CASES = [
    ('k4', (8, 32, 32, 128), (64, 64), 'bf16'),
    ('k4', (8, 64, 64, 128), (128, 128), 'bf16'),
    ('k4', (8, 128, 128, 128), (256, 256), 'bf16'),
    ('k4', (1, 16, 16, 128), (32, 32), 'fp32'),
    ('k4', (1, 32, 32, 128), (64, 64), 'fp32'),
    ('k4', (1, 64, 64, 128), (128, 128), 'fp32'),
    ('k5', (8, 256, 256, 128), (512, 512), 'bf16'),
    ('k5', (1, 128, 128, 128), (256, 256), 'fp32'),
    ('k4t', (1, 32, 32, 128), (16, 16), 'fp32'),
    ('k4t', (1, 64, 64, 128), (32, 32), 'fp32'),
    ('k4t', (1, 128, 128, 128), (64, 64), 'fp32'),
    ('k4t', (1, 256, 256, 128), (128, 128), 'fp32'),
    ('k4t', (1, 128, 128, 512), (128, 128), 'fp32'),   # s2d g of the 256^2 output
    ('k4', (2, 1, 4, 4), (4, 8), 'fp32'),               # IH 1, C 4 fp32
    ('k4', (1, 5, 7, 8), (6, 1), 'bf16'),               # OW 1, C 8 bf16
    ('k4', (3, 9, 11, 16), (5, 6), 'bf16'),             # B 3, downsampled
    ('k4', (1, 9, 300, 4), (6, 2060), 'fp32'),          # a row of more than one block
    ('k5', (1, 3, 5, 8), (2, 6), 'bf16'),
    ('k5', (2, 5, 7, 24), (6, 10), 'bf16'),             # 252 threads (21 pixels)
    ('k5', (1, 4, 6, 512), (8, 12), 'fp32'),            # 512 threads (1 pixel)
    ('k4t', (3, 23, 41, 8), (12, 20), 'bf16'),          # 5-tap tables
    ('k4t', (1, 6, 2060, 4), (9, 300), 'fp32'),
    ('k4t', (2, 4, 8, 4), (1, 4), 'fp32'),              # IH 1
]


@pytest.mark.parametrize('kernel,shape,hw,dtype', PLAN_CASES)
def test_row_plan_covers_every_vector_once(kernel, shape, hw, dtype):
    """The blocks and threads of a row-tiled kernel's plan (row_plan, as
    csrc/resize.cu walks it) store every vector of every row exactly once;
    the chunk is a whole number of the block's steps, its taps fit the
    shared memory, and it is cut only while the grid holds MIN_BLOCKS."""
    item = 2 if dtype == 'bf16' else 4
    b, _, _, c = shape
    if kernel == 'k4t':   # x: g's shape; hw: the input size, whose rows are tiled
        row_px, rows, pv, tap_bytes = hw[1], hw[0] * b, c * item // 16, 32
        if c == 512:  # g in s2d layout: the output's C is 128
            pv //= 4
    else:
        s = 2 if kernel == 'k5' else 1
        row_px, rows, pv, tap_bytes = hw[1] // s, hw[0] // s * b, s * s * c * item // 16, 16 * s
    threads, ppb = row_plan(row_px, rows, pv, tap_bytes)
    dpx = threads // pv
    assert threads % pv == 0 and threads <= 1024 and (threads <= 256 or dpx == 1)
    assert ppb % dpx == 0 and ppb * tap_bytes <= TAP_SMEM
    chunks = -(-row_px // ppb)
    if ppb > dpx:  # cut no further than the grid needs
        assert chunks * rows >= MIN_BLOCKS
    seen = np.zeros((row_px, pv), np.int64)
    t = np.arange(threads)
    for chunk in range(chunks):
        p0 = chunk * ppb
        p1 = min(row_px, p0 + ppb)
        px = p0 + t // pv
        for n in range(-(-ppb // dpx)):  # the kernel's loop: px, px + dpx, ... < p1
            on = px + n * dpx < p1
            np.add.at(seen, (px[on] + n * dpx, (t % pv)[on]), 1)
    assert (seen == 1).all()


def test_row_plan_keeps_k5_plan():
    """K5's plan at its two sites: 256 threads, 16 steps a block."""
    assert row_plan(256, 256 * 8, 64, 32) == (256, 64)     # renders: 4 s2d pixels a step
    assert row_plan(128, 128, 128, 32) == (256, 32)        # train step: 2 a step


@pytest.mark.parametrize('oh,ow,c', [(2, 2, 4), (6, 10, 8), (32, 64, 16)])
def test_s2d_offsets_address_depth_to_space(oh, ow, c):
    """K4^T's offsets into an image of s2d-layout g (csrc/resize.cu g_row +
    g_col + channel) address the element that depth_to_space puts at output
    (oy, ox, c)."""
    oy, ox, ch = np.meshgrid(np.arange(oh), np.arange(ow), np.arange(c), indexing='ij')
    g_row = (oy >> 1) * (ow * 2 * c) + (oy & 1) * (2 * c)
    g_col = (ox >> 1) * (4 * c) + (ox & 1) * c
    flat = torch.arange(oh * ow * c).reshape(1, oh // 2, ow // 2, 4 * c)
    np.testing.assert_array_equal(g_row + g_col + ch, depth_to_space(flat)[0].numpy())


@pytest.mark.parametrize('n_in,n_out', [(16, 32), (128, 256), (5, 3), (1, 4), (7, 1)])
def test_adjoint_taps_are_the_matrix_columns(n_in, n_out):
    """K4^T's per-axis tables hold each column of the interpolation matrix
    from its first to its last nonzero, and the plain transposed resize is
    the adjoint of the plain resize: <R x, g> = <x, R^T g>."""
    m = interp_matrix(n_in, n_out)
    span, w = adjoint_taps(n_in, n_out)
    rebuilt = np.zeros_like(m)
    for i, (lo, cnt) in enumerate(span):
        rebuilt[lo:lo + cnt, i] = w[i, :cnt]
        assert not w[i, cnt:].any()
    np.testing.assert_array_equal(rebuilt, m)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1, n_in, 3, 8)).astype(np.float64))
    g = torch.from_numpy(rng.normal(size=(1, n_out, 3, 8)).astype(np.float64))
    with torch.no_grad():
        fwd = resize_bilinear(x.float(), (n_out, 3)).double()
        adj = resize_bilinear_t(g.float(), (n_in, 3)).double()
    assert abs(float((fwd * g).sum() - (x * adj).sum())) <= 1e-4 * float(x.abs().sum())
