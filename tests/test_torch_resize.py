"""The plain version of kernel K4 (align_corners bilinear resize) and the
DPT head with the plain output tail, against the JAX package on the CPU.
The JAX kernel runs in Pallas interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderformer_tpu.nn.conv import resize_bilinear_align_corners as jax_resize
from renderformer_tpu.nn.dpt import DPTHead as JaxDPTHead
from renderformer_tpu.ops.fused_resize import fused_resize
from renderformer_tpu_torch.convert import jax_params_to_state_dict
from renderformer_tpu_torch.nn.conv import resize_bilinear_align_corners
from renderformer_tpu_torch.nn.dpt import DPTHead
from renderformer_tpu_torch.ops.fused_resize import resize_bilinear

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
