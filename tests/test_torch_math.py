"""Pure math of the port against the JAX package on the same numpy inputs:
HDR codec, camera transform, both ray generators, NeRF and triangle RoPE
encodings.  Everything is fp32; tolerance 1e-6 (a few fp32 ulps of values
of order one, from transcendental functions and summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderformer_tpu.encodings import nerf as jnerf
from renderformer_tpu.encodings import rope as jrope
from renderformer_tpu.utils import hdr as jhdr
from renderformer_tpu.utils import rays as jrays
from renderformer_tpu.utils import transform as jtransform
from renderformer_tpu_torch.encodings import nerf, rope
from renderformer_tpu_torch.utils import hdr, rays, transform

TOL = dict(atol=1e-6, rtol=1e-6)


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), **(kw or TOL))


def _c2w(rng, n):
    """Random rigid camera-to-world matrices."""
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    m = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    m[:, :3, :3] = q
    m[:, :3, 3] = rng.normal(size=(n, 3))
    return m.astype(np.float32)


def test_hdr_codec():
    rng = np.random.default_rng(0)
    tex = rng.uniform(0, 30, (2, 5, 13, 4, 4)).astype(np.float32)
    _close(jhdr.hdr_encode_texture(jnp.asarray(tex)),
           hdr.hdr_encode_texture(torch.from_numpy(tex)))
    img = rng.uniform(-0.5, 1.5, (2, 3, 8, 8, 3)).astype(np.float32)
    _close(jhdr.hdr_decode_image(jnp.asarray(img)),
           hdr.hdr_decode_image(torch.from_numpy(img)), atol=1e-6, rtol=2e-6)


def test_trans_to_cam_coord():
    rng = np.random.default_rng(1)
    c2w = _c2w(rng, 3)
    tris = rng.normal(size=(3, 7, 3, 3)).astype(np.float32)
    vns = rng.normal(size=(3, 7, 3, 3)).astype(np.float32)
    want = jtransform.trans_to_cam_coord(jnp.asarray(c2w), jnp.asarray(tris),
                                         jnp.asarray(vns))
    got = transform.trans_to_cam_coord(torch.from_numpy(c2w), torch.from_numpy(tris),
                                       torch.from_numpy(vns))
    for a, b in zip(want, got):
        _close(a, b, atol=2e-6, rtol=1e-6)


@pytest.mark.parametrize('res', [16, 64])
def test_generate_rays(res):
    rng = np.random.default_rng(2)
    c2w = _c2w(rng, 2).reshape(1, 2, 4, 4)
    fov = np.radians(rng.uniform(30, 60, (1, 2, 1))).astype(np.float32)
    wo, wd = jrays.generate_rays(jnp.asarray(c2w), jnp.asarray(fov), res)
    go, gd = rays.generate_rays(torch.from_numpy(c2w), torch.from_numpy(fov), res)
    _close(wo, go)
    _close(wd, gd)


@pytest.mark.parametrize('res,p', [(32, 8), (64, 8), (48, 16)])
def test_generate_rays_patched(res, p):
    rng = np.random.default_rng(3)
    c2w = _c2w(rng, 3)
    fov = np.radians(rng.uniform(30, 60, (3, 1))).astype(np.float32)
    wo, wd = jrays.generate_rays_patched(jnp.asarray(c2w), jnp.asarray(fov), res, p)
    go, gd = rays.generate_rays_patched(torch.from_numpy(c2w), torch.from_numpy(fov),
                                        res, p)
    assert tuple(gd.shape) == (3, (res // p) ** 2, 3 * p * p)
    _close(wo, go)
    _close(wd, gd)


@pytest.mark.parametrize('num_freqs,include_input', [(0, True), (4, True), (6, False)])
def test_nerf_encode(num_freqs, include_input):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 9)).astype(np.float32)
    want = jnerf.nerf_encode(jnp.asarray(x), num_freqs, include_input=include_input)
    got = nerf.nerf_encode(torch.from_numpy(x), num_freqs, include_input=include_input)
    assert got.shape[-1] == nerf.nerf_out_dim(9, num_freqs, include_input)
    # sin of arguments up to |x| * 2^5: fp32 argument rounding dominates
    _close(want, got, atol=2e-6, rtol=1e-6)


@pytest.mark.parametrize('dim,double', [(12, False), (12, True), (4, False)])
def test_rope_frequencies(dim, double):
    np.testing.assert_array_equal(jrope.rope_frequencies(dim, double),
                                  rope.rope_frequencies(dim, double))


@pytest.mark.parametrize('rope_dim,head_dim', [(12, 128), (4, 36)])
def test_rope_tables_and_rotation(rope_dim, head_dim):
    rng = np.random.default_rng(5)
    pos = (rng.normal(size=(2, 11, 9)) * 0.5).astype(np.float32)
    freqs = rope.rope_frequencies(rope_dim)
    ang_j = jrope.triangle_freqs(jnp.asarray(pos), jnp.asarray(freqs))
    ang_t = rope.triangle_freqs(torch.from_numpy(pos), torch.from_numpy(freqs))
    _close(ang_j, ang_t)
    cj, sj = jrope.freqs_to_cos_sin(ang_j, head_dim=head_dim)
    ct, st = rope.freqs_to_cos_sin(ang_t, head_dim=head_dim)
    _close(cj, ct)
    _close(sj, st)
    x = rng.normal(size=(2, 11, 3, head_dim)).astype(np.float32)
    _close(jrope.apply_rope(jnp.asarray(x), cj, sj),
           rope.apply_rope(torch.from_numpy(x), ct, st), atol=2e-6, rtol=1e-6)
    mj = jrope.make_cos_sin(jnp.asarray(pos), rope_dim, head_dim)
    mt = rope.make_cos_sin(torch.from_numpy(pos), rope_dim, head_dim)
    for a, b in zip(mj, mt):
        _close(a, b)
