"""The port's path tracer (renderformer_tpu_torch.scene.path_tracer) on the
CPU against the JAX package's.

Deterministic parts against JAX's functions on the same numpy inputs, to
1e-5 relative (triangle indices equal): intersection and occlusion, the
BSDF's eval and pdf, the sampling helpers fed the uniforms jax.random
draws, the jittered primary rays, the scene arrays and the materials.
The two PRNGs differ, so the renders are held by physics (the bars of
tests/test_path_tracer.py) and statistically against JAX's path_trace.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderformer_tpu.scene import path_tracer as J
from renderformer_tpu_torch.scene import path_tracer as T

RTOL = 1e-5


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x)).to(dtype)


def _close(got, want, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# deterministic parts
# ---------------------------------------------------------------------------

def test_intersect_and_occluded_match_jax():
    """Random rays against a seeded soup of 1,100 triangles, 3 chunks of 512
    (the last one padded), some masked out."""
    rng = np.random.default_rng(0)
    tris = (rng.normal(size=(1100, 3, 3)) * np.array([1.0, 1.0, 0.3])).astype(np.float32)
    tris += rng.normal(size=(1100, 1, 3)).astype(np.float32) * 2
    mask = rng.uniform(size=1100) > 0.1
    o = (rng.normal(size=(2000, 3)) * 4).astype(np.float32)
    d = _unit(rng, 2000)
    tj, ij, hj = J.intersect(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tris),
                             jnp.asarray(mask))
    tt, it, ht = T.intersect(_t(o), _t(d), _t(tris), _t(mask, torch.bool))
    hj = np.asarray(hj)
    assert hj.sum() > 200 and (ht.numpy() == hj).all()
    np.testing.assert_array_equal(it.numpy()[hj], np.asarray(ij)[hj])
    _close(tt.numpy()[hj], np.asarray(tj)[hj], atol=0)
    assert np.isinf(tt.numpy()[~hj]).all()
    max_t = rng.uniform(0.5, 8, 2000).astype(np.float32)
    oj = J.occluded(jnp.asarray(o), jnp.asarray(d), jnp.asarray(max_t), jnp.asarray(tris),
                    jnp.asarray(mask), chunk=256)
    ot = T.occluded(_t(o), _t(d), _t(max_t), _t(tris), _t(mask, torch.bool), chunk=256)
    assert 0 < np.asarray(oj).sum() < 2000
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))


@pytest.mark.parametrize('has_spec', [False, True])
def test_bsdf_eval_pdf_matches_jax(has_spec):
    rng = np.random.default_rng(1)
    r = 4096
    n = _unit(rng, r)
    wo, wi = _unit(rng, r), _unit(rng, r)
    wo = np.where((wo * n).sum(-1, keepdims=True) < 0, -wo, wo)  # most pairs valid
    alb = rng.uniform(0, 1, (r, 3)).astype(np.float32)
    f0 = 0.08 * rng.uniform(0, 1, r).astype(np.float32)
    alpha = np.clip(rng.uniform(0, 1, r) ** 2, 1e-4, 1).astype(np.float32)
    p_spec = rng.uniform(0, 0.98, r).astype(np.float32)
    fj, pj = J._bsdf_eval_pdf(*map(jnp.asarray, (alb, f0, alpha, p_spec, n, wo, wi)), has_spec)
    ft, pt = T._bsdf_eval_pdf(*map(_t, (alb, f0, alpha, p_spec, n, wo, wi)), has_spec)
    assert (np.asarray(pj) > 0).sum() > r // 4
    _close(ft, fj, atol=1e-5)
    _close(pt, pj, atol=1e-5)


def test_small_functions_match_jax():
    rng = np.random.default_rng(2)
    n = _unit(rng, 1000)
    n[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1e-4, -1]]
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    for a, b in zip(T._onb(_t(n)), J._onb(jnp.asarray(n))):
        _close(a, b)
    nh = rng.uniform(0, 1, 1000).astype(np.float32)
    alpha = rng.uniform(1e-4, 1, 1000).astype(np.float32)
    _close(T._ggx_d(_t(nh), _t(alpha)), J._ggx_d(jnp.asarray(nh), jnp.asarray(alpha)),
           atol=1e-5)
    _close(T._smith_g1(_t(nh), _t(alpha)), J._smith_g1(jnp.asarray(nh), jnp.asarray(alpha)))
    pa, pb = (rng.uniform(0, 10, 1000).astype(np.float32) for _ in range(2))
    pa[:3] = 0
    _close(T._power_heuristic(_t(pa), _t(pb)),
           J._power_heuristic(jnp.asarray(pa), jnp.asarray(pb)))
    tris = rng.normal(size=(50, 3, 3)).astype(np.float32)
    mask = rng.uniform(size=50) > 0.2
    diffuse = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    emissive = np.where(rng.uniform(size=(50, 1)) > 0.7, 5.0, 0.0).astype(np.float32) * \
        rng.uniform(0, 1, (50, 3)).astype(np.float32)
    got = T._scene_arrays(_t(tris), _t(mask, torch.bool), _t(diffuse), _t(emissive))
    want = J._scene_arrays(*map(jnp.asarray, (tris, mask, diffuse, emissive)))
    for a, b in zip(got, want):
        _close(a, b)
    tex = rng.uniform(0, 2, (6, 13, 32, 32)).astype(np.float32)
    for a, b in zip(T.texture_to_materials(tex), J.texture_to_materials(tex)):
        _close(a, b)
    for a, b in zip(T.texture_to_materials(tex.astype(np.float16)),
                    J.texture_to_materials(tex.astype(np.float16))):
        assert a.dtype == torch.float16
        _close(a.float(), np.asarray(b, np.float32), rtol=1e-3)


def test_samplers_fed_jax_uniforms_match_jax():
    """_cosine_sample and _ggx_sample take their uniforms as arguments: fed
    the uniforms jax.random draws inside JAX's samplers from the same key,
    they give JAX's directions."""
    rng = np.random.default_rng(3)
    r = 2048
    n, wo = _unit(rng, r), _unit(rng, r)
    alpha = np.clip(rng.uniform(0, 1, r) ** 2, 1e-4, 1).astype(np.float32)
    key = jax.random.key(11)
    k1, k2 = jax.random.split(key)
    u1 = np.asarray(jax.random.uniform(k1, (r,)))
    u2 = np.asarray(jax.random.uniform(k2, (r,)))
    _close(T._cosine_sample(_t(u1), _t(u2), _t(n)), J._cosine_sample(key, jnp.asarray(n)),
           atol=1e-5)
    _close(T._ggx_sample(_t(u1), _t(u2), _t(n), _t(wo), _t(alpha)),
           J._ggx_sample(key, jnp.asarray(n), jnp.asarray(wo), jnp.asarray(alpha)),
           atol=1e-5)


def test_jittered_primary_rays_match_jax():
    """An emitter plane of 128 triangles, each with its own radiance, seen by
    JAX's path_trace at 1 spp and depth 1 (each pixel reads the emission of
    its primary hit exactly), against the port's primary rays fed the same
    jitter (drawn from JAX's key as path_trace draws it) and intersect."""
    quads = []
    for i in range(8):
        for j in range(8):
            quads.append(_quad([-1.6 + 0.4 * i, -1.6 + 0.4 * j, 0.0], [1, 0, 0], [0, 1, 0],
                               0.4))
    tris = np.concatenate(quads)
    n = len(tris)
    emissive = np.random.default_rng(4).uniform(0.5, 5, (n, 3)).astype(np.float32)
    c2w = _look_at_z(3.0)
    c2w[:3, :3] = _rot_y(0.2)
    c2w[:3, 3] = [0.4, 0.1, 3.0]
    fov, res, key = np.float32(np.deg2rad(45.0)), 16, jax.random.key(5)
    img = np.asarray(J.path_trace(jnp.asarray(tris), _flat_vn(tris), jnp.ones(n, bool),
                                  jnp.zeros((n, 3)), jnp.asarray(emissive), jnp.asarray(c2w),
                                  jnp.float32(fov), key, resolution=res, spp=1, max_depth=1))
    _, kj = jax.random.split(key)
    k_jit, _ = jax.random.split(jax.random.split(kj, 1)[0])
    jx = np.asarray(jax.random.uniform(k_jit, (res, res, 2)))
    o, d = T._primary_rays(_t(jx), _t(c2w), fov, res)
    t, idx, hit = T.intersect(o, d, _t(tris), torch.ones(n, dtype=torch.bool))
    got = torch.where(hit[:, None], _t(emissive)[idx], 0.0).reshape(res, res, 3).numpy()
    assert 0 < hit.sum() < res * res
    _close(got, img, atol=0)


# ---------------------------------------------------------------------------
# light sampling
# ---------------------------------------------------------------------------

def test_light_draw_never_picks_a_zero_pdf_triangle():
    rng = np.random.default_rng(6)
    pdf = rng.uniform(0, 1, 300).astype(np.float32)
    pdf[rng.uniform(size=300) < 0.6] = 0.0
    pdf[:5] = 0.0
    pdf[-40:] = 0.0  # padding at the end
    pdf /= pdf.sum()
    cdf = np.cumsum(pdf, dtype=np.float32)
    edges = [0.0, np.nextafter(np.float32(1), np.float32(0)), *(cdf / cdf[-1])[:-1]]
    u = np.concatenate([np.asarray(edges, np.float32),
                        rng.uniform(0, 1, 400_000).astype(np.float32)])
    li = T._sample_lights(_t(u), _t(pdf)).numpy()
    assert (pdf[li] > 0).all()
    freq = np.bincount(li[len(edges):], minlength=300) / (len(u) - len(edges))
    np.testing.assert_allclose(freq, pdf, atol=3e-3)
    # a scene with one light triangle draws it always, and one with none
    # draws an index in range (NEE then adds nothing)
    one = np.zeros(10, np.float32)
    one[7] = 1.0
    assert (T._sample_lights(_t(u[:1000]), _t(one)).numpy() == 7).all()
    none = T._sample_lights(_t(u[:1000]), torch.zeros(10)).numpy()
    assert ((none >= 0) & (none < 10)).all()


# ---------------------------------------------------------------------------
# physics: the checks of tests/test_path_tracer.py on the port
# ---------------------------------------------------------------------------

def _look_at_z(dist=3.0):
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = dist
    return c2w


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _down(y):
    """A camera at height y looking straight down -y."""
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.stack([np.array([1, 0, 0]), np.array([0, 0, -1]),
                            np.array([0, 1, 0])], axis=1)
    c2w[1, 3] = y
    return c2w


def _quad(center, u, v, size):
    c = np.asarray(center, np.float32)
    u = np.asarray(u, np.float32) * size / 2
    v = np.asarray(v, np.float32) * size / 2
    p00, p01, p10, p11 = c - u - v, c - u + v, c + u - v, c + u + v
    return np.stack([np.stack([p00, p10, p11]), np.stack([p00, p11, p01])]).astype(np.float32)


def _flat_vn(tris):
    t = np.asarray(tris)
    n = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    return np.repeat(n[:, None, :], 3, axis=1).astype(np.float32)


def _emissive_box(L=1.0, size=6.0):
    s = size / 2
    faces = [_quad(c, u, v, size) for c, u, v in [
        ([0, -s, 0], [1, 0, 0], [0, 0, -1]), ([0, s, 0], [1, 0, 0], [0, 0, 1]),
        ([0, 0, -s], [1, 0, 0], [0, 1, 0]), ([0, 0, s], [-1, 0, 0], [0, 1, 0]),
        ([-s, 0, 0], [0, 0, 1], [0, 1, 0]), ([s, 0, 0], [0, 0, -1], [0, 1, 0])]]
    tris = np.concatenate(faces)
    return tris, np.zeros((len(tris), 3), np.float32), np.full((len(tris), 3), L, np.float32)


def _trace(tris, diffuse, emissive, c2w, fov_deg, seed, vn=None, mask=None, **kw):
    n = len(tris)
    for k in ('specular', 'roughness'):
        if kw.get(k) is not None:
            kw[k] = _t(kw[k])
    return T.path_trace(
        _t(tris), _t(_flat_vn(tris) if vn is None else vn),
        torch.ones(n, dtype=torch.bool) if mask is None else _t(mask, torch.bool),
        _t(diffuse), _t(emissive), _t(c2w), np.float32(np.deg2rad(fov_deg)),
        torch.Generator().manual_seed(seed), **kw).numpy()


def _primary_emission():
    tris = _quad([0, 0, 0], [1, 0, 0], [0, 1, 0], 2.0)
    img = _trace(tris, np.zeros((2, 3)), [[2.0, 3.0, 4.0]] * 2, _look_at_z(), 40.0, 0,
                 resolution=16, spp=2, max_depth=1)
    np.testing.assert_allclose(img[8, 8], [2.0, 3.0, 4.0], rtol=1e-5)


def _small_light_scene(tilt=None):
    floor = _quad([0, 0, 0], [1, 0, 0], [0, 0, -1], 4.0)
    h, s, E = 2.0, 0.05, 500.0
    light = _quad([0, h, 0], [1, 0, 0], [0, 0, 1], s)
    tris = np.concatenate([floor, light])
    diffuse = np.asarray([[0.6, 0.5, 0.4]] * 2 + [[0.0] * 3] * 2, np.float32)
    emissive = np.asarray([[0.0] * 3] * 2 + [[E] * 3] * 2, np.float32)
    vn = _flat_vn(tris)
    if tilt is not None:
        vn[0:2] = [np.sin(tilt), np.cos(tilt), 0.0]
    want = diffuse[0] / np.pi * E * (s * s) / (h * h) * (1.0 if tilt is None else np.cos(tilt))
    return tris, diffuse, emissive, vn, want


def _direct_lighting():
    tris, diffuse, emissive, vn, want = _small_light_scene()
    img = _trace(tris, diffuse, emissive, _down(1.0), 30.0, 1, resolution=8, spp=128,
                 max_depth=1)
    np.testing.assert_allclose(img[4, 4], want, rtol=0.08)


def _shading_normals():
    tris, diffuse, emissive, vn, want = _small_light_scene(tilt=np.deg2rad(30.0))
    img = _trace(tris, diffuse, emissive, _down(1.0), 30.0, 8, vn=vn, resolution=8,
                 spp=128, max_depth=1)
    np.testing.assert_allclose(img[4, 4], want, rtol=0.08)


def _shadowing():
    floor = _quad([0, 0, 0], [1, 0, 0], [0, 0, -1], 4.0)
    light = _quad([0, 2.0, 0], [1, 0, 0], [0, 0, 1], 0.3)
    blocker = _quad([0, 1.0, 0], [1, 0, 0], [0, 0, 1], 1.2)
    E = 200.0

    def render(with_blocker):
        parts = [floor, light] + ([blocker] if with_blocker else [])
        tris = np.concatenate(parts)
        diffuse = [[0.6] * 3] * 2 + [[0.0] * 3] * (len(tris) - 2)
        emissive = [[0.0] * 3] * 2 + [[E] * 3] * 2 + [[0.0] * 3] * (len(tris) - 4)
        return _trace(tris, diffuse, emissive, _down(0.5), 50.0, 2, resolution=8, spp=64,
                      max_depth=1)

    lit, shadowed = render(False)[4, 4], render(True)[4, 4]
    assert lit.mean() > 1e-3
    assert shadowed.mean() < 0.05 * lit.mean(), (lit, shadowed)


def _furnace(spec, rough, lo, hi):
    L = 2.0
    box_t, box_d, box_e = _emissive_box(L)
    tris = np.concatenate([box_t, _quad([0, 0, 0], [1, 0, 0], [0, 1, 0], 1.0)])
    n = len(tris)
    diffuse = np.concatenate([box_d, np.ones((2, 3), np.float32)])
    emissive = np.concatenate([box_e, np.zeros((2, 3), np.float32)])
    kw = {} if spec is None else dict(specular=np.full(n, spec, np.float32),
                                      roughness=np.full(n, rough, np.float32))
    img = _trace(tris, diffuse, emissive, _look_at_z(2.0), 20.0, 5, resolution=8, spp=512,
                 max_depth=4, **kw)
    center = img[3:5, 3:5].mean()
    assert lo * L <= center <= hi * L, (center, L, lo, hi)


PHYSICS = {
    'primary_emission_exact': _primary_emission,
    'direct_lighting_analytic': _direct_lighting,
    'shading_normals_interpolated': _shading_normals,
    'shadowing': _shadowing,
    # the bars of tests/test_path_tracer.py::test_furnace
    'furnace_lambertian': lambda: _furnace(None, None, 0.97, 1.03),
    'furnace_f0_0.04_rough_0.6': lambda: _furnace(0.5, 0.6, 0.90, 1.02),
    'furnace_f0_0.08_rough_0.3': lambda: _furnace(1.0, 0.3, 0.90, 1.02),
    'furnace_f0_0.08_rough_0.6': lambda: _furnace(1.0, 0.6, 0.88, 1.02),
}


@pytest.mark.parametrize('check', sorted(PHYSICS))
def test_physics(check):
    PHYSICS[check]()


# ---------------------------------------------------------------------------
# statistics: a small closed box against JAX's path_trace
# ---------------------------------------------------------------------------

def glossy_box():
    """A closed Cornell-like box of 14 triangles (an inward-facing cube, red
    and green side walls, a small light 0.3 under the ceiling, facing down)
    with a GGX floor; camera inside looking at the back wall.  A light
    nearer the ceiling lights it through its back from a few hundredths
    away (NEE takes |cos| at the light), and the rare fireflies of that
    would swamp the comparison."""
    walls = [  # centre, u, v (u x v points into the box), albedo
        ([0, -1, 0], [1, 0, 0], [0, 0, -1], [0.7, 0.7, 0.7]),   # floor (glossy)
        ([0, 1, 0], [1, 0, 0], [0, 0, 1], [0.7, 0.7, 0.7]),     # ceiling
        ([0, 0, -1], [1, 0, 0], [0, 1, 0], [0.7, 0.7, 0.7]),    # back
        ([0, 0, 1], [-1, 0, 0], [0, 1, 0], [0.7, 0.7, 0.7]),    # front
        ([-1, 0, 0], [0, 0, 1], [0, 1, 0], [0.7, 0.1, 0.1]),    # left
        ([1, 0, 0], [0, 0, -1], [0, 1, 0], [0.1, 0.7, 0.1])]    # right
    tris, diffuse, emissive, spec, rough = [], [], [], [], []
    for i, (c, u, v, alb) in enumerate(walls):
        tris.append(_quad(c, u, v, 2.0))
        diffuse += [alb] * 2
        emissive += [[0.0] * 3] * 2
        spec += [1.0 if i == 0 else 0.1] * 2
        rough += [0.3 if i == 0 else 0.9] * 2
    tris.append(_quad([0, 0.7, 0], [1, 0, 0], [0, 0, 1], 0.5))
    diffuse += [[0.0] * 3] * 2
    emissive += [[30.0] * 3] * 2
    spec += [0.0] * 2
    rough += [1.0] * 2
    tris = np.concatenate(tris)
    c2w = _look_at_z(0.9)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return tris, f32(diffuse), f32(emissive), c2w, f32(spec), f32(rough)


def block_means(img, b=4):
    h, w, c = img.shape
    return img.reshape(h // b, b, w // b, b, c).mean(axis=(1, 3))


def test_statistical_render_matches_jax():
    """The port's NEE+MIS render of the glossy box against JAX's path_trace
    at 16^2, 128 spp, depth 3: the 4x4-block means within 2x the largest
    block difference between two JAX seeds (the image means, whose spread
    between JAX seeds is ~2 % here, within 5 %)."""
    tris, diffuse, emissive, c2w, spec, rough = glossy_box()
    n = len(tris)
    kw = dict(resolution=16, spp=128, max_depth=3)
    jargs = (jnp.asarray(tris), jnp.asarray(_flat_vn(tris)), jnp.ones(n, bool),
             jnp.asarray(diffuse), jnp.asarray(emissive), jnp.asarray(c2w),
             jnp.float32(np.deg2rad(60.0)))
    ja, jb = (np.asarray(J.path_trace(*jargs, jax.random.key(s), specular=jnp.asarray(spec),
                                      roughness=jnp.asarray(rough), **kw)) for s in (0, 1))
    got = _trace(tris, diffuse, emissive, c2w, 60.0, 0, specular=spec, roughness=rough, **kw)
    assert np.isfinite(got).all() and (got >= 0).all()
    noise = np.abs(block_means(ja) - block_means(jb)).max()
    err = np.abs(block_means(got) - block_means(ja)).max()
    assert err <= 2 * noise, (err, noise)
    assert abs(got.mean() / ja.mean() - 1) <= 0.05, (got.mean(), ja.mean())
