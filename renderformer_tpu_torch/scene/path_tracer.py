"""Monte-Carlo path tracer for ground truth, in PyTorch on the card (the JAX
package's ``scene/path_tracer.py``).

The reference implementation takes its ground truth from Blender (its
``scene_processor/render_scene.py``).  This module computes the same light
transport as the JAX package's path tracer: area-light path tracing with
next-event estimation (NEE) over the emissive triangles, a principled-lite
BSDF (Lambertian diffuse from the per-triangle colour plus a GGX specular
lobe, F0 = 0.08 * specular level, Smith G, Schlick Fresnel), shading
normals interpolated from the scene's ``vn``, and NEE and BSDF samples
combined by the power heuristic.  Black environment, constant per-face
materials, linear HDR radiance out.

It runs on the device of its inputs: the card unless the caller asks for
the CPU.  The intersection is a [rays x triangles] Möller–Trumbore sweep
over triangle chunks in the determinant form of the JAX code, each
[R, 3] x [3, C] product done as three broadcast multiply-adds in fp32, so
that no TF32 setting of the caller can round it (a matmul would go through
cuBLAS, which ``allow_tf32`` turns to 10-bit mantissas).  Samples and
bounces are Python loops over fixed shapes: dead rays are computed too, so
the image does not depend on any compaction, and nothing in the loops
reads a value back to the host.  The uniforms come from a
``torch.Generator`` on the inputs' device; the sampling helpers take them
as arguments.  The light triangle is drawn by an inverse CDF (a triangle
of zero pdf is never drawn) where the JAX code calls
``jax.random.categorical``, so the two agree in distribution, not in bits.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

EPS = 1e-6
# rays traced together: samples of a small image share a pass up to this
# count; the intersection's temporaries take RAYS_PER_PASS x chunk x 4 bytes
# each (128 MiB at the default chunk)
RAYS_PER_PASS = 1 << 16


# ---------------------------------------------------------------------------
# Intersection
# ---------------------------------------------------------------------------

def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _dot3(x, yt):
    """x [R, 3] against yt [3, C] -> [R, C], as broadcast multiply-adds."""
    out = x[:, 0:1] * yt[0]
    out.addcmul_(x[:, 1:2], yt[1])
    return out.addcmul_(x[:, 2:3], yt[2])


def _norm(x, keepdim=False):
    return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim)


def _mt_chunk(rays_o, rays_d, wo, tri_pre, valid):
    """Möller–Trumbore for one triangle chunk, determinant form:

        a     = det[e1, d, e2] = -(d . n2)       n2 = e1 x e2
        t_num = det[s, e1, e2] = o . n2 - c0     c0 = v0 . n2
        u_num = det[s, d, e2]  = wo . e2 - d . m2,  m2 = e2 x v0
        v_num = det[d, s, e1]  = d . m1 - wo . e1,  m1 = e1 x v0
    with s = o - v0 and the per-ray vector wo = o x d.

    rays_o/rays_d/wo [R, 3]; tri_pre = (e1T, e2T, n2T, m1T, m2T, c0) with
    *T [3, C] and c0 [C]; valid [C].  Returns t [R, C] (+inf where missed).
    """
    e1t, e2t, n2t, m1t, m2t, c0 = tri_pre
    a = -_dot3(rays_d, n2t)
    t_num = _dot3(rays_o, n2t) - c0[None, :]
    u_num = _dot3(wo, e2t) - _dot3(rays_d, m2t)
    v_num = _dot3(rays_d, m1t) - _dot3(wo, e1t)
    ok_a = a.abs() > EPS
    inv = torch.where(ok_a, 1.0 / torch.where(ok_a, a, 1.0), 0.0)
    t = t_num * inv
    u = u_num * inv
    v = v_num * inv
    ok = ok_a & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-4) & valid[None, :]
    return torch.where(ok, t, math.inf)


def _tri_precompute(tris, mask, chunk: int):
    """Pad the soup to a chunk multiple and precompute the transposed
    per-triangle vectors the determinant-form MT reads: (e1T, e2T, n2T, m1T,
    m2T [nc, 3, chunk], c0, valid [nc, chunk], base [nc], each chunk's first
    triangle)."""
    n = tris.shape[0]
    chunk = max(1, min(chunk, n))  # a soup smaller than a chunk is one chunk
    pad = (-n) % chunk
    if pad:
        tris = torch.cat([tris, tris.new_zeros((pad, 3, 3))])
        mask = torch.cat([mask, mask.new_zeros((pad,))])
    nc = tris.shape[0] // chunk
    v0 = tris[:, 0]
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    n2 = _cross(e1, e2)
    m1 = _cross(e1, v0)
    m2 = _cross(e2, v0)
    c0 = (v0 * n2).sum(-1)

    def chunked_t(x):   # [nc*chunk, 3] -> [nc, 3, chunk]
        return x.reshape(nc, chunk, 3).transpose(1, 2).contiguous()

    return (chunked_t(e1), chunked_t(e2), chunked_t(n2), chunked_t(m1),
            chunked_t(m2), c0.reshape(nc, chunk), mask.reshape(nc, chunk),
            torch.arange(nc, device=tris.device) * chunk)


def intersect(rays_o, rays_d, tris, mask, chunk: int = 512, pre=None):
    """Nearest hit of each ray against the triangle soup.

    rays_o/rays_d [R, 3]; tris [N, 3, 3]; mask [N] bool.  Returns (t [R],
    tri_idx [R] int64, hit [R] bool).  A loop over triangle chunks keeps
    the temporaries at [R, chunk].  ``pre`` (from _tri_precompute) reuses
    the per-triangle vectors across bounces and samples.
    """
    if pre is None:
        pre = _tri_precompute(tris, mask, chunk)
    e1t, e2t, n2t, m1t, m2t, c0, cvalid, base = pre
    wo = _cross(rays_o, rays_d)
    best_t = torch.full(rays_o.shape[:1], math.inf, device=rays_o.device)
    best_i = torch.zeros(rays_o.shape[:1], dtype=torch.int64, device=rays_o.device)
    for c in range(e1t.shape[0]):
        t = _mt_chunk(rays_o, rays_d, wo, (e1t[c], e2t[c], n2t[c], m1t[c], m2t[c], c0[c]),
                      cvalid[c])
        tmin, imin = t.min(dim=1)
        better = tmin < best_t
        best_t = torch.where(better, tmin, best_t)
        best_i = torch.where(better, imin + base[c], best_i)
    return best_t, best_i, torch.isfinite(best_t)


def occluded(rays_o, rays_d, max_t, tris, mask, chunk: int = 512, pre=None):
    """True where the segment [o, o + max_t*d) hits any triangle."""
    t, _, hit = intersect(rays_o, rays_d, tris, mask, chunk, pre=pre)
    return hit & (t < max_t * (1.0 - 1e-3))


# ---------------------------------------------------------------------------
# Sampling helpers (the uniforms come in as arguments)
# ---------------------------------------------------------------------------

def _onb(n):
    """Orthonormal basis around unit normals n [R, 3] (Frisvad)."""
    sign = torch.where(n[:, 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t1 = torch.stack([1.0 + sign * n[:, 0] ** 2 * a, sign * b, -sign * n[:, 0]], dim=-1)
    t2 = torch.stack([b, sign + n[:, 1] ** 2 * a, -n[:, 1]], dim=-1)
    return t1, t2


def _cosine_sample(u1, u2, n):
    """Cosine-weighted hemisphere directions around normals n [R, 3], from
    uniforms u1, u2 [R]."""
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    t1, t2 = _onb(n)
    d = (r[:, None] * torch.cos(phi)[:, None] * t1
         + r[:, None] * torch.sin(phi)[:, None] * t2
         + torch.sqrt(torch.clamp(1.0 - u1, min=0.0))[:, None] * n)
    return d / _norm(d, keepdim=True)


def _ggx_sample(u1, u2, n, wo, alpha):
    """Sample wi by reflecting wo about a GGX-NDF half-vector around unit
    normals n [R, 3]; alpha [R]; uniforms u1, u2 [R]."""
    a2 = alpha * alpha
    cth = torch.sqrt(torch.clamp((1.0 - u1) / (1.0 + (a2 - 1.0) * u1), 0.0, 1.0))
    sth = torch.sqrt(torch.clamp(1.0 - cth * cth, min=0.0))
    phi = 2.0 * math.pi * u2
    t1, t2 = _onb(n)
    h = (sth[:, None] * torch.cos(phi)[:, None] * t1
         + sth[:, None] * torch.sin(phi)[:, None] * t2
         + cth[:, None] * n)
    wi = 2.0 * (wo * h).sum(-1, keepdim=True) * h - wo
    return wi / torch.clamp(_norm(wi, keepdim=True), min=EPS)


def _ggx_d(nh, alpha):
    """Trowbridge-Reitz NDF; nh, alpha [R]."""
    a2 = alpha * alpha
    den = nh * nh * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(math.pi * den * den, min=EPS)


def _smith_g1(c, alpha):
    a2 = alpha * alpha
    return 2.0 * c / torch.clamp(c + torch.sqrt(a2 + (1.0 - a2) * c * c), min=EPS)


def _bsdf_eval_pdf(alb, f0, alpha, p_spec, n, wo, wi, has_specular):
    """Principled-lite BSDF (diffuse + GGX specular, metallic=0).

    alb [R,3]; f0/alpha/p_spec [R]; n/wo/wi [R,3] unit (n = shading normal,
    wo points AWAY from the surface toward the viewer).  Returns (f [R,3],
    pdf [R]) with pdf matching the lobe-mixture sampler (p_spec GGX-NDF +
    (1-p_spec) cosine); both zero where the direction pair is invalid
    (below the hemisphere).
    """
    nwo = (n * wo).sum(-1)
    nwi = (n * wi).sum(-1)
    pdf_cos = torch.clamp(nwi, min=0.0) / math.pi
    valid = (nwi > 0.0) & (nwo > 0.0)
    if not has_specular:
        f = torch.where(valid[:, None], alb / math.pi, 0.0)
        return f, torch.where(valid, pdf_cos, 0.0)
    h = wo + wi
    h = h / torch.clamp(_norm(h, keepdim=True), min=EPS)
    nh = torch.clamp((n * h).sum(-1), 0.0, 1.0)
    hwo = torch.clamp((h * wo).sum(-1), 0.0, 1.0)
    fres = f0 + (1.0 - f0) * (1.0 - hwo) ** 5
    d = _ggx_d(nh, alpha)
    g = (_smith_g1(torch.clamp(nwo, EPS, 1.0), alpha)
         * _smith_g1(torch.clamp(nwi, EPS, 1.0), alpha))
    spec = d * g * fres / torch.clamp(4.0 * nwo * nwi, min=EPS)
    # diffuse-specular coupling: the symmetric (1-F(n.wi))(1-F(n.wo)) keeps
    # the lobes' sum from creating energy (the furnace test)
    k_in = 1.0 - (f0 + (1.0 - f0) * (1.0 - torch.clamp(nwi, 0.0, 1.0)) ** 5)
    k_out = 1.0 - (f0 + (1.0 - f0) * (1.0 - torch.clamp(nwo, 0.0, 1.0)) ** 5)
    f = alb / math.pi * (k_in * k_out)[:, None] + spec[:, None]
    pdf_ggx = d * nh / torch.clamp(4.0 * hwo, min=EPS)
    pdf = p_spec * pdf_ggx + (1.0 - p_spec) * pdf_cos
    return torch.where(valid[:, None], f, 0.0), torch.where(valid, pdf, 0.0)


def _power_heuristic(pa, pb):
    """Veach power heuristic (beta=2) for the pa-sampled strategy."""
    a2 = pa * pa
    return a2 / torch.clamp(a2 + pb * pb, min=EPS)


def _sample_lights(u, light_pdf):
    """Light triangle indices [R] from uniforms u [R] by the inverse CDF of
    light_pdf [N]: searchsorted into its running sum, right=True, so a
    triangle of zero pdf (a flat step of the sum) is never drawn; a value
    at the sum's end (rounding) goes to the last triangle of positive pdf."""
    cdf = torch.cumsum(light_pdf, 0)
    li = torch.searchsorted(cdf, u * cdf[-1], right=True)
    idx = torch.arange(light_pdf.shape[0], device=light_pdf.device)
    last = torch.where(light_pdf > 0, idx, 0).amax()
    return torch.minimum(li, last)


def _primary_rays(jx, c2w, fov_rad, res: int):
    """Jittered primary rays in utils/rays.py's Blender convention (-Z
    forward): dirs = [(x-cx)/f, -(y-cy)/f, -1], rotated by c2w.  jx
    [res, res, 2] uniforms; returns rays_o, rays_d [res*res, 3]."""
    ar = torch.arange(res, dtype=torch.float32, device=jx.device)
    ii = (ar[:, None] + jx[..., 0]) / res * 2.0 - 1.0      # y in [-1, 1)
    jj = (ar[None, :] + jx[..., 1]) / res * 2.0 - 1.0      # x
    tanh = torch.tan(torch.as_tensor(fov_rad, dtype=torch.float32, device=jx.device) / 2.0)
    dirs = torch.stack([jj * tanh, -ii * tanh, -torch.ones_like(ii)], dim=-1)
    dirs = dirs / _norm(dirs, keepdim=True)
    # c2w[:3, :3] @ dir as multiply-adds, not a matmul (TF32)
    rays_d = (dirs[..., None, :] * c2w[:3, :3]).sum(-1).reshape(-1, 3)
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d


# ---------------------------------------------------------------------------
# Path tracing
# ---------------------------------------------------------------------------

def _scene_arrays(tris, mask, diffuse, emissive):
    """Per-triangle derived quantities (normals, areas, light pdf)."""
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    fn = _cross(e1, e2)
    area2 = _norm(fn)                                    # 2 * area
    normal = fn / torch.clamp(area2, min=EPS)[:, None]
    area = 0.5 * area2
    lum = emissive.sum(-1) * area * mask.to(area.dtype)
    total = lum.sum()
    pdf = torch.where(total > 0, lum / torch.clamp(total, min=EPS), 0.0)
    return normal, area, pdf, total


@torch.inference_mode()
def path_trace(tris, vn, mask, diffuse, emissive, c2w, fov_rad, generator: torch.Generator,
               resolution: int = 256, spp: int = 64, max_depth: int = 3,
               chunk: int = 512, nee: bool = True, clamp: float = 0.0,
               specular=None, roughness=None):
    """Render one view by path tracing, on the device of ``tris``.

    tris [N,3,3] f32, vn [N,3,3] per-vertex shading normals (barycentric
    interpolated; flat-shaded scenes store the face normal three times),
    mask [N] bool, diffuse [N,3], emissive [N,3] (radiance), c2w [4,4],
    fov_rad a scalar; ``generator`` a torch.Generator on the same device.
    Returns HDR [res, res, 3] f32.

    ``specular`` [N] (Specular IOR Level, F0 = 0.08 * level) and
    ``roughness`` [N] enable the GGX lobe; both None keeps the Lambertian
    BRDF.  Shading normals from vn are used either way.

    ``nee=False`` disables next-event estimation (emission collected on
    every hit: the brute-force estimator, same expectation, higher
    variance).  ``clamp`` > 0 clips each indirect light contribution
    elementwise, NEE samples and non-primary BSDF-sample emission pickups
    alike (firefly suppression, slightly biased; 0 keeps the estimator
    unbiased).  Primary-hit emission is never clamped.  ``chunk``
    triangles a step of the intersection: its temporaries take
    rays x chunk x 4 bytes each, with max(res^2, RAYS_PER_PASS) rays.
    The image is the running mean acc + (s - acc) / (i + 1) of the samples
    in order.
    """
    dev = tris.device
    res = resolution
    has_spec = specular is not None
    normal, area, light_pdf, _ = _scene_arrays(tris, mask, diffuse, emissive)
    if has_spec:
        f0_tri = 0.08 * torch.clamp(specular, min=0.0)
        alpha_tri = torch.clamp(roughness * roughness, 1e-4, 1.0)
    else:
        f0_tri = torch.zeros(tris.shape[:1], device=dev)
        alpha_tri = torch.ones(tris.shape[:1], device=dev)
    pre = _tri_precompute(tris, mask, chunk)  # shared by all rays
    light_e = emissive.sum(-1) > 0

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    def bounce(o, d, radiance, throughput, alive, prev_pdf, is_last):
        r = o.shape[0]
        t, idx, hit = intersect(o, d, tris, mask, chunk, pre=pre)
        hit = hit & alive
        p = o + t[:, None] * torch.where(hit[:, None], d, 0.0)
        n_g = normal[idx]
        # face the incoming ray
        flip = (n_g * d).sum(-1) > 0
        n_g = torch.where(flip[:, None], -n_g, n_g)

        # barycentrics of the hit -> interpolated SHADING normal
        tv = tris[idx]
        e1 = tv[:, 1] - tv[:, 0]
        e2 = tv[:, 2] - tv[:, 0]
        sv = o - tv[:, 0]
        pv = _cross(d, e2)
        det = (e1 * pv).sum(-1)
        ok_det = det.abs() > EPS
        inv = torch.where(ok_det, 1.0 / torch.where(ok_det, det, 1.0), 0.0)
        bu = (sv * pv).sum(-1) * inv
        bv = (d * _cross(sv, e1)).sum(-1) * inv
        vns = vn[idx]
        ns = (vns[:, 0] * (1.0 - bu - bv)[:, None]
              + vns[:, 1] * bu[:, None] + vns[:, 2] * bv[:, None])
        nsl = _norm(ns)
        ns = torch.where((nsl > 1e-4)[:, None], ns / torch.clamp(nsl, min=EPS)[:, None], n_g)
        # keep the shading normal on the geometric side we shade
        ns = torch.where(((ns * n_g).sum(-1) < 0)[:, None], -ns, ns)

        alb = diffuse[idx]
        emis = emissive[idx]
        f0 = f0_tri[idx]
        alpha = alpha_tri[idx]
        wo = -d
        nwo = torch.clamp((ns * wo).sum(-1), 0.0, 1.0)
        if has_spec:
            # lobe-selection probability from view-angle Fresnel vs the
            # diffuse albedo's weight
            f_view = f0 + (1.0 - f0) * (1.0 - nwo) ** 5
            w_d = alb.mean(-1) * (1.0 - f_view)
            p_spec = torch.clamp(f_view / torch.clamp(f_view + w_d, min=EPS), 0.0, 0.98)
        else:
            p_spec = torch.zeros((r,), device=dev)

        # emission at the hit, MIS-weighted against the NEE strategy that
        # could have sampled this same light point
        if nee:
            cos_l = ((normal[idx] * d).sum(-1)).abs()
            pdf_l_here = (light_pdf[idx] / torch.clamp(area[idx], min=EPS)
                          * t * t / torch.clamp(cos_l, min=EPS))
            w_emis = torch.where((prev_pdf < 0) | (pdf_l_here <= 0), 1.0,
                                 _power_heuristic(torch.clamp(prev_pdf, min=0.0), pdf_l_here))
        else:
            w_emis = torch.ones((r,), device=dev)
        emis_contrib = throughput * emis * w_emis[:, None]
        if clamp > 0.0:
            # the clamp covers the BSDF-sampled emission pickup too; primary
            # hits (prev_pdf < 0) stay unclamped, so looking straight at a
            # light reads its radiance
            emis_contrib = torch.where((prev_pdf >= 0)[:, None],
                                       torch.clamp(emis_contrib, max=clamp), emis_contrib)
        radiance = radiance + torch.where(hit[:, None], emis_contrib, 0.0)

        if nee:
            # --- next-event estimation over emissive triangles ---
            li = _sample_lights(rand(r), light_pdf)
            u12 = rand(r, 2)
            su = torch.sqrt(u12[:, 0])
            b0 = 1.0 - su
            b1 = u12[:, 1] * su
            tl = tris[li]
            lp = (tl[:, 0] * b0[:, None] + tl[:, 1] * b1[:, None]
                  + tl[:, 2] * (1.0 - b0 - b1)[:, None])
            ln = normal[li]
            wi = lp - p
            dist = _norm(wi)
            wi = wi / torch.clamp(dist, min=EPS)[:, None]
            cos_s = (ns * wi).sum(-1)
            cos_l = ((ln * wi).sum(-1)).abs()
            # solid-angle pdf of the sampled light point
            pdf_a = light_pdf[li] / torch.clamp(area[li], min=EPS)
            pdf_l = pdf_a * dist * dist / torch.clamp(cos_l, min=EPS)
            f_l, pdf_b_l = _bsdf_eval_pdf(alb, f0, alpha, p_spec, ns, wo, wi, has_spec)
            nee_valid = hit & (cos_s > 0) & (pdf_a > 0) & light_e[li]
            shad = occluded(p + n_g * 1e-3, wi, dist - 2e-3, tris, mask, chunk, pre=pre)
            # on the last bounce the BSDF-sample emission pickup that
            # complements NEE never runs, so NEE carries the full weight
            w_mis = 1.0 if is_last else _power_heuristic(pdf_l, pdf_b_l)
            contrib = (throughput * f_l * emissive[li]
                       * (cos_s * w_mis / torch.clamp(pdf_l, min=EPS))[:, None])
            if clamp > 0.0:
                contrib = torch.clamp(contrib, max=clamp)
            radiance = radiance + torch.where((nee_valid & ~shad)[:, None], contrib, 0.0)

        # --- continue the path: sample the BSDF lobe mixture ---
        new_d = _cosine_sample(rand(r), rand(r), ns)
        if has_spec:
            d_spec = _ggx_sample(rand(r), rand(r), ns, wo, alpha)
            take_spec = rand(r) < p_spec
            new_d = torch.where(take_spec[:, None], d_spec, new_d)
        f_s, pdf_s = _bsdf_eval_pdf(alb, f0, alpha, p_spec, ns, wo, new_d, has_spec)
        nwi_s = torch.clamp((ns * new_d).sum(-1), 0.0, 1.0)
        weight = torch.where((pdf_s > EPS)[:, None],
                             f_s * (nwi_s / torch.clamp(pdf_s, min=EPS))[:, None], 0.0)
        new_o = p + n_g * 1e-3
        throughput = throughput * torch.where(hit[:, None], weight, 0.0)
        alive = hit & (throughput.amax(-1) > 1e-4)
        return new_o, new_d, radiance, throughput, alive, torch.where(hit, pdf_s, -1.0)

    def render_samples(k):
        """k samples of every pixel, traced together: [k, res, res, 3]."""
        rays = [_primary_rays(rand(res, res, 2), c2w, fov_rad, res) for _ in range(k)]
        o = torch.cat([x[0] for x in rays])
        d = torch.cat([x[1] for x in rays])
        r = d.shape[0]
        radiance = torch.zeros((r, 3), device=dev)
        throughput = torch.ones((r, 3), device=dev)
        alive = torch.ones((r,), dtype=torch.bool, device=dev)
        # solid-angle pdf of the strategy that made the current ray; -1 =
        # deterministic (primary) -> emission weighted 1
        prev_pdf = torch.full((r,), -1.0, device=dev)
        for b in range(max_depth):
            o, d, radiance, throughput, alive, prev_pdf = bounce(
                o, d, radiance, throughput, alive, prev_pdf, b == max_depth - 1)
        return radiance.reshape(k, res, res, 3)

    # small images trace several samples a pass, up to RAYS_PER_PASS rays
    per_pass = max(1, RAYS_PER_PASS // (res * res))
    img = torch.zeros((res, res, 3), device=dev)
    i = 0
    while i < spp:
        for s in render_samples(min(per_pass, spp - i)):
            img = img + (s - img) / (i + 1.0)
            i += 1
    return img


# ---------------------------------------------------------------------------
# Scene-level convenience (the H5 layout)
# ---------------------------------------------------------------------------

def texture_to_materials(texture, patch_mask: Optional[np.ndarray] = None):
    """Per-face constant materials from 13-channel patches [N,13,ps,ps]: the
    mean over the valid (lower-triangle, x+y<=ps) texel region.

    Channel layout (the reference's ``scene_processor/to_h5.py``): 0-2
    diffuse, 3-5 specular, 6 roughness, 7-9 normal, 10-12 emissive.  Returns
    tensors on the texture's device (a numpy texture: the CPU): diffuse
    [N,3], specular level [N] (the mean of the specular channels, the
    reference's Specular IOR Level mapping), roughness [N], emissive [N,3].
    """
    tex = torch.as_tensor(texture)
    ps = tex.shape[-1]
    if patch_mask is None:
        ii = np.arange(ps)
        patch_mask = (ii[:, None] + ii[None, :]) <= ps
    m = torch.as_tensor(np.asarray(patch_mask), device=tex.device).to(tex.dtype)
    denom = torch.clamp(m.sum(), min=1.0)
    means = (tex * m).sum(dim=(-1, -2)) / denom       # [N, 13]
    return means[:, 0:3], means[:, 3:6].mean(-1), means[:, 6], means[:, 10:13]


def render_scene_pathtrace(scene: dict, view: int = 0, resolution: int = 256, spp: int = 64,
                           max_depth: int = 3, seed: int = 0, clamp: float = 0.0,
                           lambertian: bool = False, device=None,
                           generator: Optional[torch.Generator] = None, chunk: int = 512):
    """Path-trace one view of a loaded scene dict (``io/h5.load_scene_h5``'s
    layout) on ``device``: ``cuda`` unless the caller asks for the CPU.
    Returns HDR [res, res, 3] numpy.  ``generator`` (on that device)
    defaults to one seeded with ``seed``.  ``lambertian`` forces the
    diffuse-only estimator (the default uses the scene's specular and
    roughness through the GGX lobe)."""
    from renderformer_tpu_torch.pipelines.rendering_pipeline import resolve_device
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(seed)

    def on(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), device=dev).to(dtype)

    # the materials in the texture's own dtype, as the JAX package takes them
    diffuse, spec, rough, emissive = texture_to_materials(
        torch.as_tensor(np.asarray(scene['texture']), device=dev))
    fov = np.deg2rad(np.asarray(scene['fov']).reshape(-1)[view])
    img = path_trace(
        on(scene['triangles']), on(scene['vn']), on(scene['mask'], torch.bool),
        diffuse.float(), emissive.float(), on(np.asarray(scene['c2w'])[view]),
        np.float32(fov), generator, resolution=resolution, spp=spp, max_depth=max_depth,
        chunk=chunk, clamp=clamp,
        specular=None if lambertian else spec.float(),
        roughness=None if lambertian else rough.float())
    return img.cpu().numpy()
