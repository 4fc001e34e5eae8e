"""The one generator of the benchmark's inputs: scenes, cameras, ground truth.

Everything is drawn with numpy from the run's seed and the parameters of a
traffic file (``rfbench/traffic/<name>.json``), so one seed gives the same
inputs on every machine.  The pattern is ``bench.py``'s scene: triangles
N(0, 0.3^2) about the origin, unit vertex normals, 13-channel materials
(diffuse RGB, specular RGB, roughness, normal, emission RGB), a few emitters.
The sizes are fixed by the traffic file and only their order depends on
the seed, so every seed's window holds the same work.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

CHANNELS = 13
PATCH = 32
SEED_STREAMS = {'scenes': 11, 'cameras': 12, 'order': 13, 'gt': 14, 'sample': 15, 'warm': 16}


def rng(seed: int, stream: str, *index: int) -> np.random.Generator:
    """The generator of one purpose of a seed (and of one item, ``index``)."""
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), SEED_STREAMS[stream], *index])


def patch_mask(size: int = PATCH) -> np.ndarray:
    """The lower-triangle texel mask of a triangle's patch, x + y <= size."""
    x, y = np.meshgrid(np.arange(size), np.arange(size), indexing='ij')
    return (x + y) <= size


def materials(r: np.random.Generator, n: int, mix: dict) -> np.ndarray:
    """[n, 13] per-triangle constants: diffuse, specular, roughness in
    [0, 1], a unit-ish tangent normal, emission on a share of emitters."""
    m = np.empty((n, CHANNELS), np.float32)
    m[:, 0:3] = r.uniform(0, 1, (n, 3))
    m[:, 3:6] = r.uniform(0, 0.5, (n, 3))
    m[:, 6] = r.uniform(0.05, 1, n)
    m[:, 7:10] = (0.5, 0.5, 1.0) + r.normal(0, 0.05, (n, 3))
    lo, hi = mix['emission']
    emits = r.uniform(0, 1, n) < mix['emissive_share']
    m[:, 10:13] = np.where(emits[:, None], r.uniform(lo, hi, (n, 3)), 0.0)
    return m


def geometry(r: np.random.Generator, n: int):
    """(triangles [n, 3, 3], vertex normals [n, 3, 3]) float32."""
    tris = (r.normal(size=(n, 3, 3)) * 0.3).astype(np.float32)
    vn = r.normal(size=(n, 3, 3))
    vn /= np.linalg.norm(vn, axis=-1, keepdims=True)
    return tris, vn.astype(np.float32)


def look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Camera-to-world [..., 4, 4] from eyes and targets [..., 3], the
    camera looking down its -Z axis, +Z up in the world."""
    fwd = target - eye
    fwd /= np.linalg.norm(fwd, axis=-1, keepdims=True)
    right = np.cross(fwd, (0.0, 0.0, 1.0))
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    up = np.cross(right, fwd)
    c2w = np.zeros(eye.shape[:-1] + (4, 4))
    c2w[..., :3, 0], c2w[..., :3, 1], c2w[..., :3, 2], c2w[..., :3, 3] = right, up, -fwd, eye
    c2w[..., 3, 3] = 1.0
    return c2w


def cameras(r: np.random.Generator, shape: tuple, mix: dict):
    """(c2w [*shape, 4, 4], fov [*shape] degrees) float32: eyes on a sphere
    shell about the scene, above its middle, looking at a point near its
    centre."""
    d = r.normal(size=shape + (3,))
    d[..., 2] = np.abs(d[..., 2]) * 0.5
    dist = r.uniform(*mix['camera_distance'], shape)[..., None]
    eye = d / np.linalg.norm(d, axis=-1, keepdims=True) * dist
    c2w = look_at(eye, r.normal(0, 0.05, shape + (3,)))
    fov = r.uniform(*mix['fov_deg'], shape)
    return c2w.astype(np.float32), fov.astype(np.float32)


def order(seed: int, pool: int, count: int) -> np.ndarray:
    """``count`` pool indices: whole cycles through the pool, each cycle in
    an order of its own drawn from the seed."""
    r = rng(seed, 'order')
    cycles = -(-count // pool)
    return np.concatenate([r.permutation(pool) for _ in range(cycles)])[:count]


def render_scene(seed: int, mix: dict, i: int, n: int, stream: str = 'scenes',
                 out: Optional[np.ndarray] = None) -> Dict:
    """Request i's scene of n triangles, as ``infer`` and ``batch_infer``
    hand a scene to the pipeline after reading it from H5: float32 host
    arrays, the texture expanded to full [1, n, 13, 32, 32] patches (into
    ``out[:, :n]`` where a buffer [1, >= n, 13, 32, 32] is given).  Every
    request's scene is drawn anew, so no two requests share its contents,
    as no two files of a folder do."""
    r = rng(seed, stream, i)
    tris, vn = geometry(r, n)
    mat = materials(r, n, mix)[None, :, :, None, None]
    mask = patch_mask().astype(np.float32)
    tex = mat * mask if out is None else np.multiply(mat, mask, out=out[:, :n])
    return dict(triangles=tris[None], texture=tex, mask=np.ones((1, n), bool), vn=vn[None])


def request_cameras(seed: int, mix: dict, count: int):
    """Fresh cameras for each of ``count`` requests: (c2w [count, 1, V, 4, 4],
    fov [count, 1, V, 1])."""
    c2w, fov = cameras(rng(seed, 'cameras'), (count, 1, mix['views']), mix)
    return c2w, fov[..., None]


def train_pool(seed: int, mix: dict) -> List[Dict[str, np.ndarray]]:
    """The batches of a fine-tuning job, as ``training/dataset.py`` gives
    them: one scene a batch, padded to ``pad_to`` triangles with a mask, the
    compact texture ``texture_flat`` [1, pad, 13], one view, and a ground
    truth image in [0, 1]."""
    r = rng(seed, 'scenes')
    rc, rg = rng(seed, 'cameras'), rng(seed, 'gt')
    pad, res, views = mix['pad_to'], mix['resolution'], mix['views']
    pool = []
    for n in mix['triangles']:
        tris, vn = geometry(r, n)
        b = dict(triangles=np.zeros((1, pad, 3, 3), np.float32),
                 texture_flat=np.zeros((1, pad, CHANNELS), np.float32),
                 mask=np.zeros((1, pad), bool), vn=np.zeros((1, pad, 3, 3), np.float32))
        b['triangles'][0, :n], b['vn'][0, :n] = tris, vn
        b['texture_flat'][0, :n] = materials(r, n, mix)
        b['mask'][0, :n] = True
        c2w, fov = cameras(rc, (1, views), mix)
        b['c2w'], b['fov'] = c2w, fov[..., None]
        b['gt'] = rg.uniform(0, 1, (1, views, res, res, 3)).astype(np.float32)
        b['real'] = n
        pool.append(b)
    return pool
