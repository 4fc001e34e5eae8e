"""H5 scene inspector and debug renderer (the JAX package's
``render_h5_to_png.py``).

    python -m renderformer_tpu_torch.render_h5_to_png scene.h5 [--view 0] \
        [--resolution 256] [--output out.png] [--pathtrace --spp 64] [--cpu]

Prints the datasets' shapes and ranges, then writes a PNG: by default a
flat-shaded rasterization of the triangle soup through the scene's camera
(``debug_render``, numpy, a geometry and camera check, not physically
based), or with ``--pathtrace`` a path-traced render by
``scene/path_tracer.py``, on the card unless ``--cpu`` is given.  Reading
the H5 file needs ``h5py``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def inspect(data):
    print('H5 contents:')
    for key, arr in data.items():
        if hasattr(arr, 'shape'):
            print(f'  {key:10s} {str(arr.shape):20s} {arr.dtype} '
                  f'min={np.min(arr):+.4f} max={np.max(arr):+.4f}')


def debug_render(data, view: int, resolution: int) -> np.ndarray:
    """Rasterize the triangles through the pinhole camera with
    painter's-algorithm depth ordering.  Not physically based: a geometry
    and camera sanity image in [0, 1]."""
    tris = data['triangles']            # [N, 3, 3]
    vn = data['vn']                     # [N, 3, 3]
    tex = data['texture']               # [N, 13, ps, ps]
    c2w = data['c2w'][view]
    fov = np.deg2rad(float(np.ravel(data['fov'])[view]))

    R, t = c2w[:3, :3], c2w[:3, 3]
    cam_tris = (tris - t) @ R           # world -> camera (R^T x, row form)

    f = resolution / 2.0 / np.tan(fov / 2.0)
    c = resolution / 2.0

    img = np.zeros((resolution, resolution, 3), np.float32)
    depth = np.full((resolution, resolution), np.inf, np.float32)

    # per-triangle flat color: diffuse from inside the lower-triangle
    # texture mask (x + y <= ps), darkened by the normal-to-view angle;
    # emissive -> white
    ps = tex.shape[-1]
    diffuse = tex[:, 0:3, ps // 2 - 1, ps // 4]  # [N, 3]
    emissive = tex[:, 10:13].reshape(len(tris), 3, -1).max(-1)
    n_avg = vn.mean(axis=1)
    n_avg /= np.maximum(np.linalg.norm(n_avg, axis=-1, keepdims=True), 1e-9)

    order = np.argsort(-cam_tris[:, :, 2].mean(axis=1))  # far to near (-z fwd)
    for i in order:
        tri = cam_tris[i]
        z = -tri[:, 2]
        if np.any(z <= 1e-6):
            continue
        x = tri[:, 0] / z * f + c
        y = -tri[:, 1] / z * f + c
        xs = np.clip(x, 0, resolution - 1)
        ys = np.clip(y, 0, resolution - 1)
        # fill the bounding box with a barycentric test
        x0, x1 = int(xs.min()), int(np.ceil(xs.max()))
        y0, y1 = int(ys.min()), int(np.ceil(ys.max()))
        if x1 <= x0 or y1 <= y0:
            continue
        gx, gy = np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1))
        d = np.stack([gx - x[0], gy - y[0]], -1).astype(np.float64)
        e1 = np.array([x[1] - x[0], y[1] - y[0]])
        e2 = np.array([x[2] - x[0], y[2] - y[0]])
        det = e1[0] * e2[1] - e1[1] * e2[0]
        if abs(det) < 1e-12:
            continue
        u = (d[..., 0] * e2[1] - d[..., 1] * e2[0]) / det
        v = (-d[..., 0] * e1[1] + d[..., 1] * e1[0]) / det
        inside = (u >= 0) & (v >= 0) & (u + v <= 1)
        if not inside.any():
            continue
        zi = z.mean()
        if emissive[i].max() > 0:
            color = np.array([1.0, 1.0, 0.9])
        else:
            shade = abs(n_avg[i] @ (R[:, 2]))
            color = diffuse[i] * (0.3 + 0.7 * shade)
        sel_y, sel_x = gy[inside], gx[inside]
        closer = zi < depth[sel_y, sel_x]
        img[sel_y[closer], sel_x[closer]] = color
        depth[sel_y[closer], sel_x[closer]] = zi
    return np.clip(img, 0, 1)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='Inspect/debug-render H5 scene')
    parser.add_argument('h5_file', type=str)
    parser.add_argument('--view', type=int, default=0)
    parser.add_argument('--resolution', type=int, default=256)
    parser.add_argument('--output', type=str, default=None)
    parser.add_argument('--pathtrace', action='store_true',
                        help='physically-based render by the path tracer '
                             '(scene/path_tracer.py) instead of the flat rasterizer')
    parser.add_argument('--spp', type=int, default=64,
                        help='path-tracer samples per pixel')
    parser.add_argument('--cpu', action='store_true',
                        help='path-trace on the CPU (default: the CUDA device)')
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    from renderformer_tpu_torch.io.h5 import load_scene_h5
    from renderformer_tpu_torch.io.image import write_png

    data = load_scene_h5(args.h5_file)
    inspect(data)

    if args.pathtrace:
        from renderformer_tpu_torch.scene.path_tracer import render_scene_pathtrace
        img = np.clip(render_scene_pathtrace(
            data, view=args.view, resolution=args.resolution, spp=args.spp,
            device='cpu' if args.cpu else None), 0, 1)
        suffix = '_pathtrace.png'
    else:
        img = debug_render(data, args.view, args.resolution)
        suffix = '_debug.png'
    out = args.output or os.path.splitext(args.h5_file)[0] + suffix
    write_png(out, (img * 255).astype(np.uint8))
    print(f'{"path-traced" if args.pathtrace else "debug"} render -> {out}')


if __name__ == '__main__':
    main()
