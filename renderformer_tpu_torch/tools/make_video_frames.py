"""Generate an N-frame camera-orbit H5 folder from an example scene (the
JAX package's ``tools/make_video_frames.py``).

    python -m renderformer_tpu_torch.tools.make_video_frames \
        --scene examples/cbox.json --out FRAMES_DIR --frames 48 --arc 360

The folder is what ``batch_infer --video_mode`` consumes: one example
scene's geometry, the camera orbiting the look-at point across frames, one
H5 per frame (``frame_<i:04d>.h5``).  The orbit keeps the radius and
elevation of the scene's own first camera and sweeps only the azimuth, so
it stays inside the trained envelope (camera distance 1.5-2.0, fov 30-60).

``orbit_frames`` returns the frames as arrays and needs no file; ``main``
writes them with ``io/h5.save_scene_h5`` (the port's ``io/hdf5``).
The default ``--out`` lies under the system's temporary directory.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Dict, List

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--scene', default='examples/cbox.json')
    ap.add_argument('--out', default=os.path.join(tempfile.gettempdir(), 'rf_frames'))
    ap.add_argument('--frames', type=int, default=48)
    ap.add_argument('--arc', type=float, default=360.0,
                    help='total azimuth sweep in degrees')
    return ap


def orbit_frames(scene: str, frames: int, arc: float = 360.0) -> List[Dict[str, np.ndarray]]:
    """The ``frames`` frames of an orbit over ``arc`` degrees around the
    scene JSON's first camera: one dict a frame of ``triangles`` [N, 3, 3],
    ``vn`` [N, 3, 3], ``texture`` [N, 13, 32, 32] (the same arrays in every
    frame), ``c2w`` [1, 4, 4] float32 and ``fov`` [1] float32."""
    from renderformer_tpu_torch.scene.scene_config import load_scene_config
    from renderformer_tpu_torch.scene.scene_mesh import generate_scene_meshes
    from renderformer_tpu_torch.scene.to_h5 import scene_to_tensors
    from renderformer_tpu_torch.utils.look_at import look_at_to_c2w

    cfg = load_scene_config(scene)
    meshes = generate_scene_meshes(cfg, os.path.dirname(os.path.abspath(scene)))
    base = scene_to_tensors(cfg, meshes)

    cam = cfg.cameras[0]
    pos = np.asarray(cam.position, np.float64)
    tgt = np.asarray(cam.look_at, np.float64)
    rel = pos - tgt
    radius_xy = float(np.hypot(rel[0], rel[1]))
    theta0 = float(np.arctan2(rel[1], rel[0]))
    z = float(rel[2])

    fov = np.asarray([cam.fov], np.float32)
    out = []
    for i in range(frames):
        theta = theta0 + np.deg2rad(arc) * i / frames
        p = tgt + np.array([radius_xy * np.cos(theta), radius_xy * np.sin(theta), z])
        c2w = look_at_to_c2w(p, tgt, cam.up)[None].astype(np.float32)
        out.append({'triangles': base['triangles'], 'vn': base['vn'],
                    'texture': base['texture'], 'c2w': c2w, 'fov': fov})
    return out


def frame_name(i: int) -> str:
    return f'frame_{i:04d}'


def write_frames(frames: List[Dict[str, np.ndarray]], out: str) -> None:
    """Each frame as ``out/frame_<i:04d>.h5``."""
    from renderformer_tpu_torch.io.h5 import save_scene_h5
    os.makedirs(out, exist_ok=True)
    for i, fr in enumerate(frames):
        save_scene_h5(os.path.join(out, frame_name(i) + '.h5'), fr['triangles'], fr['vn'],
                      fr['texture'], fr['c2w'], fr['fov'])


def main(argv=None):
    args = build_parser().parse_args(argv)
    frames = orbit_frames(args.scene, args.frames, args.arc)
    write_frames(frames, args.out)
    n = frames[0]['triangles'].shape[0] if frames else 0
    print(f'{args.frames} frames ({n} tris each) -> {args.out}')


if __name__ == '__main__':
    main()
