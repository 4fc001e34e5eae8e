"""Generate example scene configuration JSONs (simple / complex / random)
with train/test/val splits (the JAX package's ``create_scene_configs.py``).

    python -m renderformer_tpu_torch.create_scene_configs

Writes ``scene_configs/*.json`` and ``scene_configs/splits.json`` under the
working directory with ``json.dump(..., indent=2)``; Python's ``random``
is seeded with 42 and drawn in the JAX tool's order, so the files are
that tool's byte for byte.
"""

import argparse
import json
import os
import random
from typing import Dict, List

import numpy as np

MATERIAL_PRESETS: Dict[str, Dict] = {
    'default': {'diffuse': [0.8, 0.6, 0.4], 'specular': [0.2, 0.2, 0.2],
                'roughness': 0.3, 'emissive': [0.0, 0.0, 0.0],
                'smooth_shading': True},
    'metal': {'diffuse': [0.1, 0.1, 0.1], 'specular': [0.9, 0.9, 0.9],
              'roughness': 0.1, 'emissive': [0.0, 0.0, 0.0],
              'smooth_shading': True},
    'plastic': {'diffuse': [0.2, 0.8, 0.2], 'specular': [0.1, 0.1, 0.1],
                'roughness': 0.8, 'emissive': [0.0, 0.0, 0.0],
                'smooth_shading': True},
    'glass': {'diffuse': [0.9, 0.9, 0.9], 'specular': [0.9, 0.9, 0.9],
              'roughness': 0.0, 'emissive': [0.0, 0.0, 0.0],
              'smooth_shading': True},
    'emissive': {'diffuse': [0.1, 0.1, 0.1], 'specular': [0.0, 0.0, 0.0],
                 'roughness': 1.0, 'emissive': [1.0, 0.8, 0.6],
                 'smooth_shading': True},
}


def create_material_config(material_type: str = 'default') -> Dict:
    return dict(MATERIAL_PRESETS.get(material_type,
                                     MATERIAL_PRESETS['default']))


def create_transform_config(position: List[float] = (0, 0, 0),
                            rotation: List[float] = (0, 0, 0),
                            scale: List[float] = (1, 1, 1)) -> Dict:
    return {'translation': list(position), 'rotation': list(rotation),
            'scale': list(scale), 'normalize': True}


def create_camera_config(position, look_at, up, fov) -> Dict:
    return {'position': list(position), 'look_at': list(look_at),
            'up': list(up), 'fov': fov}


def _ring_cameras(n: int, radius: float, z: float, fov: float) -> List[Dict]:
    cams = []
    for i in range(n):
        angle = i * (360.0 / n)
        cams.append(create_camera_config(
            [radius * np.cos(np.radians(angle)),
             radius * np.sin(np.radians(angle)), z],
            [0, 0, 0], [0, 0, 1], fov))
    return cams


def create_simple_scene_config(scene_name: str, mesh_name: str,
                               material_type: str = 'default') -> Dict:
    return {
        'scene_name': scene_name,
        'version': '1.0',
        'objects': {
            'main_object': {
                'mesh_path': f'{mesh_name}.obj',
                'material': create_material_config(material_type),
                'transform': create_transform_config(),
                'remesh': False,
                'remesh_target_face_num': 2048,
            }
        },
        'cameras': _ring_cameras(8, 3.0, 1.5, 60.0),
    }


def create_complex_scene_config(scene_name: str) -> Dict:
    objects = {
        'cube': ('cube.obj', 'default', [0, 0, 0], [1, 1, 1]),
        'sphere': ('sphere.obj', 'metal', [2, 0, 0], [1, 1, 1]),
        'cylinder': ('cylinder.obj', 'plastic', [-2, 0, 0], [1, 1, 1]),
        'floor': ('plane.obj', 'default', [0, 0, -1], [3, 3, 1]),
        'light': ('sphere.obj', 'emissive', [0, 0, 2], [0.1, 0.1, 0.1]),
    }
    return {
        'scene_name': scene_name,
        'version': '1.0',
        'objects': {
            key: {
                'mesh_path': mesh,
                'material': create_material_config(mat),
                'transform': create_transform_config(pos, [0, 0, 0], scale),
                'remesh': False,
                'remesh_target_face_num': 2048,
            } for key, (mesh, mat, pos, scale) in objects.items()
        },
        'cameras': _ring_cameras(12, 4.0, 2.0, 60.0),
    }


def create_random_scene_config(scene_name: str) -> Dict:
    mesh_names = ['cube', 'sphere', 'cylinder', 'torus']
    material_types = ['default', 'metal', 'plastic', 'glass']
    objects = {}
    for i in range(random.randint(1, 4)):
        scale = random.uniform(0.5, 1.5)
        objects[f'object_{i}'] = {
            'mesh_path': f'{random.choice(mesh_names)}.obj',
            'material': create_material_config(random.choice(material_types)),
            'transform': create_transform_config(
                [random.uniform(-3, 3), random.uniform(-3, 3),
                 random.uniform(-1, 1)],
                [random.uniform(0, 360) for _ in range(3)],
                [scale, scale, scale]),
            'remesh': False,
            'remesh_target_face_num': 2048,
        }
    cameras = []
    for _ in range(random.randint(6, 12)):
        angle = random.uniform(0, 360)
        radius = random.uniform(3, 6)
        cameras.append(create_camera_config(
            [radius * np.cos(np.radians(angle)),
             radius * np.sin(np.radians(angle)), random.uniform(1, 3)],
            [0, 0, 0], [0, 0, 1], random.uniform(45, 75)))
    return {'scene_name': scene_name, 'version': '1.0',
            'objects': objects, 'cameras': cameras}


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split('\n\n')[0]).parse_args(argv)
    random.seed(42)
    out_dir = 'scene_configs'
    os.makedirs(out_dir, exist_ok=True)

    configs = {}
    for mesh in ['cube', 'sphere', 'cylinder', 'torus']:
        for material in ['default', 'metal', 'plastic']:
            name = f'simple_{mesh}_{material}'
            configs[name] = create_simple_scene_config(name, mesh, material)
    configs['complex_scene'] = create_complex_scene_config('complex_scene')
    for i in range(5):
        name = f'random_scene_{i}'
        configs[name] = create_random_scene_config(name)

    for name, cfg in configs.items():
        with open(os.path.join(out_dir, f'{name}.json'), 'w') as f:
            json.dump(cfg, f, indent=2)

    # train/val/test split
    names = sorted(configs)
    random.shuffle(names)
    n = len(names)
    splits = {
        'train': names[:int(n * 0.7)],
        'val': names[int(n * 0.7):int(n * 0.85)],
        'test': names[int(n * 0.85):],
    }
    with open(os.path.join(out_dir, 'splits.json'), 'w') as f:
        json.dump(splits, f, indent=2)
    print(f'wrote {n} scene configs + splits to {out_dir}/')


if __name__ == '__main__':
    main()
