"""Scene meshes + cameras -> model-ready H5 tensors (the JAX package's
``scene/to_h5.py``).

Follows the reference implementation's ``scene_processor/to_h5.py``: per-triangle
13-channel 32x32 texture patches (diffuse 3 + specular 3 + roughness 1 +
normal 3 + irradiance 3) with the lower-triangle mask (x + y <= 32),
look-at cameras, gzip-9 datasets.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from renderformer_tpu_torch.io.h5 import save_scene_h5
from renderformer_tpu_torch.scene.mesh import Mesh
from renderformer_tpu_torch.scene.scene_config import SceneConfig
from renderformer_tpu_torch.utils.look_at import look_at_to_c2w

PATCH_SIZE = 32


def texture_patch_mask(size: int = PATCH_SIZE) -> np.ndarray:
    """Lower-triangle validity mask (to_h5.py:42-45): x + y <= size."""
    x, y = np.meshgrid(np.arange(size), np.arange(size), indexing='ij')
    return (x + y) <= size


def build_texture_patches(n_tris: int, diffuse, specular, roughness,
                          emissive, size: int = PATCH_SIZE) -> np.ndarray:
    """[N, 13, size, size] float32; constant per-triangle values broadcast
    into the patch, zeroed outside the triangle mask (to_h5.py:54-65)."""
    diffuse = np.broadcast_to(np.asarray(diffuse, np.float32), (n_tris, 3))
    specular = np.broadcast_to(np.asarray(specular, np.float32), (n_tris, 3))
    roughness = np.broadcast_to(
        np.asarray(roughness, np.float32).reshape(-1, 1), (n_tris, 1))
    normal = np.broadcast_to(
        np.asarray([0.5, 0.5, 1.0], np.float32), (n_tris, 3))
    emissive = np.broadcast_to(np.asarray(emissive, np.float32), (n_tris, 3))

    channels = np.concatenate(
        [diffuse, specular, roughness, normal, emissive], axis=1)  # [N, 13]
    tex = np.repeat(
        np.repeat(channels[..., None], size, axis=-1)[..., None], size,
        axis=-1).astype(np.float32)  # [N, 13, size, size]
    tex[:, :, ~texture_patch_mask(size)] = 0.0
    return tex


def scene_to_tensors(scene_config: SceneConfig,
                     meshes: Dict[str, Mesh]) -> Dict[str, np.ndarray]:
    """Assemble the full-scene tensors in config object order."""
    all_tris, all_vn, all_tex = [], [], []
    for key, obj_config in scene_config.objects.items():
        mesh = meshes[key]
        tris = mesh.triangles
        vn = mesh.corner_normals()
        mat = obj_config.material
        n = len(tris)
        diffuse = (mesh.face_colors if mesh.face_colors is not None
                   else np.tile(mat.diffuse, (n, 1)))
        tex = build_texture_patches(
            n, diffuse, mat.specular, mat.roughness, mat.emissive)
        all_tris.append(tris)
        all_vn.append(vn)
        all_tex.append(tex)

    c2w = np.stack([
        look_at_to_c2w(cam.position, cam.look_at, cam.up)
        for cam in scene_config.cameras])
    fov = np.array([cam.fov for cam in scene_config.cameras], np.float32)

    return {
        'triangles': np.concatenate(all_tris).astype(np.float32),
        'vn': np.concatenate(all_vn).astype(np.float32),
        'texture': np.concatenate(all_tex).astype(np.float32),
        'c2w': c2w.astype(np.float32),
        'fov': fov,
    }


def save_to_h5(scene_config: SceneConfig, meshes: Dict[str, Mesh],
               output_h5_path: str) -> Dict[str, np.ndarray]:
    tensors = scene_to_tensors(scene_config, meshes)
    save_scene_h5(output_h5_path, tensors['triangles'], tensors['vn'],
                  tensors['texture'], tensors['c2w'], tensors['fov'])
    return tensors
