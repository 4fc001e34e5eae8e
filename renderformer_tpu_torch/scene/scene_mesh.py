"""Scene assembly: JSON config -> per-object processed meshes (the JAX
package's ``scene/scene_mesh.py``).

Follows the reference implementation's ``scene_processor/scene_mesh.py``,
without its OBJ-file round trip (meshes stay in memory; an optional
split-OBJ export keeps its file layout).  A ``rand_tri_diffuse_seed`` seeds
Python's and numpy's global generators, as the reference does, and draws in
the same order, so the same scene gives the same colours.
"""

from __future__ import annotations

import math
import os
import random
from typing import Dict

import numpy as np

from renderformer_tpu_torch.scene.mesh import Mesh, concatenate, load_obj, save_obj
from renderformer_tpu_torch.scene.scene_config import ObjectConfig, SceneConfig


def process_object(obj_config: ObjectConfig, scene_config_dir: str) -> Mesh:
    """Load + normalize + remesh + transform + shade + color one object."""
    mesh = load_obj(os.path.join(scene_config_dir, obj_config.mesh_path))

    if obj_config.transform.normalize:
        mesh.normalize_to_unit_sphere()

    if obj_config.remesh:
        from renderformer_tpu_torch.scene.remesh import remesh
        new_v, new_f = remesh(mesh.vertices, mesh.faces,
                              obj_config.remesh_target_face_num)
        print(f'remesh: {len(mesh.faces)} -> {len(new_f)} faces')
        mesh = Mesh(np.asarray(new_v, np.float64),
                    np.asarray(new_f, np.int64))

    # rotation (x, then y, then z) -> scale -> translation
    # (scene_mesh.py:43-51)
    tf = obj_config.transform
    mesh.apply_rotation_euler_deg(tf.rotation)
    mesh.apply_scale(tf.scale)
    mesh.apply_translation(tf.translation)

    mat = obj_config.material
    if mat.smooth_shading:
        mesh = mesh.smooth_shaded(crease_angle_deg=30.0)
    else:
        mesh = mesh.split_faces()

    if mat.rand_tri_diffuse_seed is not None:
        # deterministic random per-triangle / per-shading-group diffuse
        # (scene_mesh.py:62-82)
        random.seed(mat.rand_tri_diffuse_seed)
        np.random.seed(mat.rand_tri_diffuse_seed)
        face_colors = np.zeros((len(mesh.faces), 3))
        if mat.random_diffuse_type == 'per-triangle':
            groups = [np.array([i]) for i in range(len(mesh.faces))]
        else:
            groups = mesh.connected_components()
        hi = math.ceil(256 * mat.random_diffuse_max)
        for g in groups:
            color = np.random.randint(0, hi, (1, 3))
            face_colors[g] = color / 255.0
        mesh.face_colors = np.clip(face_colors, 0.0, 1.0)
    else:
        color = np.clip(np.asarray(mat.diffuse) * 255.0, 0, 255).astype(int)
        mesh.face_colors = np.tile(color / 255.0, (len(mesh.faces), 1))

    if mesh.vertex_normals is None:
        mesh.compute_vertex_normals()
    return mesh


def generate_scene_meshes(scene_config: SceneConfig,
                          scene_config_dir: str) -> Dict[str, Mesh]:
    """Per-object processed meshes, keyed like scene_config.objects."""
    return {key: process_object(obj, scene_config_dir)
            for key, obj in scene_config.objects.items()}


def generate_scene_mesh(scene_config: SceneConfig, output_path: str,
                        scene_config_dir: str) -> Dict[str, Mesh]:
    """Reference-compatible entry (scene_mesh.py:21): also exports
    split/<key>.obj files next to ``output_path``."""
    meshes = generate_scene_meshes(scene_config, scene_config_dir)
    split_dir = os.path.join(os.path.dirname(output_path), 'split')
    os.makedirs(split_dir, exist_ok=True)
    for key, mesh in meshes.items():
        save_obj(os.path.join(split_dir, f'{key}.obj'), mesh,
                 include_normals=True)
    combined = concatenate(list(meshes.values()))
    save_obj(output_path, combined, include_normals=True)
    return meshes
