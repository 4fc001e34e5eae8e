"""Emit cube/sphere/cylinder/plane/torus OBJs for testing (the JAX
package's ``create_sample_meshes.py``).

    python -m renderformer_tpu_torch.create_sample_meshes

Writes ``sample_meshes/{cube,sphere,cylinder,plane,torus}.obj`` under the
working directory, byte for byte the files of the JAX tool, through the
port's numpy mesh stack (``scene/mesh.py``) in place of the reference
implementation's trimesh.
"""

import argparse
import os

import numpy as np

from renderformer_tpu_torch.scene.mesh import Mesh, save_obj


def create_cube_mesh(size: float = 1.0) -> Mesh:
    s = size / 2.0
    v = np.array([[-s, -s, -s], [s, -s, -s], [s, s, -s], [-s, s, -s],
                  [-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s]], float)
    f = np.array([
        [0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
        [0, 1, 5], [0, 5, 4], [1, 2, 6], [1, 6, 5],
        [2, 3, 7], [2, 7, 6], [3, 0, 4], [3, 4, 7]])
    return Mesh(v, f)


def create_sphere_mesh(radius: float = 1.0, subdivisions: int = 2) -> Mesh:
    """Icosphere via subdivision (trimesh.creation.icosphere equivalent)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], float)
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])
    for _ in range(subdivisions):
        mid = {}
        verts = list(v)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                mid[key] = len(verts)
                verts.append((verts[a] + verts[b]) / 2.0)
            return mid[key]

        new_f = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_f += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.asarray(verts)
        f = np.asarray(new_f)
    v = v / np.linalg.norm(v, axis=-1, keepdims=True) * radius
    return Mesh(v, f)


def create_cylinder_mesh(radius: float = 1.0, height: float = 2.0,
                         segments: int = 16) -> Mesh:
    ang = 2 * np.pi * np.arange(segments) / segments
    ring = np.stack([np.cos(ang) * radius, np.sin(ang) * radius], axis=1)
    h = height / 2
    bot = np.concatenate([ring, np.full((segments, 1), -h)], axis=1)
    top = np.concatenate([ring, np.full((segments, 1), h)], axis=1)
    v = np.concatenate([bot, top, [[0, 0, -h]], [[0, 0, h]]])
    cb, ct = 2 * segments, 2 * segments + 1
    f = []
    for i in range(segments):
        j = (i + 1) % segments
        f += [[i, j, segments + i], [j, segments + j, segments + i]]
        f += [[cb, j, i], [ct, segments + i, segments + j]]
    return Mesh(v, np.asarray(f))


def create_plane_mesh(size: float = 2.0) -> Mesh:
    s = size / 2
    v = np.array([[-s, -s, 0], [s, -s, 0], [s, s, 0], [-s, s, 0]], float)
    f = np.array([[0, 1, 2], [0, 2, 3]])
    return Mesh(v, f)


def create_torus_mesh(radius: float = 1.0, tube_radius: float = 0.3,
                      segments: int = 16) -> Mesh:
    verts, faces = [], []
    for i in range(segments):
        u = 2 * np.pi * i / segments
        for j in range(segments):
            t = 2 * np.pi * j / segments
            verts.append([
                (radius + tube_radius * np.cos(t)) * np.cos(u),
                (radius + tube_radius * np.cos(t)) * np.sin(u),
                tube_radius * np.sin(t)])
    for i in range(segments):
        for j in range(segments):
            a = i * segments + j
            b = i * segments + (j + 1) % segments
            c = ((i + 1) % segments) * segments + j
            d = ((i + 1) % segments) * segments + (j + 1) % segments
            faces += [[a, b, c], [b, d, c]]
    return Mesh(np.asarray(verts, float), np.asarray(faces))


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split('\n\n')[0]).parse_args(argv)
    out_dir = 'sample_meshes'
    os.makedirs(out_dir, exist_ok=True)
    meshes = {
        'cube': create_cube_mesh(),
        'sphere': create_sphere_mesh(),
        'cylinder': create_cylinder_mesh(),
        'plane': create_plane_mesh(),
        'torus': create_torus_mesh(),
    }
    for name, mesh in meshes.items():
        path = os.path.join(out_dir, f'{name}.obj')
        mesh.compute_vertex_normals()
        save_obj(path, mesh)
        print(f'{path}: {len(mesh.vertices)} verts, {len(mesh.faces)} faces')


if __name__ == '__main__':
    main()
