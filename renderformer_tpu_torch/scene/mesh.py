"""Pure-numpy triangle mesh: OBJ IO, normals, transforms, smooth shading
(the JAX package's ``scene/mesh.py``).

Replaces the reference implementation's trimesh dependency for scene
ingestion (its ``scene_processor/scene_mesh.py``) with the subset it needs:
  * OBJ load/save (v, vn, f; vertex-color extension 'v x y z r g b')
  * angle-weighted vertex normals (trimesh.Trimesh.vertex_normals)
  * unit-sphere normalization (scene_mesh.py:12-18)
  * per-axis rotation / scale / translation (scene_mesh.py:43-51)
  * smooth shading with a crease angle — vertices split per smoothing
    group (trimesh.graph.smooth_shade equivalent)
  * face splitting for flat shading (scene_mesh.py:56-60)
  * connected-component split for per-shading-group coloring
    (scene_mesh.py:69-82)
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class Mesh:
    vertices: np.ndarray                      # [V, 3] float64
    faces: np.ndarray                         # [F, 3] int64
    vertex_normals: Optional[np.ndarray] = None   # [V, 3]
    face_colors: Optional[np.ndarray] = None      # [F, 3] in [0, 1]

    def copy(self) -> 'Mesh':
        return Mesh(
            self.vertices.copy(), self.faces.copy(),
            None if self.vertex_normals is None else self.vertex_normals.copy(),
            None if self.face_colors is None else self.face_colors.copy())

    @property
    def triangles(self) -> np.ndarray:
        """[F, 3, 3] corner positions."""
        return self.vertices[self.faces]

    # -- normals --------------------------------------------------------
    def face_normals(self) -> np.ndarray:
        tri = self.triangles
        n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        return n / np.maximum(norm, 1e-20)

    def face_angles(self) -> np.ndarray:
        """[F, 3] interior angle at each corner."""
        tri = self.triangles
        angles = np.empty((len(self.faces), 3))
        for i in range(3):
            a = tri[:, (i + 1) % 3] - tri[:, i]
            b = tri[:, (i + 2) % 3] - tri[:, i]
            an = a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-20)
            bn = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-20)
            angles[:, i] = np.arccos(np.clip((an * bn).sum(-1), -1, 1))
        return angles

    def compute_vertex_normals(self) -> np.ndarray:
        """Angle-weighted average of adjacent face normals (trimesh's
        weighted_vertex_normals)."""
        fn = self.face_normals()
        ang = self.face_angles()
        vn = np.zeros_like(self.vertices, dtype=np.float64)
        for i in range(3):
            np.add.at(vn, self.faces[:, i], fn * ang[:, i:i + 1])
        norm = np.linalg.norm(vn, axis=-1, keepdims=True)
        vn = vn / np.maximum(norm, 1e-20)
        self.vertex_normals = vn
        return vn

    def corner_normals(self) -> np.ndarray:
        """[F, 3, 3] per-corner normals (to_h5.py:51 vn=vertex_normals[faces])."""
        if self.vertex_normals is None:
            self.compute_vertex_normals()
        return self.vertex_normals[self.faces]

    # -- transforms -----------------------------------------------------
    def normalize_to_unit_sphere(self) -> 'Mesh':
        """Center at the vertex mean; scale so max radius = 0.5
        (scene_mesh.py:12-18 divides by 2 * max-norm)."""
        self.vertices = self.vertices - self.vertices.mean(axis=0)
        radius = np.linalg.norm(self.vertices, axis=-1).max() * 2.0
        self.vertices = self.vertices / radius
        return self

    def apply_rotation_euler_deg(self, angles_xyz) -> 'Mesh':
        """Rotate about world x, then y, then z (scene_mesh.py:43-48)."""
        for axis, deg in enumerate(angles_xyz):
            t = np.deg2rad(deg)
            c, s = np.cos(t), np.sin(t)
            if axis == 0:
                R = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
            elif axis == 1:
                R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
            else:
                R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            self.vertices = self.vertices @ R.T
            if self.vertex_normals is not None:
                self.vertex_normals = self.vertex_normals @ R.T
        return self

    def apply_scale(self, scale) -> 'Mesh':
        scale = np.broadcast_to(np.asarray(scale, np.float64), (3,))
        self.vertices = self.vertices * scale
        if self.vertex_normals is not None and not np.allclose(scale, scale[0]):
            # non-uniform scale: normals transform by inverse-transpose
            self.vertex_normals = self.vertex_normals / scale
            n = np.linalg.norm(self.vertex_normals, axis=-1, keepdims=True)
            self.vertex_normals = self.vertex_normals / np.maximum(n, 1e-20)
        return self

    def apply_translation(self, t) -> 'Mesh':
        self.vertices = self.vertices + np.asarray(t, np.float64)
        return self

    # -- topology -------------------------------------------------------
    def split_faces(self) -> 'Mesh':
        """Give every face its own 3 vertices (flat shading,
        scene_mesh.py:56-60); vertex normals become face normals."""
        tri = self.triangles.reshape(-1, 3)
        faces = np.arange(len(tri)).reshape(-1, 3)
        mesh = Mesh(tri, faces, face_colors=self.face_colors)
        fn = mesh.face_normals()
        mesh.vertex_normals = np.repeat(fn, 3, axis=0)
        return mesh

    def _face_adjacency(self) -> np.ndarray:
        """[A, 2] pairs of faces sharing an (undirected) edge."""
        f = self.faces
        edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        edges = np.sort(edges, axis=1)
        face_idx = np.tile(np.arange(len(f)), 3)
        order = np.lexsort((edges[:, 1], edges[:, 0]))
        edges, face_idx = edges[order], face_idx[order]
        same = np.all(edges[1:] == edges[:-1], axis=1)
        return np.stack([face_idx[:-1][same], face_idx[1:][same]], axis=1)

    def connected_components(self) -> List[np.ndarray]:
        """Face indices of each edge-connected component
        (trimesh mesh.split(only_watertight=False))."""
        n = len(self.faces)
        parent = np.arange(n)

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for a, b in self._face_adjacency():
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb
        roots = np.array([find(i) for i in range(n)])
        return [np.nonzero(roots == r)[0] for r in np.unique(roots)]

    def smooth_shaded(self, crease_angle_deg: float = 30.0) -> 'Mesh':
        """Split vertices along sharp edges, then compute smooth normals
        (trimesh.graph.smooth_shade(angle=30deg), scene_mesh.py:53-54).

        Faces whose dihedral angle across a shared edge is below the
        crease angle share smoothed normals; other edges become sharp.
        Implemented by unioning faces over small-angle adjacency and
        duplicating each original vertex once per incident face group.
        """
        fn = self.face_normals()
        adj = self._face_adjacency()
        cos_thresh = np.cos(np.deg2rad(crease_angle_deg))
        smooth_pair = (fn[adj[:, 0]] * fn[adj[:, 1]]).sum(-1) >= cos_thresh

        n = len(self.faces)
        parent = np.arange(n)

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for (a, b), ok in zip(adj, smooth_pair):
            if ok:
                ra, rb = find(a), find(b)
                if ra != rb:
                    parent[ra] = rb
        group = np.array([find(i) for i in range(n)])

        # new vertex per (original vertex, group) pair
        flat_v = self.faces.reshape(-1)                       # corner -> vertex
        flat_g = np.repeat(group, 3)                          # corner -> group
        key = flat_v.astype(np.int64) * (group.max() + 1) + flat_g
        uniq, inverse = np.unique(key, return_inverse=True)
        new_faces = inverse.reshape(-1, 3)
        new_vertices = np.zeros((len(uniq), 3))
        new_vertices[inverse] = self.vertices[flat_v]

        mesh = Mesh(new_vertices, new_faces, face_colors=self.face_colors)
        mesh.compute_vertex_normals()
        return mesh


# ---------------------------------------------------------------------------
# OBJ IO
# ---------------------------------------------------------------------------

def load_obj(path: str) -> Mesh:
    """Minimal OBJ reader: v (with optional vertex-color extension),
    vn, f (any of v, v/vt, v//vn, v/vt/vn; polygons fan-triangulated)."""
    vertices, normals, colors = [], [], []
    faces, face_normal_idx = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == 'v':
                vertices.append([float(x) for x in parts[1:4]])
                if len(parts) >= 7:
                    colors.append([float(x) for x in parts[4:7]])
            elif tag == 'vn':
                normals.append([float(x) for x in parts[1:4]])
            elif tag == 'f':
                idx = []
                nidx = []
                for tok in parts[1:]:
                    comps = tok.split('/')
                    idx.append(int(comps[0]))
                    if len(comps) >= 3 and comps[2]:
                        nidx.append(int(comps[2]))
                # fan triangulation
                for i in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
                    if nidx:
                        face_normal_idx.append([nidx[0], nidx[i], nidx[i + 1]])

    v = np.asarray(vertices, np.float64)
    f_arr = np.asarray(faces, np.int64)
    f_arr = np.where(f_arr > 0, f_arr - 1, len(v) + f_arr)  # 1-based & negative
    mesh = Mesh(v, f_arr)

    if normals and face_normal_idx:
        vn_raw = np.asarray(normals, np.float64)
        ni = np.asarray(face_normal_idx, np.int64)
        ni = np.where(ni > 0, ni - 1, len(vn_raw) + ni)
        # map per-corner normals back to per-vertex where consistent
        vn = np.zeros_like(v)
        counts = np.zeros(len(v))
        np.add.at(vn, f_arr.reshape(-1), vn_raw[ni.reshape(-1)])
        np.add.at(counts, f_arr.reshape(-1), 1.0)
        nz = counts > 0
        vn[nz] /= counts[nz, None]
        norm = np.linalg.norm(vn, axis=-1, keepdims=True)
        mesh.vertex_normals = vn / np.maximum(norm, 1e-20)

    if colors and len(colors) == len(vertices):
        # convert per-vertex colors to per-face (first corner's color)
        vc = np.asarray(colors, np.float64)
        mesh.face_colors = vc[mesh.faces[:, 0]]
    return mesh


def save_obj(path: str, mesh: Mesh, include_normals: bool = True) -> None:
    """Write OBJ; vertex colors appended to 'v' lines when present
    (matching trimesh's color export that to_h5.py reads back)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    vc = None
    if mesh.face_colors is not None:
        vc = np.zeros((len(mesh.vertices), 3))
        vc[mesh.faces.reshape(-1)] = np.repeat(mesh.face_colors, 3, axis=0)
    if include_normals and mesh.vertex_normals is None:
        mesh.compute_vertex_normals()
    with open(path, 'w') as f:
        for i, v in enumerate(mesh.vertices):
            if vc is not None:
                f.write('v %.8f %.8f %.8f %.6f %.6f %.6f\n'
                        % (v[0], v[1], v[2], vc[i, 0], vc[i, 1], vc[i, 2]))
            else:
                f.write('v %.8f %.8f %.8f\n' % (v[0], v[1], v[2]))
        if include_normals:
            for n in mesh.vertex_normals:
                f.write('vn %.8f %.8f %.8f\n' % (n[0], n[1], n[2]))
            for face in mesh.faces + 1:
                f.write('f %d//%d %d//%d %d//%d\n'
                        % (face[0], face[0], face[1], face[1],
                           face[2], face[2]))
        else:
            for face in mesh.faces + 1:
                f.write('f %d %d %d\n' % tuple(face))


def concatenate(meshes: List[Mesh]) -> Mesh:
    """Concatenate meshes (trimesh.util.concatenate, scene_mesh.py:82)."""
    vs, fs, vns, fcs = [], [], [], []
    offset = 0
    has_vn = all(m.vertex_normals is not None for m in meshes)
    has_fc = all(m.face_colors is not None for m in meshes)
    for m in meshes:
        vs.append(m.vertices)
        fs.append(m.faces + offset)
        offset += len(m.vertices)
        if has_vn:
            vns.append(m.vertex_normals)
        if has_fc:
            fcs.append(m.face_colors)
    return Mesh(
        np.concatenate(vs), np.concatenate(fs),
        np.concatenate(vns) if has_vn else None,
        np.concatenate(fcs) if has_fc else None)
