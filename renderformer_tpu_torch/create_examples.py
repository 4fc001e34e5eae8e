"""Generate the in-repo example assets (the JAX package's
``create_examples.py``): templates (backgrounds + the single-triangle
light), procedural stand-in objects, and all 16 scene JSONs matching the
reference implementation's example set (cbox family, cornell_box,
compose-scene, constant-width, crystals, fox-in-the-wild, horse-and-heart,
init-template, renderformer-logo, room, shader-ball, tree, veach-mis) plus
two extras (cbox-sphere, cbox-torus).

    python -m renderformer_tpu_torch.create_examples

Writes ``examples/`` under the working directory; run in the repo root, it
rewrites the committed files with the same bytes.  The decimated stand-ins
go through the port's native QEM decimation (``scene/remesh.py``, which
builds ``native/meshops.cpp`` with g++ at first use).

The scene *structure* matches the reference scene-for-scene: same object
counts, light counts, template paths (plane/wall0/wall1/wall2, lighting/
tri.obj), light transforms and emission levels, and camera parameters —
those are the dataset-defining constants of the trained envelope.  The
artwork meshes (bunny, lucy, fox, ...) are replaced by procedural
stand-ins with matching topology class and face counts, generated from
first principles so the repo stays self-contained and license-clean.
"""

import argparse
import json
import os

import numpy as np

from renderformer_tpu_torch.create_sample_meshes import (
    create_cube_mesh, create_cylinder_mesh, create_sphere_mesh, create_torus_mesh)
from renderformer_tpu_torch.scene.mesh import Mesh, save_obj


# ---------------------------------------------------------------------------
# mesh helpers
# ---------------------------------------------------------------------------

def grid_plane(n: int = 8) -> Mesh:
    """Unit plane [-1,1]^2 at z=-1 subdivided into 2*n*n triangles
    (matches the reference background resolution: 81 verts, 128 faces)."""
    lin = np.linspace(-1, 1, n + 1)
    xx, yy = np.meshgrid(lin, lin, indexing='ij')
    verts = np.stack([xx.ravel(), yy.ravel(), np.full((n + 1) ** 2, -1.0)],
                     axis=1)
    faces = []
    for i in range(n):
        for j in range(n):
            a = i * (n + 1) + j
            b = a + 1
            c = a + (n + 1)
            d = c + 1
            faces += [[a, b, c], [b, d, c]]
    return Mesh(verts, np.asarray(faces))


def wall(axis: str, sign: float, n: int = 8) -> Mesh:
    """Axis-aligned wall of the +-1 box, normal pointing inward."""
    m = grid_plane(n)
    v = m.vertices.copy()
    if axis == 'x':
        v = v[:, [2, 0, 1]] * np.array([-sign, 1, 1])
    elif axis == 'y':
        v = v[:, [0, 2, 1]] * np.array([1, -sign, 1])
    else:
        v = v * np.array([1, 1, -sign])
    m.vertices = v
    center_dir = -v.mean(axis=0)
    if (m.face_normals() @ center_dir).mean() < 0:
        m.faces = m.faces[:, ::-1]
    return m


def light_tri() -> Mesh:
    """Single-triangle light; same vertex layout as the reference
    template (templates/lighting/tri.obj — a tilted triangle, 1 face;
    its shape at scale 2.0-2.5 defines the trained light envelope)."""
    v = np.array([[-0.025, 0.025, 0.025],
                  [0.025, -0.025, 0.025],
                  [0.025, 0.025, -0.025]])
    return Mesh(v, np.array([[0, 1, 2]]))


def merge(*meshes: Mesh) -> Mesh:
    verts, faces, off = [], [], 0
    for m in meshes:
        verts.append(m.vertices)
        faces.append(m.faces + off)
        off += len(m.vertices)
    return Mesh(np.concatenate(verts), np.concatenate(faces))


def xform(m: Mesh, scale=1.0, rot_z=0.0, rot_x=0.0, rot_y=0.0,
          translate=(0, 0, 0)) -> Mesh:
    """Scale -> rotate (x, y, z order, degrees) -> translate, baked."""
    v = m.vertices * np.asarray(scale, float)
    for angle, (i, j) in ((rot_x, (1, 2)), (rot_y, (2, 0)), (rot_z, (0, 1))):
        if angle:
            a = np.deg2rad(angle)
            c, s = np.cos(a), np.sin(a)
            vi, vj = v[:, i].copy(), v[:, j].copy()
            v[:, i] = c * vi - s * vj
            v[:, j] = s * vi + c * vj
    v = v + np.asarray(translate, float)
    return Mesh(v, m.faces.copy())


def blob(seed: int, subdivisions: int = 3, amp: float = 0.25,
         stretch=(1.0, 1.0, 1.0)) -> Mesh:
    """Organic stand-in shape: icosphere with smooth low-frequency radial
    displacement (sum of random 3D sinusoids) — used in place of the
    reference's artwork meshes (bunny, lucy, fox, ...)."""
    rng = np.random.default_rng(seed)
    m = create_sphere_mesh(subdivisions=subdivisions)
    v = m.vertices
    disp = np.zeros(len(v))
    for _ in range(4):
        k = rng.normal(size=3) * 2.0
        phase = rng.uniform(0, 2 * np.pi)
        disp += rng.uniform(0.3, 1.0) * np.sin(v @ k + phase)
    disp = disp / (np.abs(disp).max() + 1e-9)
    v = v * (1.0 + amp * disp)[:, None] * np.asarray(stretch)
    return Mesh(v, m.faces)


def box(w, d, h) -> Mesh:
    return xform(create_cube_mesh(1.0), scale=(w, d, h))


def cone(radius: float = 1.0, height: float = 1.0,
         segments: int = 24) -> Mesh:
    ang = 2 * np.pi * np.arange(segments) / segments
    base = np.stack([np.cos(ang) * radius, np.sin(ang) * radius,
                     np.zeros(segments)], axis=1)
    v = np.concatenate([base, [[0, 0, height]], [[0, 0, 0]]])
    apex, cb = segments, segments + 1
    f = []
    for i in range(segments):
        j = (i + 1) % segments
        f += [[i, j, apex], [cb, j, i]]
    return Mesh(v, np.asarray(f))


def crystal(seed: int, sides: int = 6) -> Mesh:
    """Elongated tapered prism (crystal stand-in)."""
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(sides) / sides
    r = rng.uniform(0.6, 1.0, sides)
    ring = np.stack([np.cos(ang) * r, np.sin(ang) * r], axis=1)
    levels = [(0.0, 0.9), (2.2, 0.7), (3.0, 0.15)]
    verts = [np.concatenate([ring * s, np.full((sides, 1), z)], axis=1)
             for z, s in levels]
    v = np.concatenate(verts + [[[0, 0, 3.35]], [[0, 0, -0.1]]])
    apex, cb = 3 * sides, 3 * sides + 1
    f = []
    for lvl in range(2):
        a0, b0 = lvl * sides, (lvl + 1) * sides
        for i in range(sides):
            j = (i + 1) % sides
            f += [[a0 + i, a0 + j, b0 + i], [a0 + j, b0 + j, b0 + i]]
    top = 2 * sides
    for i in range(sides):
        j = (i + 1) % sides
        f += [[top + i, top + j, apex], [cb, j, i]]
    return Mesh(v, np.asarray(f))


def decimated_blob(seed: int, target_faces: int) -> Mesh:
    """High-res blob decimated with the in-tree native QEM remesher —
    stand-in for the multi-resolution lucy meshes (3k/6k/11k)."""
    from renderformer_tpu_torch.scene.remesh import decimate
    m = blob(seed, subdivisions=5, amp=0.3)
    v, f = decimate(m.vertices, m.faces, target_faces)
    return Mesh(v, f)


# ---- composite stand-in objects -------------------------------------------

def teapot() -> Mesh:
    body = xform(create_sphere_mesh(subdivisions=3), scale=(1.0, 1.0, 0.72))
    handle = xform(create_torus_mesh(0.55, 0.12, segments=14),
                   rot_x=90, translate=(-1.05, 0, 0.05))
    spout = xform(cone(0.28, 1.0, 16), rot_y=65, translate=(0.8, 0, 0.1))
    lid = xform(create_sphere_mesh(subdivisions=2),
                scale=(0.32, 0.32, 0.22), translate=(0, 0, 0.72))
    return merge(body, handle, spout, lid)


def tree_mesh() -> Mesh:
    trunk = xform(create_cylinder_mesh(0.12, 1.0, 12), translate=(0, 0, -0.5))
    c1 = xform(cone(0.72, 1.0, 20), translate=(0, 0, -0.15))
    c2 = xform(cone(0.55, 0.85, 20), translate=(0, 0, 0.35))
    c3 = xform(cone(0.38, 0.7, 20), translate=(0, 0, 0.8))
    return merge(trunk, c1, c2, c3)


def table() -> Mesh:
    top = xform(box(1.0, 0.7, 0.06), translate=(0, 0, 0.5))
    legs = [xform(box(0.07, 0.07, 0.5),
                  translate=(sx * 0.43, sy * 0.29, 0.22))
            for sx in (-1, 1) for sy in (-1, 1)]
    return merge(top, *legs)


def bottle() -> Mesh:
    base = create_cylinder_mesh(0.22, 0.75, 16)
    neck = xform(create_cylinder_mesh(0.08, 0.4, 12), translate=(0, 0, 0.5))
    cap = xform(create_sphere_mesh(subdivisions=2),
                scale=(0.1, 0.1, 0.06), translate=(0, 0, 0.7))
    return merge(base, neck, cap)


def banana() -> Mesh:
    """Quarter-torus segment (curved elongated fruit stand-in)."""
    m = create_torus_mesh(0.8, 0.16, segments=20)
    keep = []
    cent = m.vertices[m.faces].mean(axis=1)
    ang = np.arctan2(cent[:, 1], cent[:, 0])
    keep = (ang > -0.2) & (ang < np.pi / 2 + 0.2)
    f = m.faces[keep]
    used = np.unique(f)
    remap = -np.ones(len(m.vertices), int)
    remap[used] = np.arange(len(used))
    return Mesh(m.vertices[used], remap[f])


def basket() -> Mesh:
    outer = create_cylinder_mesh(0.5, 0.4, 20)
    inner = xform(create_cylinder_mesh(0.42, 0.36, 20), translate=(0, 0, 0.05))
    return merge(outer, inner)


def heart(seed: int = 0) -> Mesh:
    """Two lobes + a tapered base (heart stand-in)."""
    l1 = xform(create_sphere_mesh(subdivisions=3),
               scale=(0.52, 0.45, 0.5), translate=(-0.33, 0, 0.35))
    l2 = xform(create_sphere_mesh(subdivisions=3),
               scale=(0.52, 0.45, 0.5), translate=(0.33, 0, 0.35))
    tip = xform(cone(0.62, 1.25, 20), rot_x=180, translate=(0, 0, 0.42))
    return merge(l1, l2, tip)


def horse() -> Mesh:
    bod = blob(11, subdivisions=3, amp=0.12, stretch=(1.25, 0.55, 0.62))
    head = xform(blob(12, subdivisions=2, amp=0.15,
                      stretch=(0.62, 0.35, 0.42)),
                 rot_y=-35, translate=(1.0, 0, 0.65))
    legs = [xform(create_cylinder_mesh(0.09, 0.9, 10),
                  translate=(sx * 0.6, sy * 0.25, -0.8))
            for sx in (-1, 1) for sy in (-1, 1)]
    return merge(bod, head, *legs)


def fox() -> Mesh:
    bod = blob(21, subdivisions=3, amp=0.12, stretch=(1.2, 0.5, 0.55))
    head = xform(blob(22, subdivisions=2, amp=0.1,
                      stretch=(0.5, 0.38, 0.4)),
                 translate=(0.95, 0, 0.45))
    tail = xform(blob(23, subdivisions=2, amp=0.1,
                      stretch=(0.7, 0.22, 0.25)),
                 rot_y=30, translate=(-1.05, 0, 0.15))
    return merge(bod, head, tail)


def shader_shell() -> Mesh:
    """Open outer shell: sphere with a camera-facing cutout."""
    m = create_sphere_mesh(subdivisions=3)
    cent = m.vertices[m.faces].mean(axis=1)
    keep = ~((cent[:, 1] < -0.35) & (cent[:, 2] > -0.2))
    f = m.faces[keep]
    used = np.unique(f)
    remap = -np.ones(len(m.vertices), int)
    remap[used] = np.arange(len(used))
    return Mesh(m.vertices[used] * 1.25, remap[f])


def rf_logo() -> Mesh:
    """Blocky 'rF' glyphs (logo stand-in)."""
    bars = [
        box(0.18, 0.18, 1.5),                                   # R stem
        xform(box(0.55, 0.18, 0.18), translate=(0.3, 0, 0.55)),  # R top
        xform(box(0.18, 0.18, 0.62), rot_y=-35,
              translate=(0.42, 0, -0.25)),                       # R leg
        xform(box(0.18, 0.18, 1.5), translate=(1.1, 0, 0)),      # F stem
        xform(box(0.5, 0.18, 0.18), translate=(1.4, 0, 0.66)),   # F top
        xform(box(0.38, 0.18, 0.18), translate=(1.34, 0, 0.1)),  # F mid
    ]
    m = merge(*bars)
    m.vertices -= m.vertices.mean(axis=0)
    return m


# ---------------------------------------------------------------------------
# scene JSON builders
# ---------------------------------------------------------------------------

def material(diffuse, specular=(0.01, 0.01, 0.01), roughness=0.99,
             emissive=(0.0, 0.0, 0.0), smooth=True, seed=None,
             random_diffuse_max=0.0):
    return {'diffuse': list(diffuse), 'specular': list(specular),
            'roughness': roughness, 'emissive': list(emissive),
            'smooth_shading': smooth, 'rand_tri_diffuse_seed': seed,
            'random_diffuse_max': random_diffuse_max}


def obj_entry(mesh_path, mat, translation=(0, 0, 0), rotation=(0, 0, 0),
              scale=(1.0, 1.0, 1.0), normalize=False, remesh=False,
              remesh_faces=2048):
    return {'mesh_path': mesh_path, 'material': mat,
            'transform': {'translation': list(translation),
                          'rotation': list(rotation),
                          'scale': list(scale), 'normalize': normalize},
            'remesh': remesh, 'remesh_target_face_num': remesh_faces}


def light_entry(emission, translation=(0, 0, 2.1), rotation=(0, 0, 0),
                scale=(2.5, 2.5, 2.5)):
    e = float(emission)
    return obj_entry(
        'templates/lighting/tri.obj',
        material([1, 1, 1], specular=[0, 0, 0], roughness=1.0,
                 emissive=[e, e, e]),
        translation=translation, rotation=rotation, scale=scale)


def backgrounds(which=('plane', 'wall0', 'wall1', 'wall2'),
                diffuse=(0.4, 0.4, 0.4), colored_walls=False, **mat_kw):
    objs = {}
    for i, name in enumerate(which):
        d = list(diffuse)
        if colored_walls and name == 'wall1':
            d = [0.1, 0.4, 0.1]
        if colored_walls and name == 'wall2':
            d = [0.4, 0.1, 0.1]
        objs[f'background_{i}'] = obj_entry(
            f'templates/backgrounds/{name}.obj', material(d, **mat_kw),
            scale=(0.5, 0.5, 0.5))
    return objs


def scene(name, objects, camera_pos, look_at=(0, 0, 0), fov=37.5):
    return {'scene_name': name, 'version': '1.0', 'objects': objects,
            'cameras': [{'position': list(camera_pos),
                         'look_at': list(look_at),
                         'up': [0.0, 0.0, 1.0], 'fov': fov}]}


def cbox_family(object_mesh, obj_kw=None, extra_objects=None,
                name='cornell box'):
    """4 backgrounds + object(s) + overhead light, cam (0,-2,0) fov 37.5
    (the reference cbox-* layout)."""
    objs = backgrounds(colored_walls=True)
    if object_mesh is not None:
        objs['main_object'] = obj_entry(
            object_mesh,
            material([0.6, 0.5, 0.4], specular=[0.3, 0.3, 0.3],
                     roughness=0.4),
            translation=(0, 0, -0.2), scale=(0.45, 0.45, 0.45),
            normalize=True, **(obj_kw or {}))
    for k, v in (extra_objects or {}).items():
        objs[k] = v
    objs['light_0'] = light_entry(5000.0)
    return scene(name, objs, (0.0, -2.0, 0.0))


def build_scenes() -> dict:
    s = {}

    # --- cbox family -----------------------------------------------------
    # boxes remeshed to ~2560 faces like the reference cbox, so
    # per-triangle radiosity has resolution on the large faces
    tall = obj_entry('objects/cbox/tall-box.obj',
                     material([0.7, 0.7, 0.7], specular=[0.5, 0.5, 0.5],
                              roughness=0.3, smooth=False),
                     remesh=True, remesh_faces=2048)
    short = obj_entry('objects/cbox/short-box.obj',
                      material([0.7, 0.7, 0.7], specular=[0.5, 0.5, 0.5],
                               roughness=0.2, smooth=False),
                      remesh=True, remesh_faces=2048)
    s['cbox'] = cbox_family(None, extra_objects={'tall_box': tall,
                                                 'short_box': short})
    s['cornell_box'] = cbox_family(
        'objects/cbox/short-box.obj',
        obj_kw=dict(remesh=False), name='cornell box single')
    s['cbox-bunny'] = cbox_family('objects/classical/bunny.obj',
                                  name='cbox bunny')
    s['cbox-teapot'] = cbox_family('objects/classical/teapot.obj',
                                   name='cbox teapot')
    s['cbox-lucy'] = cbox_family('objects/lucy/11k.obj', name='cbox lucy')
    s['cbox-sphere'] = cbox_family('objects/sphere.obj', name='cbox sphere')
    s['cbox-torus'] = cbox_family('objects/torus.obj', name='cbox torus')

    # --- init-template: backgrounds + light only --------------------------
    objs = backgrounds()
    objs['light_0'] = light_entry(5000.0)
    s['init-template'] = scene('init template', objs, (0.0, -2.0, 0.0))

    # --- compose-scene: plane + 4 objects + 2 lights ----------------------
    objs = {'background_0': obj_entry('objects/compose/plane.obj',
                                      material([0.45, 0.45, 0.45]))}
    for i in range(4):
        objs[f'object_{i}'] = obj_entry(
            f'objects/compose/obj{i}.obj',
            material([0.65, 0.5, 0.35], specular=[0.2, 0.2, 0.2],
                     roughness=0.4))
    objs['light_0'] = light_entry(1341.8, (-1.8, -0.34, 1.0),
                                  (123.9, -5.4, 89.6), (2.11, 2.5, 2.44))
    objs['light_1'] = light_entry(1256.7, (0.653, -1.0, 1.944),
                                  (-170.0, -130.7, 66.7), (2.46, 2.17, 2.38))
    s['compose-scene'] = scene('compose scene', objs, (0.0, -1.35, 0.8),
                               fov=40)

    # --- constant-width: 2 backgrounds + 3 instances + 5 lights ----------
    objs = {
        'background_0': obj_entry(
            'templates/backgrounds/plane.obj',
            material([0.4, 0.4, 0.4], specular=[0.43, 0.43, 0.43],
                     roughness=0.8), scale=(0.5, 0.5, 0.5)),
        'background_1': obj_entry(
            'templates/backgrounds/wall1.obj',
            material([0.4, 0.4, 0.4], specular=[0.41, 0.41, 0.41],
                     roughness=0.026, seed=2333, random_diffuse_max=0.4),
            scale=(0.5, 0.5, 0.5)),
    }
    cw = 'objects/constant-width/constant-width-triangulated.obj'
    spec_rough = [(0.83, 0.108), (0.2, 0.3), (0.05, 0.99)]
    pos = [(-0.3, 0.0, -0.32), (0.1, 0.3, -0.32), (0.12, -0.32, -0.32)]
    for i, ((sp, ro), p) in enumerate(zip(spec_rough, pos)):
        objs[f'random_object_{i}'] = obj_entry(
            cw, material([0.7, 0.6, 0.5], specular=[sp] * 3, roughness=ro),
            translation=p, scale=(0.18, 0.18, 0.18), normalize=True)
    lights = [(633.1, (1.384, 1.486, 1.007), (55.3, -78.4, -171.5),
               (2.09, 2.47, 2.47)),
              (652.4, (1.956, -0.953, 0.824), (-27.0, -40.1, 157.1),
               (2.47, 2.19, 2.09)),
              (687.7, (-0.66, -1.278, 1.823), (-157.2, 137.3, 54.8),
               (2.37, 2.19, 2.17)),
              (758.6, (-2.082, -0.638, 0.452), (9.2, -144.6, -142.0),
               (2.48, 2.13, 2.32)),
              (992.4, (-0.688, 2.409, 0.257), (-1.4, -119.7, -177.6),
               (2.37, 2.16, 2.24))]
    for i, (em, t, r, sc) in enumerate(lights):
        objs[f'light_{i}'] = light_entry(em, t, r, sc)
    s['constant-width'] = scene('constant width', objs, (-1.8, 0, 0.6),
                                fov=30.0)

    # --- crystals: floor + 5 crystals + light -----------------------------
    objs = {'background_0': obj_entry(
        'templates/backgrounds/plane.obj',
        material([0.35, 0.35, 0.38], specular=[0.5, 0.5, 0.5],
                 roughness=0.05), scale=(0.5, 0.5, 0.5))}
    colors = {'green': [0.2, 0.7, 0.3], 'pink': [0.9, 0.5, 0.65],
              'purple': [0.55, 0.35, 0.8], 'blue': [0.3, 0.45, 0.9],
              'red': [0.85, 0.2, 0.2]}
    specs = {'green': 0.25, 'pink': 0.3, 'purple': 0.4, 'blue': 0.3,
             'red': 0.0}
    for name, dif in colors.items():
        sp = specs[name]
        objs[name] = obj_entry(
            f'objects/crystals/{name}.obj',
            material(dif, specular=[sp] * 3,
                     roughness=0.5 if name != 'red' else 1.0))
    objs['light_0'] = light_entry(5000.0, (1.47, 0.0, 1.47))
    s['crystals'] = scene('crystals', objs, (0.0, -1.28, 0.7),
                          look_at=(0.0, -0.55, 0.0))

    # --- fox-in-the-wild ---------------------------------------------------
    objs = {
        'background_0': obj_entry('templates/backgrounds/plane.obj',
                                  material([0.38, 0.42, 0.3]),
                                  scale=(0.8, 0.8, 0.5)),
        'rock': obj_entry('objects/fox-in-the-wild/rock.obj',
                          material([0.45, 0.44, 0.42], roughness=0.9)),
        'fox': obj_entry('objects/fox-in-the-wild/fox.obj',
                         material([0.8, 0.45, 0.2], roughness=0.8)),
        'trunk': obj_entry('objects/fox-in-the-wild/tree-trunk.obj',
                           material([0.4, 0.28, 0.18], roughness=0.95)),
        'leaves': obj_entry('objects/fox-in-the-wild/tree-leaves.obj',
                            material([0.2, 0.5, 0.25], roughness=0.9),
                            translation=(0, 0, 0.1)),
        'light_0': light_entry(5000.0),
    }
    s['fox-in-the-wild'] = scene('fox in the wild', objs, (0.0, -2.0, 0.26),
                                 look_at=(0.0, -0.6, 0.0), fov=30.0)

    # --- horse-and-heart ----------------------------------------------------
    objs = {
        'background_0': obj_entry('templates/backgrounds/plane.obj',
                                  material([0.42, 0.42, 0.42]),
                                  scale=(0.5, 0.5, 0.5)),
        'horse': obj_entry('objects/horse-and-heart/horse.obj',
                           material([0.35, 0.35, 0.38], specular=[0.2] * 3,
                                    roughness=0.5)),
        'heart-gray': obj_entry('objects/horse-and-heart/heart-gray.obj',
                                material([0.5, 0.5, 0.5], roughness=0.8)),
        'heart-red': obj_entry('objects/horse-and-heart/heart-red.obj',
                               material([0.75, 0.12, 0.12],
                                        specular=[0.3] * 3, roughness=0.4)),
        'light_0': light_entry(5000.0),
    }
    s['horse-and-heart'] = scene('horse and heart', objs, (0.0, -1.25, 0.66),
                                 look_at=(0.0, 0.0, -0.35))

    # --- renderformer-logo ---------------------------------------------------
    objs = {
        'background_0': obj_entry('templates/backgrounds/plane.obj',
                                  material([0.45, 0.45, 0.45]),
                                  scale=(0.5, 0.5, 0.5)),
        'background_1': obj_entry('templates/backgrounds/wall0.obj',
                                  material([0.45, 0.45, 0.45]),
                                  scale=(0.5, 0.5, 0.5)),
        'background_3': obj_entry('templates/backgrounds/wall2.obj',
                                  material([0.45, 0.45, 0.45]),
                                  scale=(0.5, 0.5, 0.5)),
        'rf': obj_entry('objects/renderformer-logo/rf.obj',
                        material([0.2, 0.45, 0.85], specular=[0.4] * 3,
                                 roughness=0.3, smooth=False),
                        translation=(0, 0, -0.25), scale=(0.4, 0.4, 0.4),
                        normalize=True),
        'light_0': light_entry(2500.0, (0.0, -2.1, 0.23)),
        'light_1': light_entry(2500.0, (2.1, -0.15, 0.23)),
    }
    s['renderformer-logo'] = scene(
        'renderformer logo', objs, (1.27783, -2.00556, 0.712328),
        look_at=(0.0, -0.07, -0.12), fov=32.0)

    # --- room -----------------------------------------------------------------
    objs = {
        'background_0': obj_entry('templates/backgrounds/plane.obj',
                                  material([0.5, 0.48, 0.45]),
                                  scale=(0.5, 0.5, 0.5)),
        'background_1': obj_entry('templates/backgrounds/wall0.obj',
                                  material([0.5, 0.48, 0.45]),
                                  scale=(0.5, 0.5, 0.5)),
        'background_3': obj_entry('templates/backgrounds/wall2.obj',
                                  material([0.5, 0.48, 0.45]),
                                  scale=(0.5, 0.5, 0.5)),
        'table': obj_entry('objects/room/table.obj',
                           material([0.45, 0.3, 0.18], roughness=1.0),
                           translation=(0, 0, -0.5), scale=(0.42, 0.42, 0.42)),
        'banana': obj_entry('objects/room/banana.obj',
                            material([0.85, 0.75, 0.2], roughness=1.0),
                            translation=(-0.1, 0.05, -0.22),
                            scale=(0.16, 0.16, 0.16)),
        'basket': obj_entry('objects/room/basket.obj',
                            material([0.55, 0.4, 0.25], roughness=1.0),
                            translation=(0.12, 0.1, -0.2),
                            scale=(0.14, 0.14, 0.14)),
        'bottle': obj_entry('objects/room/bottle.obj',
                            material([0.3, 0.55, 0.35], specular=[0.2] * 3,
                                     roughness=0.3),
                            translation=(-0.05, -0.12, -0.16),
                            scale=(0.12, 0.12, 0.12)),
        'light_0': light_entry(5000.0, (0.0, -1.47, 1.47), (90.0, 0.0, 0.0)),
    }
    s['room'] = scene('room', objs, (1.0, -1.0, 0.86),
                      look_at=(0.0, 0.0, -0.25))

    # --- shader-ball -------------------------------------------------------------
    objs = backgrounds()
    objs['ball'] = obj_entry('objects/shader-ball/ball.obj',
                             material([0.6, 0.6, 0.62], specular=[0.8] * 3,
                                      roughness=0.3),
                             translation=(0, 0, -0.28),
                             scale=(0.2, 0.2, 0.2))
    objs['shell'] = obj_entry('objects/shader-ball/shell.obj',
                              material([0.4, 0.4, 0.4], roughness=1.0),
                              translation=(0, 0, -0.28),
                              scale=(0.22, 0.22, 0.22))
    objs['light_0'] = light_entry(5000.0)
    s['shader-ball'] = scene('shader ball', objs, (0.0, -1.6, 0.52),
                             look_at=(0.0, 0.0, -0.15))

    # --- tree --------------------------------------------------------------------
    objs = {
        'background_0': obj_entry(
            'templates/backgrounds/plane.obj',
            material([0.4, 0.4, 0.4], specular=[0.7, 0.7, 0.7],
                     roughness=0.03), scale=(0.5, 0.5, 0.5)),
        'background_1': obj_entry(
            'templates/backgrounds/wall0.obj',
            material([0.4, 0.4, 0.4], specular=[0.76, 0.76, 0.76],
                     roughness=0.999), scale=(0.5, 0.5, 0.5)),
        'background_2': obj_entry(
            'templates/backgrounds/wall1.obj',
            material([0.4, 0.4, 0.4], specular=[0.115, 0.115, 0.115],
                     roughness=0.7), scale=(0.5, 0.5, 0.5)),
        'random_object_1': obj_entry(
            'objects/tree/tree.obj',
            material([0.3, 0.5, 0.3], specular=[0.83, 0.83, 0.83],
                     roughness=0.138),
            translation=(0, 0, -0.1), scale=(0.4, 0.4, 0.4), normalize=True),
        'light_0': light_entry(2163.7, (-0.825, 0.318, 1.979),
                               (-149.7, 68.0, -44.0), (2.48, 2.48, 2.22)),
        'light_1': light_entry(2277.3, (1.372, -1.903, 0.387),
                               (-160.9, 112.6, -74.8), (2.12, 2.28, 2.3)),
    }
    s['tree'] = scene('tree', objs, (-1.0, -1.0, 1.0), fov=45)

    # --- veach-mis ------------------------------------------------------------------
    objs = {'background_0': obj_entry('templates/backgrounds/plane.obj',
                                      material([0.4, 0.4, 0.4],
                                               specular=[0.0] * 3,
                                               roughness=0.99),
                                      translation=(0, 0, 0.21),
                                      scale=(0.5, 0.5, 0.5))}
    for i in range(1, 4):
        objs[f'sphere{i}'] = obj_entry(
            f'objects/veach-mis/sphere{i}.obj',
            material([1.0, 1.0, 1.0], specular=[0.0] * 3, roughness=1.0))
    for i, rough in zip(range(1, 5), (0.005, 0.02, 0.05, 0.1)):
        objs[f'block{i}'] = obj_entry(
            f'objects/veach-mis/block{i}.obj',
            material([0.3, 0.3, 0.3], specular=[0.9, 0.9, 0.9],
                     roughness=rough, smooth=False))
    objs['light_0'] = light_entry(5000.0, (0.0, -2.1, 0.65))
    s['veach-mis'] = scene('veach mis', objs, (0.0, -2.0, 0.0), fov=30.0)

    return s


# ---------------------------------------------------------------------------
# asset generation
# ---------------------------------------------------------------------------

def write_objects(out: str):
    def w(rel, mesh):
        path = os.path.join(out, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        save_obj(path, mesh)
        print(f'  {rel}: {len(mesh.faces)} faces')

    # templates (reference-compatible names)
    w('templates/backgrounds/plane.obj', grid_plane())
    w('templates/backgrounds/wall0.obj', wall('y', 1))   # back (y=+1)
    w('templates/backgrounds/wall1.obj', wall('x', 1))   # right (x=+1)
    w('templates/backgrounds/wall2.obj', wall('x', -1))  # left (x=-1)
    w('templates/lighting/tri.obj', light_tri())

    # simple shared objects
    w('objects/cube.obj', create_cube_mesh())
    w('objects/sphere.obj', create_sphere_mesh(subdivisions=3))
    w('objects/torus.obj', create_torus_mesh(segments=24))

    # cbox boxes (baked placement, like the reference)
    w('objects/cbox/tall-box.obj',
      xform(box(0.3, 0.3, 0.6), rot_z=17, translate=(-0.17, 0.16, -0.2)))
    w('objects/cbox/short-box.obj',
      xform(box(0.3, 0.3, 0.3), rot_z=-17, translate=(0.18, -0.16, -0.35)))

    # classical stand-ins
    w('objects/classical/bunny.obj', blob(7, subdivisions=3, amp=0.28))
    w('objects/classical/teapot.obj', teapot())
    w('objects/lucy/3k.obj', decimated_blob(40, 3072))
    w('objects/lucy/6k.obj', decimated_blob(40, 6144))
    w('objects/lucy/11k.obj', decimated_blob(40, 11264))

    # compose
    w('objects/compose/plane.obj', xform(grid_plane(), scale=0.5))
    w('objects/compose/obj0.obj',
      xform(blob(31, amp=0.2), scale=0.16, translate=(-0.25, 0.1, -0.34)))
    w('objects/compose/obj1.obj',
      xform(create_torus_mesh(segments=20), scale=0.12,
            translate=(0.22, 0.2, -0.4)))
    w('objects/compose/obj2.obj',
      xform(box(1, 1, 1), rot_z=30, scale=0.2, translate=(0.05, -0.25, -0.4)))
    w('objects/compose/obj3.obj',
      xform(create_sphere_mesh(subdivisions=3), scale=0.14,
            translate=(-0.05, 0.35, -0.36)))

    # constant-width
    w('objects/constant-width/constant-width-triangulated.obj',
      blob(55, subdivisions=3, amp=0.12))

    # crystals (baked positions around the camera target)
    pos = {'green': (-0.28, -0.5, -0.5), 'pink': (0.3, -0.45, -0.5),
           'purple': (0.0, -0.62, -0.5), 'blue': (-0.12, -0.3, -0.5),
           'red': (0.15, -0.7, -0.5)}
    for i, (name, p) in enumerate(pos.items()):
        w(f'objects/crystals/{name}.obj',
          xform(crystal(60 + i), scale=0.08,
                rot_x=float(np.random.default_rng(i).uniform(-12, 12)),
                translate=p))

    # fox-in-the-wild (baked placement)
    w('objects/fox-in-the-wild/fox.obj',
      xform(fox(), scale=0.17, rot_z=-25, translate=(0.0, -0.55, -0.4)))
    w('objects/fox-in-the-wild/rock.obj',
      xform(blob(71, subdivisions=3, amp=0.3, stretch=(1.2, 1.0, 0.6)),
            scale=0.14, translate=(0.3, -0.35, -0.44)))
    w('objects/fox-in-the-wild/tree-trunk.obj',
      xform(create_cylinder_mesh(0.12, 1.0, 12), scale=0.5,
            translate=(-0.25, 0.1, -0.3)))
    w('objects/fox-in-the-wild/tree-leaves.obj',
      xform(merge(cone(0.7, 1.0, 20),
                  xform(cone(0.5, 0.8, 20), translate=(0, 0, 0.45))),
            scale=0.5, translate=(-0.25, 0.1, -0.15)))

    # horse-and-heart (baked placement)
    w('objects/horse-and-heart/horse.obj',
      xform(horse(), scale=0.2, rot_z=90, translate=(-0.12, 0.0, -0.28)))
    w('objects/horse-and-heart/heart-gray.obj',
      xform(heart(), scale=0.12, translate=(0.22, -0.18, -0.42)))
    w('objects/horse-and-heart/heart-red.obj',
      xform(heart(), scale=0.14, rot_z=30, translate=(0.3, 0.05, -0.4)))

    # logo / room / shader-ball / tree / veach-mis
    w('objects/renderformer-logo/rf.obj', rf_logo())
    w('objects/room/table.obj', table())
    w('objects/room/banana.obj', banana())
    w('objects/room/basket.obj', basket())
    w('objects/room/bottle.obj', bottle())
    w('objects/shader-ball/ball.obj', create_sphere_mesh(subdivisions=3))
    w('objects/shader-ball/shell.obj', shader_shell())
    w('objects/tree/tree.obj', tree_mesh())
    for i, (r, p) in enumerate(
            [(0.09, (-0.28, 0.0, -0.41)), (0.12, (0.0, 0.1, -0.38)),
             (0.16, (0.32, 0.2, -0.34))], start=1):
        w(f'objects/veach-mis/sphere{i}.obj',
          xform(create_sphere_mesh(subdivisions=3), scale=r, translate=p))
    for i, (tilt, y) in enumerate(
            [(70, -0.1), (62, 0.05), (54, 0.2), (46, 0.35)], start=1):
        w(f'objects/veach-mis/block{i}.obj',
          xform(box(0.8, 0.12, 0.02), rot_x=tilt,
                translate=(0.0, y, -0.25 + 0.07 * i)))


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split('\n\n')[0]).parse_args(argv)
    out = 'examples'
    write_objects(out)
    for name, sc in build_scenes().items():
        with open(f'{out}/{name}.json', 'w') as f:
            json.dump(sc, f, indent=2)
        print(f'wrote {out}/{name}.json')


if __name__ == '__main__':
    main()
