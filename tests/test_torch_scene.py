"""The port's scene data plane (renderformer_tpu_torch.scene, utils/look_at)
against the JAX package's, bit for bit on the same inputs: look-at
cameras, the scene config's round trip, the mesh operations, OBJ bytes,
the native remesh (the port builds the same C++ source), the scene
tensors of in-repo examples, and the convert_scene command lines."""

import json
import os
import random

import numpy as np
import pytest

from renderformer_tpu.scene import mesh as jmesh
from renderformer_tpu.scene import scene_config as jcfg
from renderformer_tpu.scene.scene_mesh import generate_scene_meshes as j_meshes
from renderformer_tpu.scene.to_h5 import scene_to_tensors as j_tensors
from renderformer_tpu.utils.look_at import look_at_to_c2w as j_look_at
from renderformer_tpu_torch.scene import mesh as tmesh
from renderformer_tpu_torch.scene import scene_config as tcfg
from renderformer_tpu_torch.scene.scene_mesh import generate_scene_meshes as t_meshes
from renderformer_tpu_torch.scene.to_h5 import scene_to_tensors as t_tensors
from renderformer_tpu_torch.utils.look_at import look_at_to_c2w as t_look_at

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, 'examples')


def _same(a, b):
    """Equal arrays, dtype and shape included (bit for bit)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def _cube(mod):
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                  [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], float)
    f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                  [1, 2, 6], [1, 6, 5], [2, 3, 7], [2, 7, 6], [3, 0, 4], [3, 4, 7]])
    return mod.Mesh(v, f)


def _soup(mod, seed=0):
    """A seeded mesh over a jittered grid: shared edges, creases, two
    components."""
    rng = np.random.default_rng(seed)
    n = 7
    xs, ys = np.meshgrid(np.arange(n), np.arange(n), indexing='ij')
    v = np.stack([xs.ravel(), ys.ravel(), rng.normal(size=n * n) * 0.4], -1).astype(float)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a, b, c, d = i * n + j, i * n + j + 1, (i + 1) * n + j, (i + 1) * n + j + 1
            faces += [[a, b, c], [b, d, c]]
    f = np.asarray(faces)
    second = v + [20.0, 0, 0]
    return mod.Mesh(np.concatenate([v, second]), np.concatenate([f, f + n * n]))


def _uv_sphere():
    nu, nv_ = 24, 16
    verts, faces = [], []
    for i in range(nv_ + 1):
        theta = np.pi * i / nv_
        for j in range(nu):
            phi = 2 * np.pi * j / nu
            verts.append([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi),
                          np.cos(theta)])
    for i in range(nv_):
        for j in range(nu):
            a, b = i * nu + j, i * nu + (j + 1) % nu
            c, d = (i + 1) * nu + j, (i + 1) * nu + (j + 1) % nu
            faces += [[a, b, c], [b, d, c]]
    return np.asarray(verts, float), np.asarray(faces)


def test_look_at_bit_for_bit():
    rng = np.random.default_rng(0)
    for _ in range(8):
        pos, tgt = rng.normal(size=3) * 3, rng.normal(size=3) * 0.3
        _same(t_look_at(pos, tgt, (0.0, 0.0, 1.0)), j_look_at(pos, tgt, (0.0, 0.0, 1.0)))
    _same(t_look_at([0.0, -2.0, 0.0]), j_look_at([0.0, -2.0, 0.0]))


def test_scene_config_round_trip(tmp_path):
    path = os.path.join(EXAMPLES, 'cbox.json')
    j, t = jcfg.load_scene_config(path), tcfg.load_scene_config(path)
    d = tcfg.scene_config_to_dict(t)
    assert d == jcfg.scene_config_to_dict(j)
    assert tcfg.scene_config_to_dict(tcfg.scene_config_from_dict(d)) == d
    tcfg.save_scene_config(str(tmp_path / 't.json'), t)
    jcfg.save_scene_config(str(tmp_path / 'j.json'), j)
    assert (tmp_path / 't.json').read_bytes() == (tmp_path / 'j.json').read_bytes()
    bad = json.loads(json.dumps(d))
    bad['objects']['light_0']['material']['glow'] = 1.0
    with pytest.raises(ValueError, match='unknown keys'):
        tcfg.scene_config_from_dict(bad)
    del bad['objects']['light_0']['material']['glow'], bad['cameras'][0]['fov']
    with pytest.raises(ValueError, match='missing key'):
        tcfg.scene_config_from_dict(bad)


@pytest.mark.parametrize('make', [_cube, _soup], ids=['cube', 'soup'])
def test_mesh_operations_bit_for_bit(make):
    j, t = make(jmesh), make(tmesh)
    _same(t.face_normals(), j.face_normals())
    _same(t.face_angles(), j.face_angles())
    _same(t.compute_vertex_normals(), j.compute_vertex_normals())
    _same(t.corner_normals(), j.corner_normals())
    comps_t, comps_j = t.connected_components(), j.connected_components()
    assert len(comps_t) == len(comps_j)
    for a, b in zip(comps_t, comps_j):
        _same(a, b)
    for crease in (30.0, 60.0):
        st, sj = t.copy().smooth_shaded(crease), j.copy().smooth_shaded(crease)
        for k in ('vertices', 'faces', 'vertex_normals'):
            _same(getattr(st, k), getattr(sj, k))
    ft, fj = t.copy().split_faces(), j.copy().split_faces()
    for k in ('vertices', 'faces', 'vertex_normals'):
        _same(getattr(ft, k), getattr(fj, k))
    for scale in ([1.5, 1.5, 1.5], [2.0, 0.5, 1.0]):
        mt = (t.copy().normalize_to_unit_sphere().apply_rotation_euler_deg([10, 200, 33])
              .apply_scale(scale).apply_translation([0.1, -0.2, 0.3]))
        mj = (j.copy().normalize_to_unit_sphere().apply_rotation_euler_deg([10, 200, 33])
              .apply_scale(scale).apply_translation([0.1, -0.2, 0.3]))
        _same(mt.vertices, mj.vertices)
        _same(mt.vertex_normals, mj.vertex_normals)
    ct = tmesh.concatenate([t, t.copy().apply_translation([3, 0, 0])])
    cj = jmesh.concatenate([j, j.copy().apply_translation([3, 0, 0])])
    for k in ('vertices', 'faces', 'vertex_normals'):
        _same(getattr(ct, k), getattr(cj, k))


def test_obj_bytes_and_load(tmp_path):
    t, j = _soup(tmesh, 1), _soup(jmesh, 1)
    colors = np.random.default_rng(2).uniform(0, 1, (len(t.faces), 3))
    t.face_colors, j.face_colors = colors, colors.copy()
    for normals in (True, False):
        pt, pj = tmp_path / f't{normals}.obj', tmp_path / f'j{normals}.obj'
        tmesh.save_obj(str(pt), t, include_normals=normals)
        jmesh.save_obj(str(pj), j, include_normals=normals)
        assert pt.read_bytes() == pj.read_bytes()
        lt, lj = tmesh.load_obj(str(pt)), jmesh.load_obj(str(pj))
        for k in ('vertices', 'faces', 'vertex_normals', 'face_colors'):
            a, b = getattr(lt, k), getattr(lj, k)
            assert (a is None) == (b is None), k
            if a is not None:
                _same(a, b)


def test_native_remesh_bit_for_bit():
    """The port builds native/meshops.cpp itself (never into native/) and
    gives the JAX package's arrays for the same input."""
    from renderformer_tpu.scene import remesh as jr
    from renderformer_tpu_torch.scene import remesh as tr
    lib = tr.build()
    assert lib.startswith(tr.BUILD_ROOT) and os.path.exists(lib)
    v, f = _uv_sphere()
    for a, b in zip(tr.decimate(v, f, 200), jr.decimate(v, f, 200)):
        _same(a, b)
    cube = _cube(tmesh)
    for a, b in zip(tr.remesh(cube.vertices, cube.faces, 500),
                    jr.remesh(cube.vertices, cube.faces, 500)):
        _same(a, b)


def _seeded_scene():
    """Two objects with rand_tri_diffuse_seed (per-triangle and
    per-shading-group) between a plain one and a light."""
    def obj(mesh, seed=None, kind='per-shading-group', emissive=(0.0, 0.0, 0.0),
            smooth=True, t=(0.0, 0.0, 0.0)):
        return {'mesh_path': mesh,
                'material': {'diffuse': [0.3, 0.6, 0.9], 'specular': [0.2, 0.2, 0.2],
                             'roughness': 0.4, 'emissive': list(emissive),
                             'smooth_shading': smooth, 'rand_tri_diffuse_seed': seed,
                             'random_diffuse_max': 0.7, 'random_diffuse_type': kind},
                'transform': {'translation': list(t), 'rotation': [15.0, 30.0, 45.0],
                              'scale': [0.5, 0.4, 0.3], 'normalize': True}}
    return {'scene_name': 'seeded', 'version': '1.0',
            'objects': {'a': obj('objects/sphere.obj', 7, 'per-triangle'),
                        'b': obj('objects/torus.obj', 11, t=(0.3, 0.0, 0.0)),
                        'c': obj('objects/cube.obj', smooth=False, t=(-0.3, 0.0, 0.0)),
                        'light': obj('templates/lighting/tri.obj', emissive=(50.0,) * 3,
                                     t=(0.0, 0.0, 1.5))},
            'cameras': [{'position': [0.0, -2.0, 0.5], 'look_at': [0.0, 0.0, 0.0],
                         'up': [0.0, 0.0, 1.0], 'fov': 40.0},
                        {'position': [1.5, -1.5, 0.2], 'look_at': [0.0, 0.0, 0.1],
                         'up': [0.0, 0.0, 1.0], 'fov': 55.0}]}


@pytest.mark.parametrize('name', ['cbox', 'veach-mis', 'shader-ball', 'seeded'])
def test_scene_to_tensors_bit_for_bit(name):
    """cbox runs the native remesh; 'seeded' the seeded per-triangle and
    per-shading-group diffuse, whose draws use Python's and numpy's global
    generators in the JAX package's order."""
    if name == 'seeded':
        d = _seeded_scene()
        cj, ct = jcfg.scene_config_from_dict(d), tcfg.scene_config_from_dict(d)
    else:
        path = os.path.join(EXAMPLES, f'{name}.json')
        cj, ct = jcfg.load_scene_config(path), tcfg.load_scene_config(path)
    random.seed(123)
    want = j_tensors(cj, j_meshes(cj, EXAMPLES))
    after_j = random.random()
    random.seed(123)
    got = t_tensors(ct, t_meshes(ct, EXAMPLES))
    assert random.random() == after_j  # the global generator left in the same state
    assert sorted(got) == sorted(want)
    for k in want:
        _same(got[k], want[k])
    if name == 'cbox':  # the in-repo cbox: 4,326 triangles, one light
        assert got['triangles'].shape == (4326, 3, 3)
        assert (got['texture'][:, 10:13].max(axis=(1, 2, 3)) > 0).sum() == 1
    if name == 'seeded':
        diffuse = got['texture'][:, 0:3, 0, 0]
        assert len(np.unique(diffuse, axis=0)) > 10  # the seeded colours, not the config's


def test_convert_scene_cli_same_arrays(tmp_path, monkeypatch):
    """One JSON through both packages' convert_scene command lines: the same
    arrays read back with h5py, and the same dict <-> H5 bridge."""
    import sys

    import h5py
    from renderformer_tpu.scene import convert_scene as jconv
    from renderformer_tpu.scene import h5_tools as jh5
    from renderformer_tpu_torch.scene import convert_scene as tconv
    from renderformer_tpu_torch.scene import h5_tools as th5
    src = os.path.join(EXAMPLES, 'shader-ball.json')
    out_t, out_j = str(tmp_path / 't.h5'), str(tmp_path / 'j.h5')
    tconv.main([src, out_t])
    monkeypatch.setattr(sys, 'argv', ['convert_scene', src, out_j])
    jconv.main()
    with h5py.File(out_t, 'r') as ft, h5py.File(out_j, 'r') as fj:
        assert sorted(ft) == sorted(fj) == ['c2w', 'fov', 'texture', 'triangles', 'vn']
        for k in fj:
            _same(np.asarray(ft[k]), np.asarray(fj[k]))
    with open(src) as f:
        d = json.load(f)
    th5.json_to_h5(src, str(tmp_path / 'dt.h5'))
    jh5.json_to_h5(src, str(tmp_path / 'dj.h5'))
    assert th5.load_dict_from_h5(str(tmp_path / 'dt.h5')) == jh5.load_dict_from_h5(
        str(tmp_path / 'dj.h5'))
    th5.h5_to_json(str(tmp_path / 'dt.h5'), str(tmp_path / 'back.json'))
    with open(tmp_path / 'back.json') as f:
        back = json.load(f)
    assert tcfg.scene_config_to_dict(tcfg.scene_config_from_dict(back)) == \
        tcfg.scene_config_to_dict(tcfg.scene_config_from_dict(d))
