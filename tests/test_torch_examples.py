"""The port's example tools against the JAX package's: each writes the JAX
tool's files byte for byte (``create_examples`` also the committed
``examples/``), and the orbit frames of ``tools.make_video_frames`` equal
the JAX tool's array by array after an H5 round trip."""

import filecmp
import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_tree(a, b):
    fa, fb = _files(a), _files(b)
    assert fa == fb
    _, mismatch, errors = filecmp.cmpfiles(a, b, fa, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    return fa


@pytest.mark.parametrize('tool,out', [('create_sample_meshes', 'sample_meshes'),
                                      ('create_scene_configs', 'scene_configs'),
                                      ('create_examples', 'examples')])
def test_example_tools_write_the_jax_tools_files(tool, out, tmp_path, monkeypatch):
    import importlib
    monkeypatch.syspath_prepend(REPO)
    jax_tool = importlib.import_module(tool)
    port_tool = importlib.import_module(f'renderformer_tpu_torch.{tool}')
    for name, mod in (('jax', jax_tool), ('port', port_tool)):
        os.makedirs(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        mod.main() if name == 'jax' else mod.main([])
    files = _same_tree(str(tmp_path / 'jax' / out), str(tmp_path / 'port' / out))
    assert files
    if tool == 'create_examples':
        # run in the repo root, it rewrites the committed files
        assert _same_tree(os.path.join(REPO, 'examples'), str(tmp_path / 'port' / out)) == files


def test_scene_configs_draw_in_the_jax_order(tmp_path, monkeypatch):
    """The random scenes depend on the draws' order: seeded alike, the
    port's and the JAX tool's random scene configs are the same dicts."""
    import random
    monkeypatch.syspath_prepend(REPO)
    import create_scene_configs as jax_tool
    from renderformer_tpu_torch import create_scene_configs as port_tool
    random.seed(3)
    want = [jax_tool.create_random_scene_config(f'r{i}') for i in range(4)]
    random.seed(3)
    got = [port_tool.create_random_scene_config(f'r{i}') for i in range(4)]
    assert got == want
    assert port_tool.MATERIAL_PRESETS == jax_tool.MATERIAL_PRESETS


def test_orbit_frames_match_the_jax_tool(tmp_path):
    import h5py
    sys.path.insert(0, REPO)
    from tools import make_video_frames as jax_tool
    from renderformer_tpu_torch.tools import make_video_frames as port_tool
    scene = os.path.join(REPO, 'examples', 'cornell_box.json')
    n = 3
    jax_tool.main(['--scene', scene, '--out', str(tmp_path / 'jax'), '--frames', str(n),
                   '--arc', '90'])
    port_tool.main(['--scene', scene, '--out', str(tmp_path / 'port'), '--frames', str(n),
                    '--arc', '90'])
    frames = port_tool.orbit_frames(scene, n, 90.0)
    assert sorted(os.listdir(tmp_path / 'port')) == sorted(os.listdir(tmp_path / 'jax')) == [
        f'frame_{i:04d}.h5' for i in range(n)]
    keys = ('triangles', 'vn', 'texture', 'c2w', 'fov')
    for i in range(n):
        with h5py.File(tmp_path / 'jax' / f'frame_{i:04d}.h5', 'r') as fj, \
                h5py.File(tmp_path / 'port' / f'frame_{i:04d}.h5', 'r') as fp:
            assert sorted(fp.keys()) == sorted(fj.keys()) == sorted(keys)
            for k in keys:
                a, b = np.asarray(fp[k]), np.asarray(fj[k])
                assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k
                # the arrays the function returns are what the file holds
                np.testing.assert_array_equal(frames[i][k].astype(a.dtype), a)
    # the orbit moves the camera, keeping its distance to the target
    with open(scene) as f:
        target = np.asarray(json.load(f)['cameras'][0]['look_at'])
    c2w = np.stack([f['c2w'][0] for f in frames])
    assert not np.allclose(c2w[0], c2w[1])
    d = np.linalg.norm(c2w[:, :3, 3] - target, axis=-1)
    assert np.ptp(d) < 1e-5 * d.max()
