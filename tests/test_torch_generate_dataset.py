"""The port's dataset generator and H5 inspector (python -m
renderformer_tpu_torch.generate_dataset / .render_h5_to_png) on the CPU:
the same scene JSONs and H5 arrays as the JAX package's generate_dataset.py
at the same --seed, the in-memory conversion the GT pass takes equal to
the H5 file read back, and the pathtrace, raster and model GT modes
writing their PNGs."""

import glob
import json
import os

import h5py
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBJS = os.path.join(REPO, 'examples', 'objects', 'cbox')


def _args(root, mode, seed=3, n=2, *extra):
    return ['--data_path', str(root), '--obj_path', OBJS, '--num_scenes', str(n),
            '--gt_mode', mode, '--gt_resolution', '32', '--gt_spp', '4',
            '--gt_preset', 'tiny', '--seed', str(seed), *extra]


def _png(path):
    import imageio.v3 as iio
    return iio.imread(path)


@pytest.fixture
def at_repo(monkeypatch):
    monkeypatch.chdir(REPO)  # the scene JSONs name examples/ relative to the root
    monkeypatch.syspath_prepend(REPO)


def test_scenes_match_the_jax_generator(tmp_path, at_repo):
    import generate_dataset as jgd
    from renderformer_tpu_torch import generate_dataset as tgd
    from renderformer_tpu_torch.io.h5 import load_scene_h5
    assert tgd.main(_args(tmp_path / 'port', 'none')) == 0
    assert jgd.main(_args(tmp_path / 'jax', 'none')) == 0
    names = sorted(os.listdir(tmp_path / 'jax' / 'json'))
    assert len(names) == 2 and sorted(os.listdir(tmp_path / 'port' / 'json')) == names
    for name in names:
        assert ((tmp_path / 'port' / 'json' / name).read_bytes()
                == (tmp_path / 'jax' / 'json' / name).read_bytes())
        h5 = name[:-5] + '.h5'
        with h5py.File(tmp_path / 'port' / 'h5' / h5) as ft, \
                h5py.File(tmp_path / 'jax' / 'h5' / h5) as fj:
            assert sorted(ft) == sorted(fj)
            for k in fj:
                np.testing.assert_array_equal(np.asarray(ft[k]), np.asarray(fj[k]))
                assert ft[k].dtype == fj[k].dtype
        # the GT pass's in-memory conversion is the H5 file read back
        with open(tmp_path / 'port' / 'json' / name) as f:
            mem = tgd.scene_tensors(json.load(f))
        disk = load_scene_h5(str(tmp_path / 'port' / 'h5' / h5))
        assert sorted(mem) == sorted(disk)
        for k in disk:
            np.testing.assert_array_equal(mem[k], disk[k])
            assert mem[k].dtype == disk[k].dtype
    assert not os.listdir(tmp_path / 'port' / 'gt')


@pytest.mark.parametrize('mode', ['pathtrace', 'raster'])
def test_gt_modes_write_pngs(tmp_path, at_repo, mode):
    from renderformer_tpu_torch import generate_dataset as tgd
    assert tgd.main(_args(tmp_path, mode, 5, 1, '--cpu')) == 0
    pngs = glob.glob(str(tmp_path / 'gt' / '*.png'))
    assert len(pngs) == 1
    img = _png(pngs[0])
    assert img.shape == (32, 32, 3) and img.dtype == np.uint8 and img.max() > 0


def test_gt_pass_on_scene_dicts(tmp_path, at_repo):
    """render_gt takes scene dicts (no H5): pathtrace and the tiny model on
    the CPU, each writing a PNG a scene; the returned images are the
    files'."""
    import random

    from renderformer_tpu_torch import generate_dataset as tgd
    random.seed(0)
    gen = tgd.SceneGenerator(tgd.build_config(tgd.build_parser().parse_args(
        _args(tmp_path / 'ds', 'pathtrace', 0))))
    scenes = {}
    for i in range(2):
        name, scene = gen.next_scene(i)
        scenes[name] = tgd.scene_tensors(scene)
    for mode in ('pathtrace', 'model'):
        out = tgd.render_gt(scenes, mode, str(tmp_path / mode), resolution=32, spp=4,
                            preset='tiny', device='cpu')
        assert sorted(out) == sorted(scenes)
        for name, img in out.items():
            np.testing.assert_array_equal(_png(str(tmp_path / mode / f'{name}.png')), img)
    with pytest.raises(ValueError, match='renders in no GT pass'):
        tgd.render_gt(scenes, 'blender', str(tmp_path))


def test_render_h5_to_png(tmp_path, at_repo, capsys):
    """The inspector prints the datasets; the debug raster is the JAX
    script's bit for bit; --pathtrace --cpu writes a path-traced PNG."""
    import render_h5_to_png as jr
    from renderformer_tpu_torch import render_h5_to_png as tr
    from renderformer_tpu_torch.io.h5 import load_scene_h5
    from renderformer_tpu_torch.scene.convert_scene import convert_scene
    h5 = str(tmp_path / 'cornell_box.h5')
    convert_scene(os.path.join(REPO, 'examples', 'cornell_box.json'), h5)
    data = load_scene_h5(h5)
    np.testing.assert_array_equal(tr.debug_render(data, 0, 48), jr.debug_render(data, 0, 48))
    tr.main([h5, '--resolution', '48'])
    assert 'triangles' in capsys.readouterr().out
    debug = _png(str(tmp_path / 'cornell_box_debug.png'))
    assert debug.shape == (48, 48, 3) and debug.max() > 0
    tr.main([h5, '--pathtrace', '--spp', '2', '--resolution', '16', '--cpu',
             '--output', str(tmp_path / 'pt.png')])
    pt = _png(str(tmp_path / 'pt.png'))
    assert pt.shape == (16, 16, 3) and pt.max() > 0


def test_pathtrace_default_device_refuses_missing_cuda(monkeypatch):
    """No fallback: without device='cpu' the path tracer wants CUDA."""
    import torch

    from renderformer_tpu_torch.scene.path_tracer import render_scene_pathtrace
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    scene = {'triangles': np.zeros((2, 3, 3), np.float32), 'vn': np.zeros((2, 3, 3), np.float32),
             'texture': np.zeros((2, 13, 32, 32), np.float32), 'mask': np.ones(2, bool),
             'c2w': np.eye(4, dtype=np.float32)[None], 'fov': np.full(1, 40.0, np.float32)}
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        render_scene_pathtrace(scene, resolution=4, spp=1)
