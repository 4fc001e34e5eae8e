"""The port's ``tools/overfit_run`` against the JAX tool's protocol at the
JAX convergence test's tiny config (4 scenes, 32^2, the teacher's
weights converted to the JAX tree): the teacher's ground truth against JAX's
``render_fn(impl='xla')`` in fp32, the student against the JAX tool's
perturbation, and the first epoch's step losses against the JAX
trainer's on the same dataset."""

import functools
import json
import os
import shutil
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_scene(d):
    """A scene JSON in ``d``: a cube of 12 triangles (the sample mesh) and
    the one-triangle light, one camera; returns its path."""
    from renderformer_tpu_torch.create_sample_meshes import create_cube_mesh
    from renderformer_tpu_torch.scene.mesh import save_obj
    os.makedirs(d, exist_ok=True)
    cube = create_cube_mesh()
    cube.compute_vertex_normals()
    save_obj(os.path.join(d, 'cube.obj'), cube)
    shutil.copy(os.path.join(REPO, 'examples', 'templates', 'lighting', 'tri.obj'),
                os.path.join(d, 'tri.obj'))

    def mat(diffuse, emissive):
        return {'diffuse': diffuse, 'specular': [0.01] * 3, 'roughness': 0.99,
                'emissive': emissive, 'smooth_shading': False}

    def xf(t, r, s):
        return {'translation': t, 'rotation': r, 'scale': [s] * 3, 'normalize': False}

    scene = {'scene_name': 'tiny', 'version': '1.0', 'objects': {
        'cube': {'mesh_path': 'cube.obj', 'material': mat([0.6, 0.3, 0.2], [0.0] * 3),
                 'transform': xf([0, 0, 0], [0, 0, 30], 0.4)},
        'light': {'mesh_path': 'tri.obj', 'material': mat([1.0] * 3, [5.0] * 3),
                  'transform': xf([0, 0, 1.0], [0, 0, 0], 0.5)}},
        'cameras': [{'position': [0, -2.0, 0.8], 'look_at': [0, 0, 0], 'up': [0, 0, 1],
                     'fov': 40}]}
    path = os.path.join(d, 'tiny.json')
    with open(path, 'w') as f:
        json.dump(scene, f, indent=2)
    return path


def compiled(fn, *args):
    """``fn`` jitted and compiled for ``args`` with XLA's CPU backend
    optimisation off: the JAX side's compile is most of this file's time,
    and the bars below hold the results all the same."""
    import jax
    return jax.jit(fn).lower(*args).compile(
        {'xla_backend_optimization_level': 0, 'xla_llvm_disable_expensive_passes': True})


def _leaves(tree):
    import jax
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def test_overfit_run_matches_the_jax_tool(tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp
    from renderformer_tpu.config import RenderFormerConfig as JaxConfig
    from renderformer_tpu.models.renderformer import RenderFormer as JaxModel
    from renderformer_tpu.pipelines.rendering_pipeline import render_fn
    from renderformer_tpu.training.dataset import RenderFormerDataset, expand_texture_flat
    from renderformer_tpu.training.state import (
        TrainConfig, TrainState, make_optimizer, make_train_step)
    from renderformer_tpu_torch.convert import state_dict_to_jax_params
    from renderformer_tpu_torch.tools import make_video_frames, overfit_run

    res, n = 32, 4
    # no TensorBoard, as on the card's machine: the trainer's null writer
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    scene = tiny_scene(str(tmp_path / 'scene'))
    model = JaxModel(JaxConfig(**overfit_run.TINY))
    # the tool's teacher, the port's seeded init, in the JAX tree
    teacher = overfit_run.seeded_model(overfit_run.model_config('tiny')).state_dict()
    w_teacher = jax.tree.map(jnp.asarray, state_dict_to_jax_params(teacher))
    args = overfit_run.build_parser().parse_args(
        ['--preset', 'tiny', '--res', str(res), '--scenes', str(n), '--epochs', '1',
         '--precision', 'float32', '--cpu', '--workdir', str(tmp_path / 'port'), '--scene', scene])
    # both trainers with an fp32 view stage, so that the step losses agree
    # to fp32 arithmetic (the tool's bf16 view stage under fp32 would round
    # differently in the two packages)
    from renderformer_tpu_torch.training import state as port_state
    monkeypatch.setattr(port_state, 'TrainConfig', functools.partial(
        port_state.TrainConfig, view_precision='float32'))
    got = overfit_run.run(args, log=lambda *a: None)
    data_dir = str(tmp_path / 'port' / 'data')
    assert sorted(os.listdir(data_dir)) == [f'frame_{i:04d}.png' for i in range(n)]
    # the same frames as H5 files beside the teacher's PNGs, for the JAX dataset
    make_video_frames.write_frames(make_video_frames.orbit_frames(scene, n, 360.0), data_dir)

    # the teacher's ground truth: JAX's fp32 XLA render of the same items
    ds0 = RenderFormerDataset(h5_dir=data_dir, gt_dir=str(tmp_path / 'no_gt'),
                              max_resolution=res)
    render = functools.partial(render_fn, model=model, resolution=res,
                               dtype=jnp.float32, view_dtype=jnp.float32, impl='xla')
    for i in range(n):
        item = ds0[i]
        if 'texture_flat' in item:
            item['texture'] = expand_texture_flat(item.pop('texture_flat'))
        inputs = [w_teacher] + [jnp.asarray(item[k])[None] for k in (
            'triangles', 'texture', 'mask', 'vn', 'c2w', 'fov')]
        if i == 0:  # the frames' shapes are the same: one compile
            render = compiled(render, *inputs)
        want = np.asarray(render(*inputs))[0, 0]
        err = np.abs(got['teacher_images'][i] - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (i, err, np.abs(want).max())

    # the student: the JAX tool's perturbation of the same teacher (its fp32
    # add in numpy, the same IEEE sum without an eager XLA compile a shape)
    noise_rng = np.random.default_rng(7)

    def perturb(p):
        p = np.asarray(p)
        scale = 0.1 * float(np.std(p) + 1e-3)
        return p + (noise_rng.normal(size=p.shape) * scale).astype(p.dtype)

    w_student = jax.tree.map(perturb, w_teacher)
    mine = state_dict_to_jax_params(got['student'])
    assert jax.tree.structure(mine) == jax.tree.structure(
        jax.tree.map(np.asarray, w_student))
    for a, b in zip(_leaves(mine), _leaves(w_student)):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()

    # the first epoch's step losses: the JAX train step on the JAX
    # dataset's batches of the same files (the ground truth PNGs that the
    # port's teacher wrote), in the JAX trainer's split and shuffle
    jtc = TrainConfig(num_epochs=1, steps_per_epoch=n // 2, precision='float32',
                      view_precision='float32', resolution=res, learning_rate=3e-5,
                      warmup_steps=0)
    tx = make_optimizer(jtc)
    state = jax.jit(lambda p: TrainState.create(p, tx))(w_student)
    step = make_train_step(model, tx, jtc, impl='xla')[0]
    ds = RenderFormerDataset(h5_dir=data_dir, gt_dir=data_dir, max_resolution=res)
    train_idx, _ = ds.split(1.0, 42)
    steps = []
    for i, batch in enumerate(ds.batches(train_idx, 2, shuffle=True, seed=42)):
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        if i == 0:
            step = compiled(step, state, batch)
        state, m = step(state, batch)
        steps.append(float(m['loss']))
    assert len(steps) == len(got['step_losses']) == n // 2
    np.testing.assert_allclose(got['step_losses'], steps, rtol=1e-4)
    assert got['out']['losses'] == got['trainer'].train_losses
    assert got['out']['scenes'] == n and got['out']['batch_size'] == 2


def test_in_memory_frames_are_the_h5_items(tmp_path):
    """The tool keeps the frames in memory (``InMemoryDataset``): every
    item is the H5 dataset's, bit for bit."""
    from renderformer_tpu_torch.io.image import write_png
    from renderformer_tpu_torch.tools import make_video_frames
    from renderformer_tpu_torch.training.dataset import InMemoryDataset, RenderFormerDataset
    frames = make_video_frames.orbit_frames(tiny_scene(str(tmp_path / 'scene')), 3)
    d = str(tmp_path / 'data')
    make_video_frames.write_frames(frames, d)
    rng = np.random.default_rng(0)
    for i in range(3):
        write_png(os.path.join(d, f'frame_{i:04d}.png'),
                  rng.integers(0, 256, (48, 48, 3), dtype=np.uint8))
    h5 = RenderFormerDataset(d, d, max_resolution=32)
    mem = InMemoryDataset({make_video_frames.frame_name(i): f for i, f in enumerate(frames)},
                          d, max_resolution=32)
    assert mem.h5_files == h5.h5_files and mem.padding_length == h5.padding_length == 128
    assert mem.texture_patch_size == h5.texture_patch_size == 32
    for i in range(3):
        a, b = mem[i], h5[i]
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
