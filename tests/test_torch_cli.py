"""The port's command lines on the CPU against the JAX package's: ``infer``
and ``batch_infer`` on a JAX-exported tiny checkpoint and synthetic H5
scenes (the fixtures of tests/test_infer_cli.py and
tests/test_batch_infer_cli.py)."""

import os
import sys

import h5py
import jax
import numpy as np
import pytest
import torch

from renderformer_tpu.config import RenderFormerConfig as JaxConfig
from renderformer_tpu.models.renderformer import RenderFormer as JaxRenderFormer
from renderformer_tpu.training.checkpoint import export_params
from renderformer_tpu_torch import batch_infer, infer
from renderformer_tpu_torch.io.image import read_exr

TINY = dict(latent_dim=72, num_layers=2, num_heads=2, dim_feedforward=144,
            num_register_tokens=4, vertex_pe_num_freqs=4,
            view_transformer_latent_dim=72, view_transformer_ffn_hidden_dim=144,
            view_transformer_n_heads=2, view_transformer_n_layers=4,
            dpt_features=16, dpt_out_channels=[8, 16, 32, 64])


@pytest.fixture(scope='module')
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('ckpt'))
    cfg = JaxConfig(**TINY)
    export_params(path, JaxRenderFormer(cfg).init(jax.random.key(0)), cfg)
    return path


def _write_scene(path, n_tris, n_views, seed, c2w=None):
    rng = np.random.default_rng(seed)
    with h5py.File(path, 'w') as f:
        f['triangles'] = rng.normal(size=(n_tris, 3, 3)).astype(np.float32) * 0.3
        tex = rng.uniform(0, 1, (n_tris, 13, 32, 32)).astype(np.float16)
        tex[:2, 10:] *= 8  # emitters
        f['texture'] = tex
        f['vn'] = rng.normal(size=(n_tris, 3, 3)).astype(np.float32)
        if c2w is None:
            c2w = np.tile(np.eye(4, dtype=np.float32), (n_views, 1, 1))
            c2w[:, 2, 3] = np.linspace(1.5, 2.5, n_views)
        f['c2w'] = c2w
        f['fov'] = np.full((n_views,), 40.0, np.float32)


def _read(out_dir, ext):
    names = sorted(f for f in os.listdir(out_dir) if f.endswith(ext))
    if ext == '.exr':
        return names, [read_exr(os.path.join(out_dir, n)) for n in names]
    import cv2
    return names, [cv2.imread(os.path.join(out_dir, n))[:, :, ::-1] for n in names]


def _jax_main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, 'argv', argv)
    return __import__(module).main()


def test_infer_matches_jax_infer(tmp_path, ckpt, monkeypatch):
    h5_file = str(tmp_path / 'scene.h5')
    _write_scene(h5_file, n_tris=12, n_views=2, seed=0)
    port_out, jax_out = str(tmp_path / 'port'), str(tmp_path / 'jax')
    common = ['--h5_file', h5_file, '--model_id', ckpt, '--precision', 'fp32',
              '--resolution', '32', '--tone_mapper', 'agx']
    assert infer.main(common + ['--output_dir', port_out, '--cpu']) == 0
    assert not _jax_main('infer', ['infer.py'] + common + ['--output_dir', jax_out,
                                                          '--attn_impl', 'xla'], monkeypatch)
    for ext in ('.exr', '.png'):
        (pn, got), (jn, want) = _read(port_out, ext), _read(jax_out, ext)
        assert pn == jn == [f'scene_view_{i}{ext}' for i in range(2)]
        for g, w in zip(got, want):
            assert g.shape == w.shape == (32, 32, 3)
            if ext == '.exr':
                assert np.isfinite(g).all() and float(np.abs(g - w).max()) <= 1e-4
            else:
                assert int(np.abs(g.astype(int) - w.astype(int)).max()) <= 1


def test_infer_writes_beside_the_scene_by_default(tmp_path, ckpt):
    h5_file = str(tmp_path / 'cbox.h5')
    _write_scene(h5_file, n_tris=6, n_views=1, seed=1)
    assert infer.main(['--h5_file', h5_file, '--model_id', ckpt, '--precision', 'fp32',
                       '--resolution', '16', '--cpu']) == 0
    assert sorted(f for f in os.listdir(tmp_path) if not f.endswith('.h5')) == [
        'cbox_view_0.exr', 'cbox_view_0.png']


def test_infer_refuses_cuda_without_a_card(tmp_path, ckpt, monkeypatch):
    h5_file = str(tmp_path / 'scene.h5')
    _write_scene(h5_file, n_tris=6, n_views=1, seed=1)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        infer.main(['--h5_file', h5_file, '--model_id', ckpt])


def _frames(h5_dir, n_frames, static):
    h5_dir.mkdir()
    for i in range(n_frames):
        c2w = np.eye(4, dtype=np.float32)[None].copy()
        c2w[0, 0, 3] = 0.05 * i
        c2w[0, 2, 3] = 2.0
        _write_scene(str(h5_dir / f'frame_{i:03d}.h5'), n_tris=8 if static else 8 + i,
                     n_views=1, seed=0 if static else i, c2w=c2w)
    return str(h5_dir)


def test_batch_infer_video_path_matches_per_batch_path_and_jax(tmp_path, ckpt, monkeypatch):
    """As tests/test_batch_infer_cli.py::test_batch_infer_video_mode_matches_generic:
    one scene, a camera a frame; 3 frames in chunks of 2 views, so the video
    path renders one full chunk and a padded remainder."""
    h5_dir = _frames(tmp_path / 'frames', 3, static=True)
    common = ['--h5_folder', h5_dir, '--model_id', ckpt, '--precision', 'fp32',
              '--resolution', '32', '--batch_size', '2', '--padding_length', '8',
              '--transfer_dtype', 'float32', '--tone_mapper', 'pbr_neutral']
    outs = {}
    for mode in ('on', 'off'):
        out = str(tmp_path / f'port_{mode}')
        assert batch_infer.main(common + ['--output_dir', out, '--video_mode', mode,
                                          '--cpu']) == 0
        outs[mode] = out
        assert os.path.exists(os.path.join(out, 'video.mp4'))
    jax_out = str(tmp_path / 'jax')
    assert not _jax_main('batch_infer', ['batch_infer.py'] + common + [
        '--output_dir', jax_out, '--video_mode', 'off', '--attn_impl', 'xla'], monkeypatch)
    names, on = _read(outs['on'], '.exr')
    assert names == [f'frame_{i:03d}_view_0.exr' for i in range(3)]
    _, off = _read(outs['off'], '.exr')
    _, want = _read(jax_out, '.exr')
    for a, b, w in zip(on, off, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        assert float(np.abs(b - w).max()) <= 1e-4
    _, on_png = _read(outs['on'], '.png')
    _, want_png = _read(jax_out, '.png')
    for g, w in zip(on_png, want_png):
        assert int(np.abs(g.astype(int) - w.astype(int)).max()) <= 1


def test_batch_infer_pads_frames_of_different_sizes(tmp_path, ckpt, monkeypatch):
    h5_dir = _frames(tmp_path / 'frames', 3, static=False)
    out = str(tmp_path / 'out')
    assert batch_infer.main(['--h5_folder', h5_dir, '--model_id', ckpt, '--precision', 'fp32',
                             '--resolution', '32', '--batch_size', '2',
                             '--padding_length', '16', '--output_dir', out, '--cpu']) == 0
    names, imgs = _read(out, '.exr')
    assert len(names) == 3 and all(np.isfinite(i).all() for i in imgs)
    # float16 transfer: EXR-half values
    for img in imgs:
        np.testing.assert_array_equal(img, img.astype(np.float16).astype(np.float32))


@pytest.mark.parametrize('mode', ['on', 'off'])
def test_batch_infer_no_output_writes_nothing(tmp_path, ckpt, mode, capsys):
    h5_dir = _frames(tmp_path / 'frames', 4, static=True)
    out = str(tmp_path / 'out')
    assert batch_infer.main(['--h5_folder', h5_dir, '--model_id', ckpt, '--precision', 'fp32',
                             '--resolution', '16', '--batch_size', '1',
                             '--frames_per_call', '1', '--output_dir', out, '--no_output',
                             '--video_mode', mode, '--cpu']) == 0
    assert os.listdir(out) == []
    assert 'rays/s median' in capsys.readouterr().out


def test_batch_infer_without_cv2_fails_before_rendering(tmp_path, ckpt, monkeypatch):
    h5_dir = _frames(tmp_path / 'frames', 2, static=True)
    rendered = []
    from renderformer_tpu_torch.pipelines.rendering_pipeline import RenderingPipeline
    monkeypatch.setattr(RenderingPipeline, 'render_many',
                        lambda *a, **k: rendered.append(1))
    monkeypatch.setitem(sys.modules, 'cv2', None)
    with pytest.raises(ImportError, match='cv2'):
        batch_infer.main(['--h5_folder', h5_dir, '--model_id', ckpt, '--resolution', '16',
                          '--output_dir', str(tmp_path / 'out'), '--cpu'])
    assert rendered == []


def test_batch_infer_empty_folder_returns_1(tmp_path, ckpt):
    (tmp_path / 'empty').mkdir()
    assert batch_infer.main(['--h5_folder', str(tmp_path / 'empty'), '--model_id', ckpt,
                             '--cpu']) == 1


def test_loops_take_in_memory_dicts(tmp_path, ckpt):
    """What chip_smoke.py's phase 8 runs: both loops fed dicts, no H5."""
    from renderformer_tpu_torch import RenderingPipeline
    pipe = RenderingPipeline.from_pretrained(ckpt, device='cpu')
    rng = np.random.default_rng(0)
    n, v = 8, 2
    scene = {'triangles': rng.normal(size=(n, 3, 3)).astype(np.float32) * 0.3,
             'texture': rng.uniform(0, 1, (n, 13, 32, 32)).astype(np.float32),
             'mask': np.ones(n, bool), 'vn': rng.normal(size=(n, 3, 3)).astype(np.float32)}
    c2w = np.tile(np.eye(4, dtype=np.float32), (1, v, 1, 1))
    batches = [{**{k: x[None] for k, x in scene.items()}, 'c2w': c2w,
                'fov': np.full((1, v), 40.0, np.float32), 'file_paths': [f'f{i}.h5']}
               for i in range(3)]
    chunks = [{'c2w': c2w, 'fov': np.full((1, v), 40.0, np.float32),
               'entries': [(f'f{i}.h5', j) for j in range(v)], 'n_valid': v}
              for i in range(5)]
    args = batch_infer.build_parser().parse_args(
        ['--h5_folder', str(tmp_path), '--resolution', '16', '--no_output',
         '--frames_per_call', '2'])
    for run, items in ((batch_infer.run_batches, batches), (batch_infer.run_video, chunks)):
        out = batch_infer.Output(args, str(tmp_path / 'out'))
        meter = (run(pipe, items, out, args) if run is batch_infer.run_batches
                 else run(pipe, scene, items, out, args))
        assert out.close() == []
        assert len(meter._times) == 3
    assert not os.path.exists(str(tmp_path / 'out'))


def test_convert_clis_load_to_the_same_parameters(tmp_path, monkeypatch, capsys):
    """A seeded HF directory (the reference layout) through the port's and
    the JAX package's ``convert``: each package's ``from_pretrained`` loads
    either output to the HF directory's parameters."""
    from renderformer_tpu.pipelines.rendering_pipeline import RenderingPipeline as JaxPipeline
    from renderformer_tpu_torch import RenderFormerConfig, RenderingPipeline
    from renderformer_tpu_torch import convert
    from renderformer_tpu_torch.io import safetensors as port_st
    from renderformer_tpu_torch.models.renderformer import RenderFormer
    from renderformer_tpu_torch.nn.core import init_weights
    cfg = RenderFormerConfig(**TINY)
    model = init_weights(RenderFormer(cfg), torch.Generator().manual_seed(5))
    hf = str(tmp_path / 'hf')
    os.makedirs(hf)
    cfg.save_json(os.path.join(hf, 'config.json'))
    port_st.save_file(model.state_dict(), os.path.join(hf, 'model.safetensors'))

    outs = {'port': str(tmp_path / 'port'), 'jax': str(tmp_path / 'jax')}
    assert convert.main([hf, outs['port']]) == 0
    port_line = capsys.readouterr().out
    monkeypatch.setattr(sys, 'argv', ['convert', hf, outs['jax']])
    from renderformer_tpu.convert.__main__ import main as jax_convert
    assert jax_convert() == 0
    jax_line = capsys.readouterr().out
    assert port_line.replace(outs['port'], '') == jax_line.replace(outs['jax'], '')
    want = model.state_dict()
    want_tree = jax.tree.map(np.asarray, JaxPipeline.from_pretrained(hf).params)
    for out in outs.values():
        got = RenderingPipeline.from_pretrained(out, device='cpu').model.state_dict()
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k].float()), k
        tree = jax.tree.map(np.asarray, JaxPipeline.from_pretrained(out).params)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want_tree)):
            np.testing.assert_array_equal(a, b)
        assert jax.tree.structure(tree) == jax.tree.structure(want_tree)


@pytest.mark.parametrize('impl', ['flash', 'xla'])
def test_infer_attn_impl_on_the_cpu(tmp_path, ckpt, impl):
    """--attn_impl flash and xla both run on the CPU (the plain versions)
    and give the image of the default."""
    h5_file = str(tmp_path / 'scene.h5')
    _write_scene(h5_file, n_tris=6, n_views=1, seed=2)
    outs = {}
    for name, extra in (('auto', []), (impl, ['--attn_impl', impl])):
        out = str(tmp_path / name)
        assert infer.main(['--h5_file', h5_file, '--model_id', ckpt, '--precision', 'fp32',
                           '--resolution', '16', '--output_dir', out, '--cpu'] + extra) == 0
        outs[name] = _read(out, '.exr')[1][0]
    np.testing.assert_array_equal(outs[impl], outs['auto'])


def test_attn_impl_xla_refuses_the_card(tmp_path, ckpt, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    for main, what in ((infer.main, '--h5_file'), (batch_infer.main, '--h5_folder')):
        with pytest.raises(ValueError, match='no library attention path'):
            main([what, str(tmp_path), '--model_id', ckpt, '--attn_impl', 'xla'])


def test_shard_with_one_device_renders_as_without(tmp_path, ckpt, monkeypatch, capsys):
    for var in ('WORLD_SIZE', 'RANK', 'LOCAL_RANK'):
        monkeypatch.delenv(var, raising=False)
    h5_file = str(tmp_path / 'scene.h5')
    _write_scene(h5_file, n_tris=6, n_views=2, seed=3)
    imgs = {}
    for name, extra in (('plain', []), ('shard', ['--shard'])):
        out = str(tmp_path / name)
        assert infer.main(['--h5_file', h5_file, '--model_id', ckpt, '--precision', 'fp32',
                           '--resolution', '16', '--output_dir', out, '--cpu'] + extra) == 0
        imgs[name] = _read(out, '.exr')[1]
        log = capsys.readouterr().out
        assert log.count('NOTICE: --shard with one device') == (name == 'shard')
    for a, b in zip(imgs['shard'], imgs['plain']):
        np.testing.assert_array_equal(a, b)


def test_batch_infer_shard_takes_the_per_batch_path(tmp_path, ckpt, monkeypatch, capsys):
    for var in ('WORLD_SIZE', 'RANK', 'LOCAL_RANK'):
        monkeypatch.delenv(var, raising=False)
    h5_dir = _frames(tmp_path / 'frames', 2, static=True)
    common = ['--h5_folder', h5_dir, '--model_id', ckpt, '--resolution', '16', '--cpu',
              '--no_output', '--shard']
    with pytest.raises(SystemExit) as e:
        batch_infer.main(common + ['--video_mode', 'on'])
    assert e.value.code == 2
    capsys.readouterr()
    assert batch_infer.main(common + ['--output_dir', str(tmp_path / 'out')]) == 0
    log = capsys.readouterr().out
    assert 'NOTICE: --shard disables the static-scene video path' in log
    assert 'video mode: static scene detected' not in log


def test_trace_names_an_annotated_range(tmp_path, ckpt, monkeypatch):
    """A range of the caller's and the pipeline's own ranges land in the
    exported trace; ``annotate`` sets no NVTX range."""
    from renderformer_tpu_torch import RenderingPipeline
    from renderformer_tpu_torch.utils.profiling import annotate, trace

    def no_nvtx(*a, **kw):
        raise AssertionError('annotate called NVTX')

    monkeypatch.setattr(torch.cuda.nvtx, 'range_push', no_nvtx)
    monkeypatch.setattr(torch.cuda.nvtx, 'range_pop', no_nvtx)
    pipe = RenderingPipeline.from_pretrained(ckpt, device='cpu')
    rng = np.random.default_rng(0)
    n = 6
    with trace(str(tmp_path / 'trace')):
        with annotate('rf_traced_render'):
            pipe.render(rng.normal(size=(1, n, 3, 3)).astype(np.float32) * 0.3,
                        rng.uniform(0, 1, (1, n, 13, 32, 32)).astype(np.float32),
                        np.ones((1, n), bool), rng.normal(size=(1, n, 3, 3)).astype(np.float32),
                        np.eye(4, dtype=np.float32)[None, None], np.full((1, 1, 1), 40.0,
                                                                         np.float32),
                        resolution=16, precision='fp32')
    files = os.listdir(str(tmp_path / 'trace'))
    assert len(files) == 1 and files[0].endswith('.pt.trace.json')
    with open(os.path.join(str(tmp_path / 'trace'), files[0])) as f:
        text = f.read()
    assert 'rf_traced_render' in text and 'aten::' in text
    assert all(f'"{name}"' in text for name in ('rf.render', 'rf.render.upload',
                                                'rf.model.encoder', 'rf.model.view',
                                                'rf.model.dpt'))
