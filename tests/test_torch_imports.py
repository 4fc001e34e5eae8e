"""The port package stands alone: it imports neither JAX nor any module of
renderformer_tpu, and its entry points refuse a CUDA device that is absent
instead of carrying on on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r'''
import importlib, pkgutil, sys
# the packages the card's machine lacks cannot be imported here either
class _Absent:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('h5py', 'yaml', 'imageio', 'tensorboard', 'bpy',
                                  'blenderproc'):
            raise ImportError(f'{name} made unimportable')
        return None
sys.meta_path.insert(0, _Absent())
import renderformer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith('jax.') or m.startswith('jaxlib')
             or m == 'renderformer_tpu' or m.startswith('renderformer_tpu.'))
# the packages the card's machine lacks: imported only where they are called
absent = sorted(m for m in sys.modules
                if m.split('.')[0] in ('h5py', 'safetensors', 'cv2', 'imageio', 'yaml',
                                       'tensorboard', 'bpy', 'blenderproc', 'PIL'))
print(len(names), bad, absent)
assert not bad, bad
assert not absent, absent
for n in ('nn.swin', 'ops.swin_attention', 'ops.shifted_regroup', 'ops.s2d_conv',
          'ops.dpt_tail', 'ops.fused_resize', 'ops.flash_attention', 'ops.fused_norm',
          'training.state',
          'training.checkpoint', 'training.trainer', 'io.safetensors', 'io.image',
          'io.h5', 'io.hdf5', 'utils.yaml_config', 'utils.tone_map', 'utils.prefetch',
          'utils.profiling', 'infer',
          'batch_infer', 'training.dataset', 'train', 'utils.look_at', 'scene.scene_config',
          'scene.mesh', 'scene.remesh', 'scene.scene_mesh', 'scene.to_h5', 'scene.h5_tools',
          'scene.convert_scene', 'scene.path_tracer', 'scene.render_scene',
          'scene.blender_render', 'render_h5_to_png', 'generate_dataset', 'convert',
          'parallel.distributed', 'parallel.sharding', 'parallel.ring_attention',
          'create_sample_meshes', 'create_scene_configs', 'create_examples',
          'tools.make_video_frames', 'tools.compare_renders', 'tools.verify_checkpoint',
          'tools.overfit_run', 'tools.precision_study', 'tools.gt_noise_sweep',
          'tools.tone_map_fidelity'):
    assert 'renderformer_tpu_torch.' + n in names, n
'''


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['PYTHONPATH'] = REPO
    res = subprocess.run([sys.executable, '-c', _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 20, res.stdout


def test_no_source_imports_h5py_or_yaml():
    """The port reads and writes HDF5 with io/hdf5 and reads YAML with
    utils/yaml_config: no source file of the package, and not chip_smoke.py,
    imports h5py or PyYAML, not even inside a function."""
    import re
    pattern = re.compile(r'^\s*(import|from) (h5py|yaml)\b', re.M)
    pkg = os.path.join(REPO, 'renderformer_tpu_torch')
    files = [os.path.join(root, f) for root, _, names in os.walk(pkg) for f in names
             if f.endswith('.py')] + [os.path.join(REPO, 'chip_smoke.py')]
    assert len(files) > 50
    bad = []
    for path in files:
        with open(path, encoding='utf-8') as f:
            bad += [f'{os.path.relpath(path, REPO)}: {m.group(0).strip()}'
                    for m in pattern.finditer(f.read())]
    assert not bad, bad


_HELP = r'''
import importlib, sys
cli = importlib.import_module('renderformer_tpu_torch.{cli}')
try:
    cli.main(['--help'])
except SystemExit as e:
    assert e.code == 0, e.code
else:
    raise AssertionError('--help did not exit')
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'renderformer_tpu', 'h5py', 'cv2',
                                    'imageio', 'bpy', 'blenderproc'))
assert not bad, bad
'''

# the flags each command line's help must show
CLI_FLAGS = {
    'infer': ['--model_id', '--cpu', '--attn_impl', '--shard'],
    'batch_infer': ['--model_id', '--cpu', '--attn_impl', '--shard'],
    'convert': ['input_dir', 'output_dir'],
    'generate_dataset': ['--gt_mode', '--gt_spp', '--seed', '--cpu'],
    'render_h5_to_png': ['--pathtrace', '--spp', '--cpu'],
    'scene.convert_scene': ['json_file', 'output_h5'],
    'create_sample_meshes': ['--help'],
    'create_scene_configs': ['--help'],
    'create_examples': ['--help'],
    'tools.make_video_frames': ['--scene', '--out', '--frames', '--arc'],
    'tools.compare_renders': ['--peak'],
    'tools.verify_checkpoint': ['--checkpoint', '--golden_exr', '--torch_compare',
                                '--reference_root', '--cpu'],
    'tools.overfit_run': ['--preset', '--workdir', '--artifacts', '--cpu'],
    'tools.precision_study': ['--preset', '--h5', '--pad', '--cpu'],
    'tools.gt_noise_sweep': ['--h5_dir', '--spps', '--clamp', '--out', '--cpu'],
    'tools.tone_map_fidelity': ['--out', '--golden'],
}


@pytest.mark.parametrize('cli', list(CLI_FLAGS))
def test_cli_help_exits_0_without_jax(cli):
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['PYTHONPATH'] = REPO
    res = subprocess.run([sys.executable, '-c', _HELP.format(cli=cli)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert all(flag in res.stdout for flag in CLI_FLAGS[cli]), res.stdout


def test_default_device_refuses_missing_cuda(monkeypatch):
    from renderformer_tpu_torch import RenderFormerConfig, RenderingPipeline
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfg = RenderFormerConfig(latent_dim=72, num_layers=1, num_heads=2,
                             view_transformer_latent_dim=72,
                             view_transformer_n_heads=2,
                             view_transformer_n_layers=4)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        RenderingPipeline.from_config(cfg)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        RenderingPipeline.from_pretrained('v1-base', device='cuda')


def test_trainer_refuses_missing_cuda(monkeypatch):
    from renderformer_tpu_torch import RenderFormerConfig
    from renderformer_tpu_torch.models.renderformer import RenderFormer
    from renderformer_tpu_torch.training.trainer import RenderFormerTrainer, TrainerConfig
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfg = RenderFormerConfig(latent_dim=72, num_layers=1, num_heads=2,
                             vertex_pe_num_freqs=4, view_transformer_latent_dim=72,
                             view_transformer_n_heads=2,
                             view_transformer_n_layers=4)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        RenderFormerTrainer(RenderFormer(cfg), TrainerConfig(), steps_per_epoch=1)


def test_unported_configurations_raise():
    """pe_type='learned' still raises; the NeRF-encoded ray map and the
    linear head, once refused, build."""
    from renderformer_tpu_torch import RenderFormerConfig
    from renderformer_tpu_torch.models.renderformer import RenderFormer
    with pytest.raises(NotImplementedError):
        RenderFormer(RenderFormerConfig(pe_type='learned'))
    small = dict(latent_dim=72, num_layers=1, num_heads=2, vertex_pe_num_freqs=4,
                 view_transformer_latent_dim=72,
                 view_transformer_n_heads=2, view_transformer_n_layers=4)
    vdir = RenderFormer(RenderFormerConfig(**small, vdir_num_freqs=2))
    assert vdir.view_transformer.ray_map_encoder.in_features == (3 + 3 * 2 * 2) * 8 * 8
    linear = RenderFormer(RenderFormerConfig(**small, use_dpt_decoder=False))
    assert not hasattr(linear.view_transformer, 'out_dpt')
    assert linear.view_transformer.out_proj.out_features == 8 * 8 * 3


@pytest.mark.cuda
def test_kernels_match_plain_on_cuda():
    """On a card: each kernel against its plain version at small shapes."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from renderformer_tpu_torch.encodings.rope import make_cos_sin
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.ops.flash_attention import flash_attention_rope
    from renderformer_tpu_torch.ops.fused_resize import resize_bilinear
    rng = np.random.default_rng(0)
    dev = 'cuda'
    b, bkv, sq, sk, h, d = 4, 2, 100, 70, 2, 128
    q = torch.tensor(rng.normal(size=(b, sq, h, d)), dtype=torch.float32, device=dev)
    k = torch.tensor(rng.normal(size=(bkv, sk, h, d)), dtype=torch.float32, device=dev)
    v = torch.tensor(rng.normal(size=(bkv, sk, h, d)), dtype=torch.float32, device=dev)
    mask = torch.tensor(rng.uniform(size=(b, sk)) > 0.3, device=dev)
    cq, sq_ = make_cos_sin(torch.tensor(rng.normal(size=(b, sq, 9)), dtype=torch.float32,
                                        device=dev), 12, d)
    ck, sk_ = make_cos_sin(torch.tensor(rng.normal(size=(b, sk, 9)), dtype=torch.float32,
                                        device=dev), 12, d)
    tabs = [t[:, :, 0].contiguous() for t in (cq, sq_, ck, sk_)]
    x = torch.tensor(rng.normal(size=(2, 16, 16, 64)), dtype=torch.float32, device=dev)
    with torch.no_grad():
        got = flash_attention_rope(q, k, v, mask, *tabs)
        got_r = resize_bilinear(x, (32, 32))
        with reference_kernels():
            want = flash_attention_rope(q, k, v, mask, *tabs)
            want_r = resize_bilinear(x, (32, 32))
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)  # fp32 summation order
    torch.testing.assert_close(got_r, want_r, atol=1e-6, rtol=0)  # same fp32 ops
