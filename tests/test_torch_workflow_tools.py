"""The port's workflow tools against the JAX package's on the CPU:
``verify_checkpoint`` (its step lines and exit code), ``precision_study``
(each of its three renders), ``compare_renders`` and
``tone_map_fidelity`` (their numbers and text), and ``gt_noise_sweep``
(its markdown and section replacement on fixed renders, and the PSNR
rising with spp through the port's path tracer)."""

import functools
import importlib.util
import io
import json
import os
import re
import shutil
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from renderformer_tpu_torch.tools.overfit_run import TINY
from tests.test_torch_overfit import compiled, tiny_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM = re.compile(r'[-+]?\d+\.?\d*(?:e[-+]?\d+)?|inf')


def jax_tool(name, path=None):
    """The JAX package's ``tools/<name>.py`` (or a copy at ``path``) as a
    module."""
    spec = importlib.util.spec_from_file_location(
        f'jax_tool_{name}', path or os.path.join(REPO, 'tools', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_main(main, argv=None, sys_argv=None, monkeypatch=None):
    """(return value, stdout lines) of main(argv), or of main() with
    sys.argv set (the JAX tools that read it)."""
    buf = io.StringIO()
    if sys_argv is not None:
        monkeypatch.setattr(sys, 'argv', ['tool'] + sys_argv)
    with redirect_stdout(buf):
        rc = main(argv) if sys_argv is None else main()
    return rc, buf.getvalue().splitlines()


@pytest.fixture(scope='module')
def tiny_dir(tmp_path_factory):
    """An export_params directory of the port's seeded tiny model."""
    from renderformer_tpu_torch import RenderFormerConfig, RenderingPipeline, export_params
    d = str(tmp_path_factory.mktemp('tiny_ckpt'))
    pipe = RenderingPipeline.from_config(RenderFormerConfig(**TINY), seed=0, device='cpu')
    export_params(d, pipe.model, pipe.config)
    return d


def test_verify_checkpoint_matches_the_jax_tool(tiny_dir, tmp_path, monkeypatch):
    from renderformer_tpu_torch.tools import verify_checkpoint as port
    golden = str(tmp_path / 'golden.exr')
    common = ['--checkpoint', tiny_dir, '--resolution', '32', '--cpu']
    # the JAX tool writes its render as the golden image and reads it back
    rc_j, lines_j = run_main(jax_tool('verify_checkpoint').main, monkeypatch=monkeypatch,
                             sys_argv=common + ['--save_exr', golden, '--golden_exr', golden])
    rc_p, lines_p = run_main(port.main, common + ['--golden_exr', golden])
    assert rc_j == rc_p == 0
    assert lines_p[-1] == lines_j[-1] == 'checkpoint verified OK'

    def step(lines, k):
        return [ln for ln in lines if ln.startswith(f'[{k}/4]')][0]

    # [1/4]: the load, the config and the parameter count, the same text
    i_j, i_p = lines_j.index(step(lines_j, 1)), lines_p.index(step(lines_p, 1))
    assert lines_p[i_p + 1:i_p + 3] == lines_j[i_j + 1:i_j + 3]
    assert 'params:' in lines_p[i_p + 2]
    # [2/4]: the same text, the range within rounding of two fp32 renders
    s_j, s_p = step(lines_j, 2), step(lines_p, 2)
    assert NUM.sub('#', s_p) == NUM.sub('#', s_j)
    np.testing.assert_allclose([float(x) for x in NUM.findall(s_p)],
                               [float(x) for x in NUM.findall(s_j)], atol=2e-4)
    assert step(lines_p, 3) == step(lines_j, 3)
    # [4/4]: the same verdict; the JAX tool reads its own image back
    s_j, s_p = step(lines_j, 4), step(lines_p, 4)
    assert NUM.sub('#', s_p) == NUM.sub('#', s_j)
    assert '(OK at' in s_p and float(s_p.split('PSNR: ')[1].split(' dB')[0]) > 80

    # the count is the JAX param_count of the same directory
    from renderformer_tpu.nn.core import param_count
    from renderformer_tpu.pipelines.rendering_pipeline import RenderingPipeline
    from renderformer_tpu_torch import RenderingPipeline as PortPipeline
    want = param_count(RenderingPipeline.from_pretrained(tiny_dir).params)
    assert port.param_count(PortPipeline.from_pretrained(tiny_dir, device='cpu').model) == want

    # a failing gate: a golden image of another render exits 1 at step 4
    from renderformer_tpu_torch.io.image import read_exr, write_exr
    write_exr(str(tmp_path / 'other.exr'), read_exr(golden)[::-1].copy() + 1.0)
    rc, lines = run_main(port.main, common + ['--golden_exr', str(tmp_path / 'other.exr')])
    assert rc == 1 and 'FAIL at the >30dB bf16 gate' in lines[-1]
    # step 3 without the upstream package fails, as the JAX tool's import does
    with pytest.raises(ImportError):
        run_main(port.main, common + ['--torch_compare', '--reference_root',
                                      str(tmp_path / 'absent')])


def test_verify_checkpoint_step3_port_side_matches_the_jax_tool(tiny_dir):
    """Step 3 without the upstream package: the port's half of it (the
    inputs, the ray patch layout, the output transpose) against the JAX
    tool's raw model call on the same directory and inputs, fp32."""
    import jax.numpy as jnp
    from renderformer_tpu.pipelines.rendering_pipeline import RenderingPipeline as JaxPipeline
    from renderformer_tpu_torch import RenderingPipeline
    from renderformer_tpu_torch.tools import verify_checkpoint as port
    pipe_j = JaxPipeline.from_pretrained(tiny_dir)
    pipe = RenderingPipeline.from_pretrained(tiny_dir, device='cpu')
    assert pipe.config.vdir_num_freqs == 0  # the patched-ray branch
    inputs = port.parity_inputs(32)
    assert inputs[5].shape == (1, 1, 32, 32, 3)
    # the JAX tool's call, compiled whole (one compile, not one an op)
    raw = compiled(functools.partial(pipe_j.model, dtype=jnp.float32, view_dtype=jnp.float32),
                   pipe_j.params, *inputs)
    want = np.transpose(np.asarray(raw(pipe_j.params, *inputs)), (0, 1, 4, 2, 3))
    got = port.port_output(pipe, inputs)
    assert got.shape == want.shape == (1, 1, 3, 32, 32)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert port.psnr(got, want) >= 60  # the step's gate


def test_precision_study_renders_match_the_jax_tool(tiny_dir, tmp_path, monkeypatch):
    from renderformer_tpu.pipelines.rendering_pipeline import RenderingPipeline as JaxPipeline
    from renderformer_tpu_torch.pipelines.rendering_pipeline import RenderingPipeline
    from renderformer_tpu_torch.tools import make_video_frames, precision_study as port
    frames = str(tmp_path / 'frames')
    make_video_frames.main(['--scene', tiny_scene(str(tmp_path / 'scene')), '--out', frames,
                            '--frames', '1'])
    h5 = os.path.join(frames, 'frame_0000.h5')
    args = ['--preset', tiny_dir, '--h5', h5, '--res', '32', '--pad', '128']

    def recording(cls, out):
        real = cls.render

        def render(self, *a, **kw):
            img = real(self, *a, **kw)
            out[(kw['precision'], kw['view_precision'])] = np.asarray(
                img.float().cpu() if torch.is_tensor(img) else img)[0, 0]
            return img
        return render

    want, got = {}, {}
    monkeypatch.setattr(JaxPipeline, 'render', recording(JaxPipeline, want))
    monkeypatch.setattr(RenderingPipeline, 'render', recording(RenderingPipeline, got))
    _, lines_j = run_main(jax_tool('precision_study').main, args)
    _, lines_p = run_main(port.main, args + ['--cpu'])
    rep_j, rep_p = json.loads('\n'.join(lines_j)), json.loads('\n'.join(lines_p))
    assert rep_p.keys() == rep_j.keys()
    assert rep_p['psnr_hdr'].keys() == rep_j['psnr_hdr'].keys()
    assert rep_p['psnr_ldr_pbr_neutral'].keys() == rep_j['psnr_ldr_pbr_neutral'].keys()
    assert rep_p['n_tris'] == rep_j['n_tris'] == 13 and rep_p['resolution'] == 32
    assert sorted(got) == sorted(want) == sorted(port.PRECISIONS.values())
    for key, bar in ((('fp32', 'fp32'), 55), (('bf16', 'fp32'), 40), (('bf16', 'bf16'), 40)):
        assert got[key].shape == want[key].shape == (32, 32, 3)
        assert port.psnr(got[key], want[key]) >= bar, key
    assert all(np.isfinite(v) for d in ('psnr_hdr', 'psnr_ldr_pbr_neutral')
               for v in rep_p[d].values())


def test_compare_renders_matches_the_jax_tool(tmp_path, monkeypatch):
    from renderformer_tpu_torch.io.image import write_exr, write_png
    from renderformer_tpu_torch.tools import compare_renders as port
    jax_main = jax_tool('compare_renders').main
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 3, (16, 16, 3)).astype(np.float32)
    b = (a + rng.normal(0, 0.01, a.shape)).astype(np.float32)
    write_exr(str(tmp_path / 'a.exr'), a)
    write_exr(str(tmp_path / 'b.exr'), b)
    write_png(str(tmp_path / 'a.png'), rng.integers(0, 256, (16, 16, 3), dtype=np.uint8))
    write_png(str(tmp_path / 'b.png'), rng.integers(0, 256, (16, 16, 3), dtype=np.uint8))
    write_exr(str(tmp_path / 'c.exr'), a[:8])
    cases = [['a.exr', 'b.exr'], ['a.exr', 'a.exr'], ['a.exr', 'b.exr', '--peak', '1.0'],
             ['a.png', 'b.png'], ['a.exr', 'c.exr']]
    for case in cases:
        argv = [str(tmp_path / c) if c.endswith(('exr', 'png')) else c for c in case]
        rc_j, lines_j = run_main(jax_main, sys_argv=argv, monkeypatch=monkeypatch)
        rc_p, lines_p = run_main(port.main, argv)
        assert (rc_p, lines_p) == (rc_j, lines_j), case
    assert 'PSNR: inf dB' in run_main(port.main, [str(tmp_path / 'a.exr')] * 2)[1][0]


def test_tone_map_fidelity_matches_the_jax_tool(tmp_path):
    from renderformer_tpu_torch.tools import tone_map_fidelity as port
    # a copy of the JAX tool, so that it writes under tmp_path, not the repo
    root = tmp_path / 'jax'
    os.makedirs(root / 'tools')
    os.makedirs(root / 'docs')
    os.makedirs(root / 'tests' / 'data')
    golden = os.path.join(REPO, 'tests', 'data', 'golden_e2e_v1base.npz')
    os.symlink(golden, root / 'tests' / 'data' / 'golden_e2e_v1base.npz')
    shutil.copy(os.path.join(REPO, 'tools', 'tone_map_fidelity.py'), root / 'tools')
    _, printed_j = run_main(lambda _: jax_tool('tone_map_fidelity',
                                               str(root / 'tools' / 'tone_map_fidelity.py'))
                            .main())
    out = tmp_path / 'port.md'
    _, printed_p = run_main(port.main, ['--out', str(out), '--golden', golden])
    want = (root / 'docs' / 'tone_mapping.md').read_text().split('\n')
    got = out.read_text().split('\n')
    assert len(got) == len(want) and len(got) > 30
    # the lines that name the tool and the reference implementation differ
    named = {2, 5}
    assert [ln for i, ln in enumerate(got) if i not in named] == \
        [ln for i, ln in enumerate(want) if i not in named]
    assert 'tone_map_fidelity' in got[2] and 'infer.py:57-62' in got[5]
    assert sum('real render' in ln for ln in got) == 2
    assert printed_p[:len(got)] == got and printed_j[:len(want)] == want


def _fake_render(scene, view=0, resolution=256, spp=64, max_depth=3, seed=0, clamp=0.0,
                 lambertian=False, **kw):
    """A fixed image plus noise of one over sqrt(spp) from (seed, clamp):
    the sweep's arithmetic on renders that both packages share."""
    rng = np.random.default_rng([seed, int(clamp * 10), spp])
    base = np.linspace(0, 1.2, resolution * resolution * 3).reshape(resolution, resolution, 3)
    return (base + rng.normal(0, 0.3 / np.sqrt(spp), base.shape)).astype(np.float32)


def test_gt_noise_sweep_markdown_matches_the_jax_tool(tmp_path, monkeypatch):
    from renderformer_tpu.io import h5 as jax_h5
    from renderformer_tpu.scene import path_tracer as jax_pt
    from renderformer_tpu_torch.io import h5 as port_h5
    from renderformer_tpu_torch.scene import path_tracer as port_pt
    from renderformer_tpu_torch.tools import gt_noise_sweep as port
    names = [str(tmp_path / f'scene_{i}.h5') for i in range(2)]
    for mod in (jax_h5, port_h5):
        monkeypatch.setattr(mod, 'list_scene_files', lambda d: names)
        monkeypatch.setattr(mod, 'load_scene_h5', lambda f, padding_length=None: {})
    for mod in (jax_pt, port_pt):
        monkeypatch.setattr(mod, 'render_scene_pathtrace', _fake_render)
    doc = '# Training\n\nintro\n\n## Path-traced GT noise vs spp\n\nold\n\n## Next\n\nkept\n'
    argv = ['--resolution', '8', '--ref_spp', '160', '--spps', '8,100', '--clamp', '2.5']
    outs = {}
    for name, main, extra in (('jax', jax_tool('gt_noise_sweep').main, []),
                              ('port', port.main, ['--cpu'])):
        for kind, text in (('replace', doc), ('append', '# Training\n\nintro\n'),
                           ('new', None)):
            out = tmp_path / f'{name}_{kind}.md'
            if text is not None:
                out.write_text(text)
            _, printed = run_main(main, argv + ['--out', str(out)] + extra)
            assert printed[-1] == f'updated {out}'
            outs[name, kind] = out.read_text(), printed[:-1]
    tool = '(tools/gt_noise_sweep.py)'
    for kind in ('replace', 'append', 'new'):
        want = outs['jax', kind][0].replace(tool, '(renderformer_tpu_torch/tools/gt_noise_sweep.py)')
        assert outs['port', kind][0] == want, kind
        assert tool not in outs['port', kind][0]
    assert outs['port', 'replace'][1] == outs['jax', 'replace'][1]
    text = outs['port', 'replace'][0]
    assert 'old' not in text and text.endswith('## Next\n\nkept\n')
    assert text.count('| scene_0 |') == 2 and '* scene_1: clamp-2.5 bias' in text


def test_gt_noise_sweep_psnr_rises_with_spp():
    """The port's path tracer on a 14-triangle box at 16^2: the PSNR rises
    from 8 to 64 spp, clamped and not, and the clamp's bias is finite.  The
    random streams differ from the JAX package's, so this holds the
    images by their statistics."""
    from renderformer_tpu_torch.io.h5 import pad_scene
    from renderformer_tpu_torch.scene.to_h5 import build_texture_patches
    from renderformer_tpu_torch.tools import gt_noise_sweep as port

    def quad(c, u, v, size):
        c, u, v = (np.asarray(x, np.float32) for x in (c, u, v))
        h = size / 2
        p = [c - h * u - h * v, c + h * u - h * v, c + h * u + h * v, c - h * u + h * v]
        return np.stack([np.stack([p[0], p[1], p[2]]), np.stack([p[0], p[2], p[3]])])

    walls = [([0, -1, 0], [1, 0, 0], [0, 0, -1], [0.7] * 3),
             ([0, 1, 0], [1, 0, 0], [0, 0, 1], [0.7] * 3),
             ([0, 0, -1], [1, 0, 0], [0, 1, 0], [0.7] * 3),
             ([0, 0, 1], [-1, 0, 0], [0, 1, 0], [0.7] * 3),
             ([-1, 0, 0], [0, 0, 1], [0, 1, 0], [0.7, 0.1, 0.1]),
             ([1, 0, 0], [0, 0, -1], [0, 1, 0], [0.1, 0.7, 0.1])]
    tris = [quad(c, u, v, 2.0) for c, u, v, _ in walls] + [
        quad([0, 0.7, 0], [1, 0, 0], [0, 0, 1], 0.5)]
    diffuse = [a for *_, a in walls for _ in range(2)] + [[0.0] * 3] * 2
    emissive = [[0.0] * 3] * 12 + [[30.0] * 3] * 2
    tris = np.concatenate(tris)
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 0.9
    scene = pad_scene({'triangles': tris, 'vn': np.repeat(n[:, None], 3, axis=1),
                       'texture': build_texture_patches(14, diffuse, [0.1] * 3, 0.9, emissive),
                       'c2w': c2w[None], 'fov': np.array([60.0], np.float32)})
    rows, biases = port.sweep([('box', scene)], resolution=16, ref_spp=256, spps=[8, 64],
                              clamp=1.0, device='cpu', log=lambda s: None)
    (_, _, u8, c8), (_, _, u64, c64) = rows
    assert u64 > u8 + 3 and c64 > c8 + 3, rows
    assert np.isfinite(biases[0][1]) and biases[0][1] > 10, biases
