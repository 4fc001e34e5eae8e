"""Checkpoint IO of the port against the JAX package at the tiny config:
config.json both ways, the port's safetensors reader and writer against the
``safetensors`` package, export/import across the two packages bit for bit,
an HF directory rendered by both, and the training checkpoint's meta."""

import json
import os
import struct

import jax
import numpy as np
import pytest
import safetensors
import safetensors.numpy
import safetensors.torch
import torch

from renderformer_tpu.config import PRESETS as JAX_PRESETS
from renderformer_tpu.config import RenderFormerConfig as JaxConfig
from renderformer_tpu.convert.torch_to_jax import load_pretrained as jax_load_pretrained
from renderformer_tpu.models.renderformer import RenderFormer as JaxRenderFormer
from renderformer_tpu.pipelines.rendering_pipeline import RenderingPipeline as JaxPipeline
from renderformer_tpu.training import checkpoint as jax_ckpt
from renderformer_tpu_torch import (
    PRESETS, RenderFormerConfig, RenderingPipeline, V1_BASE_NERF, export_params)
from renderformer_tpu_torch.convert import (
    import_params, jax_params_to_state_dict, load_pretrained, state_dict_to_jax_params)
from renderformer_tpu_torch.io import safetensors as port_st
from renderformer_tpu_torch.models.renderformer import RenderFormer
from renderformer_tpu_torch.nn.core import init_weights

TINY = dict(latent_dim=72, num_layers=2, num_heads=2, dim_feedforward=144,
            num_register_tokens=4, vertex_pe_num_freqs=4,
            view_transformer_latent_dim=72, view_transformer_ffn_hidden_dim=144,
            view_transformer_n_heads=2, view_transformer_n_layers=4,
            dpt_features=16, dpt_out_channels=[8, 16, 32, 64])
RES, N, V = 64, 8, 2


@pytest.fixture(scope='module')
def jax_tree():
    """The tiny model's JAX key(0) init as numpy leaves."""
    return jax.tree.map(np.asarray, JaxRenderFormer(JaxConfig(**TINY)).init(jax.random.key(0)))


def _scene():
    rng = np.random.default_rng(0)
    c2w = np.tile(np.eye(4, dtype=np.float32), (1, V, 1, 1))
    c2w[0, :, 2, 3] = [2.0, 2.5]
    mask = np.ones((1, N), bool)
    mask[0, -2:] = False
    tex = rng.uniform(0, 1, (1, N, 13, 32, 32)).astype(np.float32)
    tex[0, :2, 10:] *= 20.0
    return (rng.normal(size=(1, N, 3, 3)).astype(np.float32) * 0.3, tex, mask,
            rng.normal(size=(1, N, 3, 3)).astype(np.float32), c2w,
            np.full((1, V, 1), 40.0, np.float32))


def _assert_state_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _assert_trees_equal(got, want):
    gl, gs = jax.tree.flatten(got)
    wl, ws = jax.tree.flatten(want)
    assert gs == ws
    for a, b in zip(gl, wl):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# -- config.json ---------------------------------------------------------

@pytest.mark.parametrize('name', ['tiny', 'v1-base', 'v1.1-swin-large', 'v1-base nerf'])
def test_config_json_round_trips_with_jax(tmp_path, name):
    port_cfg = {'tiny': RenderFormerConfig(**TINY), 'v1-base nerf': V1_BASE_NERF}.get(
        name) or PRESETS[name]
    jax_cfg = JaxConfig.from_dict(port_cfg.to_dict())
    if name in JAX_PRESETS:
        assert jax_cfg == JAX_PRESETS[name]
    port_cfg.save_json(str(tmp_path / 'port.json'))
    jax_cfg.save_json(str(tmp_path / 'jax.json'))
    assert (tmp_path / 'port.json').read_bytes() == (tmp_path / 'jax.json').read_bytes()
    assert JaxConfig.from_json(str(tmp_path / 'port.json')) == jax_cfg
    assert RenderFormerConfig.from_json(str(tmp_path / 'jax.json')) == port_cfg
    assert port_cfg.head_dim == jax_cfg.head_dim
    assert port_cfg.view_head_dim == jax_cfg.view_head_dim
    assert port_cfg.get('latent_dim') == jax_cfg.get('latent_dim')
    assert port_cfg.get('no_such_field', 7) == 7


# -- safetensors -----------------------------------------------------------

def _tensors(dtype):
    g = torch.Generator().manual_seed(0)
    shapes = [(3, 5, 7), (1,), (0, 3), (), (13, 1, 2)]
    out = {}
    for i, shape in enumerate(shapes):
        if dtype == torch.bool:
            t = torch.rand(shape, generator=g) > 0.5
        elif dtype.is_floating_point:
            t = (torch.randn(shape, generator=g) * 100).to(dtype)
        else:
            t = torch.randint(-2 ** 40 if dtype == torch.int64 else -2 ** 30, 2 ** 30, shape,
                              generator=g, dtype=dtype)
        out[f'layer.{i}.w'] = t
    return out


DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int64, torch.int32, torch.bool]
META = {'format': 'pt', 'note': 'tiny'}


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
def test_port_writer_is_read_by_safetensors(tmp_path, dtype):
    ts = _tensors(dtype)
    # a float32 tensor beside them, so tensors of two sizes share a buffer
    ts['odd.f32'] = torch.arange(5, dtype=torch.float32)
    path = str(tmp_path / 'x.safetensors')
    port_st.save_file(ts, path, metadata=META)
    got = safetensors.torch.load_file(path)
    with safetensors.safe_open(path, 'pt') as f:
        assert f.metadata() == META
    _assert_state_dicts_equal(got, ts)


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
def test_port_reader_reads_safetensors(tmp_path, dtype):
    ts = _tensors(dtype)
    ts['odd.f16'] = torch.arange(3, dtype=torch.float16)
    path = str(tmp_path / 'x.safetensors')
    safetensors.torch.save_file(ts, path, metadata=META)
    got = port_st.load_file(path)
    assert port_st.load_metadata(path) == META
    _assert_state_dicts_equal(got, ts)
    for t in got.values():
        # each tensor owns writeable memory of its own
        t.reshape(-1)[:1] = t.reshape(-1)[:1]
    ptrs = [t.data_ptr() for t in got.values() if t.numel()]
    assert len(set(ptrs)) == len(ptrs)


def test_port_writer_takes_numpy(tmp_path):
    arrs = {'a': np.arange(6, dtype=np.float32).reshape(2, 3).T, 'b': np.array([True, False])}
    path = str(tmp_path / 'x.safetensors')
    port_st.save_file(arrs, path)
    got = safetensors.numpy.load_file(path)
    for k, v in arrs.items():
        np.testing.assert_array_equal(got[k], v)
    assert port_st.load_metadata(path) is None


def _corrupt(path, edit):
    data = open(path, 'rb').read()
    n, = struct.unpack('<Q', data[:8])
    header = json.loads(data[8:8 + n])
    body = data[8 + n:]
    header, body = edit(header, body)
    blob = json.dumps(header).encode()
    with open(path, 'wb') as f:
        f.write(struct.pack('<Q', len(blob)) + blob + body)


def _shift(name, d):
    def edit(h, body):
        h[name]['data_offsets'] = [o + d for o in h[name]['data_offsets']]
        return h, body
    return edit


MALFORMED = {
    'gap': lambda h, b: (_shift('b', 4)(h, b)[0], b + b'\0' * 4),
    'overlap': lambda h, b: (_shift('b', -4)(h, b)[0], b[:-4]),
    'short_span': lambda h, b: ({**h, 'b': {**h['b'], 'data_offsets':
                                            [h['b']['data_offsets'][0],
                                             h['b']['data_offsets'][1] - 4]}}, b[:-4]),
    'trailing_bytes': lambda h, b: (h, b + b'\0' * 8),
    'truncated': lambda h, b: (h, b[:-4]),
    'bad_dtype': lambda h, b: ({**h, 'a': {**h['a'], 'dtype': 'F8'}}, b),
    'bad_shape': lambda h, b: ({**h, 'a': {**h['a'], 'shape': [-1]}}, b),
}


@pytest.mark.parametrize('kind', sorted(MALFORMED))
def test_malformed_offsets_raise(tmp_path, kind):
    path = str(tmp_path / 'x.safetensors')
    safetensors.torch.save_file({'a': torch.ones(2, 3), 'b': torch.zeros(4)}, path)
    _corrupt(path, MALFORMED[kind])
    with pytest.raises(ValueError):
        port_st.load_file(path)


def test_header_length_beyond_the_file_raises(tmp_path):
    path = tmp_path / 'x.safetensors'
    path.write_bytes(struct.pack('<Q', 1 << 20) + b'{}')
    with pytest.raises(ValueError, match='exceeds'):
        port_st.load_file(str(path))


# -- across the two packages -----------------------------------------------

def test_jax_export_loads_in_port(tmp_path, jax_tree):
    path = str(tmp_path / 'ckpt')
    jax_ckpt.export_params(path, jax_tree, JaxConfig(**TINY))
    cfg, sd = import_params(path)
    assert cfg == RenderFormerConfig(**TINY)
    _assert_state_dicts_equal(sd, jax_params_to_state_dict(jax_tree))
    pipe = RenderingPipeline.from_pretrained(path, device='cpu')
    assert pipe.config == cfg
    _assert_state_dicts_equal(pipe.model.state_dict(), jax_params_to_state_dict(jax_tree))


def test_port_export_loads_in_jax(tmp_path, jax_tree):
    model = RenderFormer(RenderFormerConfig(**TINY))
    model.load_state_dict(jax_params_to_state_dict(jax_tree))
    path = str(tmp_path / 'ckpt')
    export_params(path, model, model.config)
    assert json.load(open(os.path.join(path, 'jax_format.json'))) == {
        'format': 'renderformer_tpu', 'version': 1}
    cfg, tree = jax_ckpt.import_params(path)
    assert cfg == JaxConfig(**TINY)
    _assert_trees_equal(jax.tree.map(np.asarray, tree), jax_tree)
    # a state_dict exports the same bytes as its model
    path2 = str(tmp_path / 'ckpt2')
    export_params(path2, model.state_dict(), model.config)
    for f in ('config.json', 'jax_format.json', 'model.safetensors'):
        assert open(os.path.join(path, f), 'rb').read() == \
            open(os.path.join(path2, f), 'rb').read(), f


def test_port_export_round_trips_in_port(tmp_path):
    cfg = RenderFormerConfig(**TINY, pe_type='nerf')
    model = init_weights(RenderFormer(cfg), torch.Generator().manual_seed(3))
    path = str(tmp_path / 'ckpt')
    export_params(path, model, cfg)
    pipe = RenderingPipeline.from_pretrained(path, device='cpu')
    assert pipe.config == cfg
    _assert_state_dicts_equal(pipe.model.state_dict(), model.state_dict())


def _write_hf_dir(path, model):
    os.makedirs(path)
    model.config.save_json(os.path.join(path, 'config.json'))
    port_st.save_file(model.state_dict(), os.path.join(path, 'model.safetensors'))


def test_hf_directory_renders_in_both_packages(tmp_path, jax_tree):
    model = RenderFormer(RenderFormerConfig(**TINY))
    model.load_state_dict(jax_params_to_state_dict(jax_tree))
    path = str(tmp_path / 'hf')
    _write_hf_dir(path, model)
    assert not os.path.exists(os.path.join(path, 'jax_format.json'))

    cfg, sd = load_pretrained(path)
    _assert_state_dicts_equal(sd, model.state_dict())
    jcfg, jparams = jax_load_pretrained(path)
    assert jcfg == JaxConfig(**TINY)
    _assert_trees_equal(jax.tree.map(np.asarray, jparams), jax_tree)

    scene = _scene()
    port = RenderingPipeline.from_pretrained(path, device='cpu')
    got = port.render(*scene, resolution=RES, precision='fp32').numpy()
    want = np.asarray(JaxPipeline.from_pretrained(path).render(
        *scene, resolution=RES, precision='fp32'))
    assert got.shape == want.shape == (1, V, RES, RES, 3)
    assert np.isfinite(got).all()
    # the bar of test_torch_pipeline.py::test_fp32_against_jax_default_composed_tail
    assert float(np.abs(got - want).max()) <= 1e-4


def test_hf_directory_drops_the_rotary_dummy_buffer(tmp_path):
    model = init_weights(RenderFormer(RenderFormerConfig(**TINY)), torch.Generator().manual_seed(1))
    path = str(tmp_path / 'hf')
    os.makedirs(path)
    model.config.save_json(os.path.join(path, 'config.json'))
    sd = dict(model.state_dict())
    sd['transformer.rope_emb.dummy'] = torch.zeros(1)
    port_st.save_file(sd, os.path.join(path, 'model.safetensors'))
    pipe = RenderingPipeline.from_pretrained(path, device='cpu')
    _assert_state_dicts_equal(pipe.model.state_dict(), model.state_dict())


def test_from_pretrained_builds_fp32_masters_on_the_device(tmp_path):
    model = init_weights(RenderFormer(RenderFormerConfig(**TINY)), torch.Generator().manual_seed(2))
    path = str(tmp_path / 'hf')
    os.makedirs(path)
    model.config.save_json(os.path.join(path, 'config.json'))
    port_st.save_file({k: v.to(torch.bfloat16) for k, v in model.state_dict().items()},
                      os.path.join(path, 'model.safetensors'))
    pipe = RenderingPipeline.from_pretrained(path, device='cpu')
    for k, t in pipe.model.state_dict().items():
        assert t.device.type == 'cpu' and t.dtype == torch.float32, k
        assert torch.equal(t, model.state_dict()[k].to(torch.bfloat16).float()), k


def test_from_pretrained_refusals(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match='not a local checkpoint dir or preset name'):
        RenderingPipeline.from_pretrained(str(tmp_path / 'missing'), device='cpu')
    model = init_weights(RenderFormer(RenderFormerConfig(**TINY)), torch.Generator().manual_seed(0))
    path = str(tmp_path / 'hf')
    _write_hf_dir(path, model)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        RenderingPipeline.from_pretrained(path)


def test_hf_directory_with_a_missing_key_raises(tmp_path):
    model = init_weights(RenderFormer(RenderFormerConfig(**TINY)), torch.Generator().manual_seed(0))
    path = str(tmp_path / 'hf')
    os.makedirs(path)
    model.config.save_json(os.path.join(path, 'config.json'))
    sd = dict(model.state_dict())
    sd.pop('reg_tokens')
    port_st.save_file(sd, os.path.join(path, 'model.safetensors'))
    with pytest.raises(RuntimeError, match='reg_tokens'):
        RenderingPipeline.from_pretrained(path, device='cpu')


# -- the training checkpoint's meta ----------------------------------------

def test_training_meta_matches_jax(tmp_path, jax_tree):
    import jax.numpy as jnp
    from renderformer_tpu.training.state import TrainConfig as JaxTrainConfig
    from renderformer_tpu.training.state import TrainState as JaxTrainState
    from renderformer_tpu.training.state import make_optimizer as jax_make_optimizer
    from renderformer_tpu_torch.training import state as tstate
    from renderformer_tpu_torch.training.checkpoint import META_FILE, save_checkpoint

    extra = {'epoch': 3, 'train_losses': [1.0, 0.5]}
    jtx = jax_make_optimizer(JaxTrainConfig())
    jstate = JaxTrainState(params=jax_tree, opt_state=jtx.init(jax_tree),
                           step=jnp.asarray(7, jnp.int32))
    jpath = jax_ckpt.save_checkpoint(str(tmp_path / 'jax'), 'best', jstate,
                                     JaxConfig(**TINY), extra=extra)

    model = RenderFormer(RenderFormerConfig(**TINY))
    model.load_state_dict(jax_params_to_state_dict(jax_tree))
    tc = tstate.TrainConfig(precision='float32')
    tx = tstate.make_optimizer(tc)
    ppath = save_checkpoint(str(tmp_path / 'port'), 'best',
                            tstate.TrainState.create(model, tx, tc), model.config, extra)
    with open(os.path.join(jpath, META_FILE)) as f:
        jmeta = json.load(f)
    with open(os.path.join(ppath, META_FILE)) as f:
        pmeta = json.load(f)
    assert pmeta == jmeta
    assert list(pmeta['model_config']) == list(jmeta['model_config'])
    assert RenderFormerConfig.from_dict(pmeta['model_config']) == model.config


def test_state_dict_to_jax_params_of_a_loaded_model_is_the_tree(tmp_path, jax_tree):
    path = str(tmp_path / 'ckpt')
    jax_ckpt.export_params(path, jax_tree, JaxConfig(**TINY))
    pipe = RenderingPipeline.from_pretrained(path, device='cpu')
    _assert_trees_equal(state_dict_to_jax_params(pipe.model.state_dict()), jax_tree)
