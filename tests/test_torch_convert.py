"""Weight bridge between the JAX parameter tree and the port's state_dict:
the round trip is bit-exact, the keys are exactly the port modules', and
the v1-base parameter count agrees on both sides."""

import jax
import numpy as np
import pytest
import torch

from renderformer_tpu.config import RenderFormerConfig as JaxConfig
from renderformer_tpu.config import V1_BASE as JAX_V1_BASE
from renderformer_tpu.models.renderformer import RenderFormer as JaxRenderFormer
from renderformer_tpu_torch import RenderFormerConfig, V1_BASE
from renderformer_tpu_torch.convert import (
    jax_params_to_state_dict, state_dict_to_jax_params)
from renderformer_tpu_torch.models.renderformer import RenderFormer

V1_BASE_PARAMS = 205_173_391

TINY = dict(latent_dim=72, num_layers=2, num_heads=2, dim_feedforward=144,
            num_register_tokens=4, vertex_pe_num_freqs=4,
            view_transformer_latent_dim=72, view_transformer_ffn_hidden_dim=144,
            view_transformer_n_heads=2, view_transformer_n_layers=4,
            dpt_features=16, dpt_out_channels=[8, 16, 32, 64])


@pytest.fixture(scope='module')
def tiny_tree():
    params = JaxRenderFormer(JaxConfig(**TINY)).init(jax.random.key(0))
    return jax.tree.map(np.asarray, params)


def _assert_trees_equal(a, b, path=''):
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_trees_equal(a[k], b[k], f'{path}.{k}')
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f'{path}.{i}')
    else:
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert np.array_equal(a, b), path


def test_round_trip_is_bit_exact(tiny_tree):
    sd = jax_params_to_state_dict(tiny_tree)
    back = state_dict_to_jax_params(sd)
    _assert_trees_equal(tiny_tree, back)


def test_state_dict_loads_strictly_into_port_modules(tiny_tree):
    model = RenderFormer(RenderFormerConfig(**TINY))
    sd = jax_params_to_state_dict(tiny_tree)
    want = model.state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
    model.load_state_dict(sd, strict=True)
    # the port's own state_dict maps back to the same JAX tree
    _assert_trees_equal(tiny_tree, state_dict_to_jax_params(model.state_dict()))


@pytest.mark.parametrize('key,jax_shape,torch_shape', [
    ('transformer.layers.0.multihead_attn.in_proj.weight', (72, 216), (216, 72)),
    ('view_transformer.out_dpt.resize_layers.0.weight', (4, 4, 8, 8), (8, 8, 4, 4)),
    ('view_transformer.out_dpt.scratch.layer1_rn.weight', (3, 3, 8, 16), (16, 8, 3, 3)),
    ('view_transformer.out_dpt.scratch.output_conv2.2.weight', (1, 1, 32, 3),
     (3, 32, 1, 1)),
    ('transformer.rope_emb.freqs', (2,), (2,)),
])
def test_layout_rules(tiny_tree, key, jax_shape, torch_shape):
    sd = jax_params_to_state_dict(tiny_tree)
    assert tuple(sd[key].shape) == torch_shape
    back = state_dict_to_jax_params({key: sd[key]})
    leaf = back
    while isinstance(leaf, (dict, list)):
        leaf = leaf[0] if isinstance(leaf, list) else next(iter(leaf.values()))
    assert leaf.shape == jax_shape


def test_v1_base_parameter_count_matches_jax():
    shapes = jax.eval_shape(JaxRenderFormer(JAX_V1_BASE).init, jax.random.key(0))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    with torch.device('meta'):
        model = RenderFormer(V1_BASE)
    n_port = sum(t.numel() for t in model.state_dict().values())
    assert n_jax == V1_BASE_PARAMS
    assert n_port == V1_BASE_PARAMS


@pytest.mark.parametrize('preset', ['v1-base', 'v1.1-swin-large'])
def test_config_schema_and_presets_match_jax(tmp_path, preset):
    import dataclasses
    from renderformer_tpu.config import PRESETS as JAX_PRESETS
    from renderformer_tpu_torch import PRESETS
    jcfg, tcfg = JAX_PRESETS[preset], PRESETS[preset]
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert (jcfg.rope_dim, jcfg.view_rope_dim, jcfg.dpt_tap_layers()) == (
        tcfg.rope_dim, tcfg.view_rope_dim, tcfg.dpt_tap_layers())
    # a config.json written by the JAX package loads unchanged into the port
    path = str(tmp_path / 'config.json')
    jcfg.save_json(path)
    assert RenderFormerConfig.from_json(path) == tcfg
