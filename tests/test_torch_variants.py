"""The architecture variants no released model sets, at the tiny config on
the CPU, against the JAX package: the NeRF-encoded 2-D ray map
(``vdir_num_freqs != 0``), the linear head (``use_dpt_decoder=False``)
and both; a train step of the linear-head model; and the weight bridge
for ``out_proj`` and the wider ``ray_map_encoder``.

The weights are the port's seeded init carried to the JAX tree by
convert.py (bit-exact both ways, tests/test_torch_convert.py): a JAX init
would compile every random op of the tree on its first call."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderformer_tpu import RenderFormerConfig as JaxConfig
from renderformer_tpu import RenderingPipeline as JaxPipeline
from renderformer_tpu.models.renderformer import RenderFormer as JaxRenderFormer
from renderformer_tpu.training import state as jstate
from renderformer_tpu_torch import RenderFormerConfig, RenderingPipeline
from renderformer_tpu_torch.convert import jax_params_to_state_dict, state_dict_to_jax_params
from renderformer_tpu_torch.models.renderformer import RenderFormer
from renderformer_tpu_torch.nn.core import init_weights
from renderformer_tpu_torch.training import state as tstate

TINY = dict(latent_dim=72, num_layers=2, num_heads=2, dim_feedforward=144,
            num_register_tokens=4, vertex_pe_num_freqs=4,
            view_transformer_latent_dim=72, view_transformer_ffn_hidden_dim=144,
            view_transformer_n_heads=2, view_transformer_n_layers=4,
            dpt_features=16, dpt_out_channels=[8, 16, 32, 64])
RES, N, V = 32, 8, 2
VARIANTS = {'vdir': dict(vdir_num_freqs=2), 'linear': dict(use_dpt_decoder=False),
            'vdir_linear': dict(vdir_num_freqs=2, use_dpt_decoder=False)}


def _scene(seed=0):
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, np.pi, V, endpoint=False)
    c2w = np.tile(np.eye(4, dtype=np.float32), (1, V, 1, 1))
    c2w[0, :, 0, 0] = np.cos(ang)
    c2w[0, :, 0, 2] = np.sin(ang)
    c2w[0, :, 2, 0] = -np.sin(ang)
    c2w[0, :, 2, 2] = np.cos(ang)
    c2w[0, :, :3, 3] = np.stack([2 * np.sin(ang), np.zeros(V), 2 * np.cos(ang)], -1)
    mask = np.ones((1, N), bool)
    mask[0, -2:] = False
    return (rng.normal(size=(1, N, 3, 3)).astype(np.float32) * 0.3,
            rng.uniform(0, 1, (1, N, 13, 32, 32)).astype(np.float32), mask,
            rng.normal(size=(1, N, 3, 3)).astype(np.float32), c2w,
            np.full((1, V, 1), 40.0, np.float32))


def seeded(cfg, seed=0):
    """The port's model of ``cfg`` from its seeded init, and the same weights
    as a JAX tree."""
    model = init_weights(RenderFormer(RenderFormerConfig(**cfg)),
                         torch.Generator().manual_seed(seed))
    # copies: a numpy view of a tensor that a port step then updates in place
    # would change under JAX's asynchronous dispatch
    return model, jax.tree.map(lambda a: jnp.asarray(np.array(a)),
                               state_dict_to_jax_params(model.state_dict()))


@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_variant_render_matches_jax(variant):
    cfg = dict(TINY, **VARIANTS[variant])
    model, params = seeded(cfg)
    jp = JaxPipeline(JaxRenderFormer(JaxConfig(**cfg)), params)
    scene = _scene()
    want = np.asarray(jp.render(*scene, resolution=RES, precision='fp32'))
    got = RenderingPipeline(model, device='cpu').render(
        *scene, resolution=RES, precision='fp32').numpy()
    assert got.shape == want.shape == (1, V, RES, RES, 3)
    assert np.isfinite(got).all()
    # fp32 end to end, the same function up to summation order: 1e-4, the
    # bar of tests/test_torch_pipeline.py, of the pixel's magnitude where it
    # passes 1 (the linear head's seeded init reaches HDR ~380, where one
    # fp32 ulp is 3e-5)
    assert (np.abs(got - want) <= 1e-4 * np.maximum(1.0, np.abs(want))).all()


def test_linear_head_train_step_matches_jax():
    cfg = dict(TINY, use_dpt_decoder=False)
    fp32 = dict(precision='float32', view_precision='float32', resolution=RES,
                learning_rate=1e-3, steps_per_epoch=10, num_epochs=1)
    jm = JaxRenderFormer(JaxConfig(**cfg))
    model, params = seeded(cfg)
    jtc = jstate.TrainConfig(**fp32)
    jtx = jstate.make_optimizer(jtc)
    step = jax.jit(jstate.make_train_step(jm, jtx, jtc, impl='xla')[0])
    rng = np.random.default_rng(7)
    scene = _scene(1)
    batch = dict(zip(('triangles', 'texture', 'mask', 'vn', 'c2w', 'fov'), scene),
                 gt=rng.uniform(0, 1, (1, V, RES, RES, 3)).astype(np.float32))
    _, jm_ = step(jstate.TrainState.create(params, jtx),
                  {k: jnp.asarray(v) for k, v in batch.items()})
    tc = tstate.TrainConfig(**fp32)
    tx = tstate.make_optimizer(tc)
    tstep, _ = tstate.make_train_step(model, tx, tc)
    _, tm = tstep(tstate.TrainState.create(model, tx, tc),
                  {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ('loss', 'grad_norm'):
        # test_torch_train.py's bar: fp32, the same function up to
        # summation order
        assert tm[k] == pytest.approx(float(jm_[k]), rel=1e-5), k


def test_convert_round_trips_out_proj_and_wide_ray_encoder():
    cfg = dict(TINY, vdir_num_freqs=2, use_dpt_decoder=False)
    model, _ = seeded(cfg, 1)
    params = state_dict_to_jax_params(model.state_dict())
    # the JAX model's own tree, by shape (no init runs)
    shapes = jax.eval_shape(JaxRenderFormer(JaxConfig(**cfg)).init, jax.random.key(1))
    assert jax.tree.structure(shapes) == jax.tree.structure(params)
    for got, want in zip(jax.tree.leaves(params), jax.tree.leaves(shapes)):
        assert got.shape == want.shape
    sd = jax_params_to_state_dict(params)
    vt = params['view_transformer']
    p = 8
    assert 'out_dpt' not in vt
    # kernels [in, out] -> weights [out, in]: (c p1 p2) stays the input order
    np.testing.assert_array_equal(sd['view_transformer.out_proj.weight'].numpy(),
                                  vt['out_proj']['kernel'].T)
    assert sd['view_transformer.out_proj.weight'].shape == (p * p * 3, 72)
    assert sd['view_transformer.ray_map_encoder.weight'].shape == (72, (3 + 3 * 2 * 2) * p * p)
    model = RenderFormer(RenderFormerConfig(**cfg))
    model.load_state_dict(sd, strict=True)
    back = state_dict_to_jax_params(model.state_dict())
    for a, b in (('out_proj', 'kernel'), ('out_proj', 'bias'), ('ray_map_encoder', 'kernel')):
        np.testing.assert_array_equal(back['view_transformer'][a][b], vt[a][b])
