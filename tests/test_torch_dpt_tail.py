"""The port's composed DPT output tail against the JAX package on the CPU:
the plain version of kernel K5 (resize into space-to-depth layout) against
the JAX Pallas kernel in interpret mode, the space-to-depth convs, the
composed 5x5 tail with its ring correction, and the DPT head under each of
its three tails."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderformer_tpu.nn.dpt import DPTHead as JaxDPTHead
from renderformer_tpu.ops import dpt_tail as jtail
from renderformer_tpu.ops import s2d_conv as js2d
from renderformer_tpu.ops.fused_resize import fused_resize_s2d
from renderformer_tpu_torch import RuntimeConfig
from renderformer_tpu_torch.convert import jax_params_to_state_dict
from renderformer_tpu_torch.nn.core import silu
from renderformer_tpu_torch.nn.dpt import DPTHead
from renderformer_tpu_torch.ops import dpt_tail, s2d_conv
from renderformer_tpu_torch.ops.fused_resize import resize_bilinear, resize_s2d


def _rand(shape, seed, scale=0.2):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize('ih,iw,oh,ow', [(16, 16, 32, 32), (16, 32, 32, 64)])
def test_resize_s2d_plain_matches_jax_kernel_fp32(ih, iw, oh, ow):
    x = _rand((2, ih, iw, 128), ih + iw, 1.0)
    got = resize_s2d(_t(x), (oh, ow))
    assert got.shape == (2, oh // 2, ow // 2, 512)
    want = np.asarray(fused_resize_s2d(jnp.asarray(x), (oh, ow), interpret=True))
    # the banded kernel sums the same two taps per axis, in another order
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=1e-6)


def test_resize_s2d_plain_is_resize_then_space_to_depth():
    x = _t(_rand((2, 8, 12, 16), 1, 1.0))
    for dt in (torch.float32, torch.bfloat16):
        got = resize_s2d(x.to(dt), (16, 24))
        # the kernel's arithmetic: the fp32 resize rounded once
        want = s2d_conv.space_to_depth(resize_bilinear(x.to(dt).float(), (16, 24)).to(dt))
        assert got.dtype == dt
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        resize_s2d(x, (15, 24))


def test_resize_s2d_plain_matches_jax_kernel_bf16():
    x = _rand((2, 16, 16, 128), 9, 1.0)
    got = resize_s2d(_t(x).bfloat16(), (32, 32)).float().numpy()
    want = np.asarray(fused_resize_s2d(jnp.asarray(x, jnp.bfloat16), (32, 32),
                                       interpret=True).astype(jnp.float32))
    # the banded kernel rounds its H pass to bf16; the port rounds once
    np.testing.assert_allclose(got, want, atol=6e-2, rtol=2e-2)


def test_space_to_depth_matches_jax():
    x = _rand((2, 8, 12, 5), 2)
    s = s2d_conv.space_to_depth(_t(x))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js2d.space_to_depth(jnp.asarray(x))))
    np.testing.assert_array_equal(s2d_conv.depth_to_space(s).numpy(), x)


def test_s2d_block_kernel_and_conv_match_jax():
    x = _rand((2, 12, 16, 6), 3, 1.0)
    k, b = _rand((3, 3, 6, 5), 4), _rand((5,), 5)
    np.testing.assert_array_equal(s2d_conv.s2d_block_kernel(_t(k)).numpy(),
                                  np.asarray(js2d.s2d_block_kernel(jnp.asarray(k))))
    got = s2d_conv.conv2d_s2d(_t(x), _t(k), _t(b)).numpy()
    want = np.asarray(js2d.conv2d_s2d(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b)))
    # fp32 convs, summation order
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    plain = s2d_conv.conv2d_hwio(_t(x), _t(k), _t(b), padding=1).numpy()
    np.testing.assert_allclose(got, plain, atol=1e-5, rtol=1e-5)


def test_compose_and_block_kernel5_match_jax():
    k1, b1 = _rand((3, 3, 6, 4), 6), _rand((4,), 7)
    k2, b2 = _rand((3, 3, 4, 5), 8), _rand((5,), 9)
    k5, b5 = dpt_tail.compose_conv3x3_pair(_t(k1), _t(b1), _t(k2), _t(b2))
    jk5, jb5 = jtail.compose_conv3x3_pair(*(jnp.asarray(a) for a in (k1, b1, k2, b2)))
    np.testing.assert_allclose(k5.numpy(), np.asarray(jk5), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(b5.numpy(), np.asarray(jb5), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(dpt_tail.s2d_block_kernel5(_t(np.asarray(jk5))).numpy(),
                                  np.asarray(jtail.s2d_block_kernel5(jk5)))
    kk = _rand((1, 1, 6, 3), 10)
    np.testing.assert_array_equal(dpt_tail.block_diag_1x1(_t(kk)).numpy(),
                                  np.asarray(jtail._block_diag_1x1(jnp.asarray(kk))))


def test_compose_rounds_in_the_kernels_dtype():
    """In bf16 the composed kernel rounds where JAX's does: each tap product
    and each running sum in bf16."""
    k1, b1 = _rand((3, 3, 16, 8), 11), _rand((8,), 12)
    k2, b2 = _rand((3, 3, 8, 4), 13), _rand((4,), 14)
    k5, b5 = dpt_tail.compose_conv3x3_pair(*(_t(a).bfloat16() for a in (k1, b1, k2, b2)))
    jk5, jb5 = jtail.compose_conv3x3_pair(*(jnp.asarray(a, jnp.bfloat16)
                                            for a in (k1, b1, k2, b2)))
    assert k5.dtype == torch.bfloat16
    f32, _ = dpt_tail.compose_conv3x3_pair(*(_t(a) for a in (k1, b1, k2, b2)))
    got = k5.float().numpy()
    want = np.asarray(jk5.astype(jnp.float32))
    # both round the 16-term tap products and the sums to bf16: one ulp of
    # each apart at most, while the fp32 composition differs more
    np.testing.assert_allclose(got, want, atol=2.0 ** -8 * np.abs(want).max(), rtol=0)
    np.testing.assert_allclose(b5.float().numpy(), np.asarray(jb5.astype(jnp.float32)),
                               atol=2.0 ** -7 * np.abs(np.asarray(jb5.astype(jnp.float32))).max())
    assert np.abs(got - f32.numpy()).max() > 0


def test_ring_correction_matches_jax():
    u = _rand((2, 10, 12, 6), 15, 1.0)
    k1, b1 = _rand((3, 3, 6, 4), 16), _rand((4,), 17)
    k2 = _rand((3, 3, 4, 5), 18)
    borders = (u[:, 0], u[:, -1], u[:, :, 0], u[:, :, -1])
    got = dpt_tail.ring_correction(tuple(_t(b) for b in borders), _t(k1), _t(b1), _t(k2))
    want = jtail.ring_correction(tuple(jnp.asarray(b) for b in borders),
                                 jnp.asarray(k1), jnp.asarray(b1), jnp.asarray(k2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('c,m,o,h,w', [(6, 4, 5, 16, 16), (8, 8, 8, 12, 20),
                                       (16, 8, 32, 4, 6)])
@pytest.mark.parametrize('given_s2d', [False, True])
def test_composed_tail_full_matches_jax_and_plain_chain(c, m, o, h, w, given_s2d):
    u = _rand((2, h, w, c), 19, 1.0)
    k1, b1 = _rand((3, 3, c, m), 20), _rand((m,), 21)
    k2, b2 = _rand((3, 3, m, o), 22), _rand((o,), 23)
    k3, b3 = _rand((1, 1, o, 3), 24), _rand((3,), 25)
    ws = [_t(a) for a in (k1, b1, k2, b2, k3, b3)]
    tu = _t(u)
    if given_s2d:
        borders = (tu[:, 0], tu[:, -1], tu[:, :, 0], tu[:, :, -1])
        got = dpt_tail.composed_tail_full(None, *ws, silu,
                                          u_s2d=s2d_conv.space_to_depth(tu),
                                          borders=borders)
    else:
        got = dpt_tail.composed_tail_full(tu, *ws, silu)
    want = jax.jit(lambda *a: jtail.composed_tail_full(*a, jax.nn.silu))(
        *(jnp.asarray(a) for a in (u, k1, b1, k2, b2, k3, b3)))
    assert got.shape == (2, h, w, 3)
    # fp32 convs in another summation order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # and the sequential chain, ring included
    y = s2d_conv.conv2d_hwio(tu, ws[0], ws[1], padding=1)
    y = s2d_conv.conv2d_hwio(silu(s2d_conv.conv2d_hwio(y, ws[2], ws[3], padding=1)),
                             ws[4], ws[5])
    np.testing.assert_allclose(got.numpy(), y.numpy(), atol=1e-5, rtol=1e-5)


def _heads(seed=0, in_ch=32, feats=16, oc=(8, 16, 32, 64)):
    jh = JaxDPTHead(in_channels=in_ch, features=feats, out_channels=oc, out_dim=3)
    params = jh.init(jax.random.key(seed))
    th = DPTHead(in_ch, feats, oc, 3)
    th.load_state_dict(jax_params_to_state_dict(jax.tree.map(np.asarray, params)))
    return jh, params, th


@pytest.mark.parametrize('tail', ['composed', 's2d', 'plain'])
@pytest.mark.parametrize('patch', [(8, 8), (4, 6)])
def test_dpt_head_tails_match_jax(monkeypatch, tail, patch):
    monkeypatch.setenv('RFTPU_DPT_TAIL', tail)
    ph, pw = patch
    jh, params, th = _heads()
    rng = np.random.default_rng(4)
    taps = [rng.normal(size=(2, ph * pw, 32)).astype(np.float32) for _ in range(4)]
    run = jax.jit(lambda p, t: jh(p, t, ph, pw, patch_size=8))
    want = np.asarray(run(params, [jnp.asarray(t) for t in taps]))
    with torch.no_grad():
        th.tail = tail
        got = th([torch.from_numpy(t) for t in taps], ph, pw, patch_size=8).numpy()
        th.tail = 'plain'
        plain = th([torch.from_numpy(t) for t in taps], ph, pw, patch_size=8).numpy()
    assert got.shape == (2, ph * 8, pw * 8, 3)
    # fp32 convs in another summation order
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got, plain, atol=2e-5, rtol=1e-5)


def test_dpt_head_patch16_takes_the_plain_tail():
    """At patch size 16 refinenet1's upsample does not reach the image size:
    the fast tails do not apply, and every tail computes the plain one."""
    _, _, th = _heads(1)
    rng = np.random.default_rng(6)
    taps = [torch.from_numpy(rng.normal(size=(1, 16, 32)).astype(np.float32))
            for _ in range(4)]
    outs = []
    with torch.no_grad():
        for t in ('composed', 's2d', 'plain'):
            th.tail = t
            outs.append(th(taps, 4, 4, patch_size=16))
    assert outs[0].shape == (1, 64, 64, 3)
    assert torch.equal(outs[0], outs[2]) and torch.equal(outs[1], outs[2])


def test_runtime_config_refuses_unknown_tail():
    assert RuntimeConfig().dpt_tail == 'composed'
    with pytest.raises(ValueError):
        RuntimeConfig(dpt_tail='fused')
    _, _, th = _heads()
    assert th.tail == 'composed'
    th.tail = 'fused'
    with pytest.raises(ValueError):
        th([torch.zeros(1, 4, 32)] * 4, 2, 2, patch_size=8)


def test_composed_weights_made_once_per_weight_version():
    """The composed tail's weights are made once and reused while the
    output convs' weights stay as they are; an in-place change of a weight
    remakes them, and where autograd records the weights they are made anew
    each call, so a gradient reaches the convs."""
    _, _, th = _heads(2)
    rng = np.random.default_rng(7)
    taps = [torch.from_numpy(rng.normal(size=(1, 16, 32)).astype(np.float32))
            for _ in range(4)]
    with torch.no_grad():
        w1 = th._composed_weights()
        assert all(a is b for a, b in zip(w1, th._composed_weights()))
        out1 = th(taps, 4, 4, patch_size=8)
        th.scratch.output_conv1.weight.mul_(2.0)
        w2 = th._composed_weights()
        assert not torch.equal(w1[0], w2[0])
        oc1, oc2 = th.scratch.output_conv1, th.scratch.output_conv2
        fresh = dpt_tail.compose_tail_weights(
            *(t for c in (oc1, oc2[0], oc2[2]) for t in (c.weight.permute(2, 3, 1, 0), c.bias)))
        for a, b in zip(w2, fresh):
            assert torch.equal(a, b)
        out2 = th(taps, 4, 4, patch_size=8)
        assert not torch.equal(out1, out2)
    with torch.inference_mode():
        w3 = th._composed_weights()
        assert w3[0] is not w2[0] and torch.equal(w3[0], w2[0])
    w4 = th._composed_weights()
    assert w4[0].requires_grad and w4[0] is not th._composed_weights()[0]
    w4[0].sum().backward()
    assert th.scratch.output_conv2[0].weight.grad.abs().sum() > 0
