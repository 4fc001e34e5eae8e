"""The port's ring attention against the JAX package's on a CPU mesh: the
one-device fold at n = 4 and the two-process gloo group (a ring of two
ranks, and the batch split over two ranks), forward and the gradients of
q, k and v, each against JAX ``ring_attention(..., impl='xla')`` on a
(1, 4) and a (2, 2) mesh of the 8 virtual CPU devices, at the JAX tests'
tolerances (tests/test_ring_attention.py: the output at atol 2e-6, rtol
1e-5; the gradients at atol 5e-5, rtol 1e-4).  Both partials of the port
run: ``'xla'`` (JAX's jnp partials in torch ops) and ``'flash'`` (K10 and
K8, here their plain versions)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderformer_tpu.parallel.ring_attention import ring_attention as jax_ring
from renderformer_tpu.parallel.sharding import make_mesh as jax_mesh
from renderformer_tpu_torch.parallel.ring_attention import ring_fold

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_distributed_worker import run_group  # noqa: E402

B, H, D = 2, 2, 32
# name: (Sq, Sk, mask): a random mask with the first 4 keys valid, none, or
# only the first 4 keys valid, so that 3 of the 4 K/V slices are fully masked
CASES = {'cross': (16, 24, 'random'), 'cross_nomask': (16, 24, None),
         'self': (16, 16, 'random'), 'self_nomask': (16, 16, None),
         'masked_slices': (16, 24, 'first4')}
JAX_MESHES = ((1, 4), (2, 2))
IMPLS = ('xla', 'flash')
FWD_TOL = dict(atol=2e-6, rtol=1e-5)
GRAD_TOL = dict(atol=5e-5, rtol=1e-4)


def make_case(name):
    sq, sk, kind = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    arrs = {n: rng.normal(size=(B, s, H, D)).astype(np.float32)
            for n, s in (('q', sq), ('k', sk), ('v', sk), ('tgt', sq))}
    if kind == 'random':
        mask = rng.uniform(size=(B, sk)) > 0.3
        mask[:, :4] = True
        arrs['mask'] = mask
    elif kind == 'first4':
        arrs['mask'] = np.zeros((B, sk), bool)
        arrs['mask'][:, :4] = True
    return arrs


@pytest.fixture(scope='module')
def jax_results():
    """{(mesh, case): (out, dq, dk, dv)} of the JAX ring."""
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 virtual devices')
    out = {}
    for shape in JAX_MESHES:
        mesh = jax_mesh(shape, devices=jax.devices()[:4])
        for name in CASES:
            a = make_case(name)
            mask = jnp.asarray(a['mask']) if 'mask' in a else None

            def loss(q, k, v, mesh=mesh, mask=mask, tgt=jnp.asarray(a['tgt'])):
                o = jax_ring(q, k, v, mask, mesh=mesh, impl='xla')
                return jnp.sum((o - tgt) ** 2), o

            (_, o), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
                *(jnp.asarray(a[n]) for n in ('q', 'k', 'v')))
            out[shape, name] = tuple(np.asarray(t) for t in (o, *grads))
    return out


def port_fold(name, impl):
    a = make_case(name)
    q, k, v = (torch.from_numpy(a[n]).requires_grad_(True) for n in ('q', 'k', 'v'))
    mask = torch.from_numpy(a['mask']) if 'mask' in a else None
    o = ring_fold(q, k, v, mask, n=4, impl=impl)
    grads = torch.autograd.grad(((o - torch.from_numpy(a['tgt'])) ** 2).sum(), (q, k, v))
    return tuple(t.detach().numpy() for t in (o, *grads))


def assert_matches(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, **(FWD_TOL if i == 0 else GRAD_TOL),
                                   err_msg=f'{what} {("out", "dq", "dk", "dv")[i]}')


@pytest.mark.parametrize('impl', IMPLS)
@pytest.mark.parametrize('name', list(CASES))
def test_fold_matches_jax_ring(jax_results, name, impl):
    got = port_fold(name, impl)
    for shape in JAX_MESHES:
        assert_matches(got, jax_results[shape, name], f'fold vs JAX {shape}')


@pytest.fixture(scope='module')
def group_results(tmp_path_factory):
    """Each rank's results of the port's ring on a (1, 2) and a (2, 1) mesh
    of a two-process gloo group."""
    root = str(tmp_path_factory.mktemp('ring'))
    in_npz = os.path.join(root, 'in.npz')
    np.savez(in_npz, **{f'{name}/{k}': v for name in CASES for k, v in make_case(name).items()})
    return run_group('ring', root, in_npz)[0]


@pytest.mark.parametrize('mesh', ['1x2', '2x1'])
@pytest.mark.parametrize('impl', IMPLS)
@pytest.mark.parametrize('name', list(CASES))
def test_group_matches_jax_ring(jax_results, group_results, name, impl, mesh):
    keys = [f'{mesh}/{name}/{impl}/{t}' for t in ('out', 'dq', 'dk', 'dv')]
    got = tuple(group_results[0][k] for k in keys)
    for shape in JAX_MESHES:
        assert_matches(got, jax_results[shape, name], f'{mesh} group vs JAX {shape}')
    # global out, global gradients: the same on both ranks
    for k in keys:
        np.testing.assert_array_equal(group_results[1][k], group_results[0][k], err_msg=k)


@pytest.mark.parametrize('impl', IMPLS)
def test_fully_masked_slices_are_finite_and_equal(jax_results, group_results, impl):
    """Only the first K/V slice has a valid key: the three fully masked
    slices weigh exactly zero, and their gradients are finite."""
    want = jax_results[(1, 4), 'masked_slices']
    fold = port_fold('masked_slices', impl)
    ring2 = tuple(group_results[0][f'1x2/masked_slices/{impl}/{t}']
                  for t in ('out', 'dq', 'dk', 'dv'))
    for got in (fold, ring2):
        assert all(np.isfinite(t).all() for t in got)
        assert_matches(got, want, 'masked slices')
        # no gradient reaches a key that no query may attend to
        assert not got[2][:, 4:].any() and not got[3][:, 4:].any()


@pytest.mark.parametrize('sq,sk', [(10, 24), (16, 22)])
def test_indivisible_lengths_raise(sq, sk):
    q = torch.zeros(B, sq, H, D)
    kv = torch.zeros(B, sk, H, D)
    with pytest.raises(ValueError, match='must divide the ring size'):
        ring_fold(q, kv, kv, None, n=4)


def test_xla_partials_refuse_a_card_tensor(monkeypatch):
    """impl='xla' runs the plain partials only where ops.use_plain allows."""
    from renderformer_tpu_torch.parallel import ring_attention as ra
    monkeypatch.setattr(ra, 'use_plain', lambda t: False)
    a = make_case('cross')
    with pytest.raises(RuntimeError, match='no library attention'):
        ring_fold(*(torch.from_numpy(a[n]) for n in ('q', 'k', 'v')), None, n=4, impl='xla')



@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_flash_bwd_adds_dq_into_an_fp32_sum(dtype):
    """flash_bwd(..., dq_acc=) adds the unrounded fp32 dQ into the sum it is
    given and returns no dq; dK and dV are those of the plain call."""
    from renderformer_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    g = torch.Generator().manual_seed(7)
    q, do = (torch.randn(2, 16, 2, 32, generator=g).to(dtype) for _ in range(2))
    k, v = (torch.randn(2, 24, 2, 32, generator=g).to(dtype) for _ in range(2))
    mask = torch.rand(2, 24, generator=g) > 0.3
    out, lse = flash_fwd(q, k, v, mask, with_lse=True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    io = (q, k, v, mask, lse, delta, do)
    dq, dk, dv = flash_bwd(*io)
    prior = torch.randn(q.shape, generator=g)
    acc = prior.clone()
    got = flash_bwd(*io, dq_acc=acc)
    assert got[0] is None
    assert torch.equal(got[1], dk) and torch.equal(got[2], dv)
    # in fp32 the sum is exact to rounding; in bf16 dq rounds once, the sum not
    ulp = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -22
    err = float((acc - prior - dq.float()).abs().max())
    assert err <= ulp * float(dq.float().abs().max()) + 1e-6
    with pytest.raises(ValueError, match='dq_acc'):
        flash_bwd(*io, dq_acc=acc.to(torch.float64))
