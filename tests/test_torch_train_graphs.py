"""The train step from CUDA graphs (``training/state.py``: ``StepGraphs``).

On the CPU: the cached device tables that let a step be captured (the NeRF
frequencies, the ray pixel grids) give the bits of their per-call
construction; the gate; the static-input plumbing, with the capture
replaced by a direct call that writes each replay's results into the
captured outputs as a graph's replay does, against eager steps; the
launch counts of a replay; the model's flags set once.  On the card
(marked ``cuda``): the graph path against the eager one, bit for bit under
``deterministic=True`` and within the spread of two eager runs under K8;
the NaN skip; a second batch length; no stream synchronisation in a
replayed step; the memory back when the step is dropped.  This file
imports no JAX, so on a machine with a card and no JAX it runs alone:
``python -m pytest --noconftest -m cuda tests/test_torch_train_graphs.py``.
"""

import dataclasses
import gc
import types

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from renderformer_tpu_torch import RenderFormerConfig
from renderformer_tpu_torch.encodings import nerf
from renderformer_tpu_torch.models.renderformer import RenderFormer
from renderformer_tpu_torch.nn.core import init_weights
from renderformer_tpu_torch.ops import LAUNCHES
from renderformer_tpu_torch.training import state as ts
from renderformer_tpu_torch.utils import rays

TINY = dict(latent_dim=72, num_layers=2, num_heads=2, dim_feedforward=144,
            num_register_tokens=4, vertex_pe_num_freqs=4,
            view_transformer_latent_dim=72, view_transformer_ffn_hidden_dim=144,
            view_transformer_n_heads=2, view_transformer_n_layers=4,
            dpt_features=16, dpt_out_channels=[8, 16, 32, 64])
# head dim 128 on the card, where the kernels take it; Swin: 2x2 windows at 128^2
CARD = dict(latent_dim=256, num_layers=2, num_heads=2, dim_feedforward=256,
            num_register_tokens=4, view_transformer_latent_dim=256,
            view_transformer_ffn_hidden_dim=256, view_transformer_n_heads=2,
            view_transformer_n_layers=4, dpt_features=128,
            dpt_out_channels=[32, 64, 128, 128])
CARD_SWIN = dict(CARD, view_transformer_use_swin_attn=True)
RES, N, V = 32, 8, 2


def _batch(seed=0, n=N, res=RES, views=V, dev='cpu'):
    rng = np.random.default_rng(seed)
    mask = np.ones((1, n), bool)
    mask[:, -2:] = False
    b = {'triangles': rng.normal(size=(1, n, 3, 3)).astype(np.float32) * 0.3,
         'texture': rng.uniform(0, 1, (1, n, 13, 32, 32)).astype(np.float32),
         'mask': mask, 'vn': rng.normal(size=(1, n, 3, 3)).astype(np.float32),
         'c2w': np.tile(np.eye(4, dtype=np.float32), (1, views, 1, 1)),
         'fov': np.full((1, views, 1), 40.0, np.float32),
         'gt': rng.uniform(0, 1, (1, views, res, res, 3)).astype(np.float32)}
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def _model(cfg=TINY, dev='cpu', seed=0):
    model = init_weights(RenderFormer(RenderFormerConfig(**cfg)),
                         torch.Generator().manual_seed(seed))
    return model.to(dev)


def _train(tc, batches, cfg=TINY, dev='cpu'):
    """Steps of ``tc`` over ``batches`` from one seeded init: (metrics, the
    masters and AdamW's moments after them)."""
    model = _model(cfg, dev)
    tx = ts.make_optimizer(tc)
    state = ts.TrainState.create(model, tx, tc)
    step, _ = ts.make_train_step(model, tx, tc)
    metrics = [step(state, b)[1] for b in batches]
    if dev != 'cpu':
        torch.cuda.synchronize()
    moved = ([p.detach().clone() for p in model.parameters()]
             + [t.clone() for k in ('mu', 'nu') for t in state.opt_state[k].values()])
    return metrics, moved


def _direct_capture(phases):
    """``capture_graphs`` without a card: each phase runs once as the
    warm-up and once as the capture, and a replay runs it again and writes
    its results into the capture's outputs, launch counts as they were."""
    for fn in phases:
        fn()
    captured = []
    for fn in phases:
        out = fn()

        def replay(fn=fn, out=out):
            before = dict(LAUNCHES)
            new = fn()
            LAUNCHES.update(before)
            with torch.no_grad():
                for a, b in zip(tree_leaves(out), tree_leaves(new)):
                    a.copy_(b)
        captured.append((out, replay))
    return captured


@pytest.fixture
def direct_graphs(monkeypatch):
    """The graph path on CPU batches, captures made by ``_direct_capture``,
    on one CPU thread (the CPU's kernels thread their sums, so two runs give
    the same bits only on one); yields the list of captures made."""
    calls = []

    def capture(phases, device):
        calls.append(len(phases))
        return _direct_capture(phases)
    monkeypatch.setattr(ts, 'capture_graphs', capture)
    monkeypatch.setattr(ts, 'graphs_apply', lambda tc, model, mesh, batch: tc.cuda_graphs)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield calls
    torch.set_num_threads(threads)


# --------------------------------------------------------------------- tables
def _nerf_per_call(x, num, lo, hi):
    """nerf_encode's frequencies as it built them on every call."""
    freqs = torch.as_tensor(2.0 ** np.linspace(lo, hi, num), dtype=x.dtype, device=x.device)
    scaled = (x[..., None] * freqs).reshape(*x.shape[:-1], -1)
    return torch.sin(torch.cat([scaled, scaled + np.pi / 2.0], dim=-1))


@pytest.mark.parametrize('num,lo,hi,dtype', [(4, 0.0, 3.0, torch.float32),
                                             (6, -1.0, 8.0, torch.float32),
                                             (10, 0.0, 9.0, torch.bfloat16)])
def test_nerf_frequency_table_is_the_per_call_table(num, lo, hi, dtype):
    x = torch.randn(3, 5, 9, generator=torch.Generator().manual_seed(num)).to(dtype)
    got = nerf.nerf_encode(x, num, lo, hi)
    assert torch.equal(got, _nerf_per_call(x, num, lo, hi))
    assert nerf.frequency_table(num, lo, hi, dtype, x.device) is nerf.frequency_table(
        num, lo, hi, dtype, x.device)


def _rays_per_call(c2w, fov, res):
    c2w, fov = c2w.float(), fov.float()
    batch = c2w.shape[:-2]
    lin = np.linspace(0.5, res - 0.5, res, dtype=np.float32)
    xs, ys = np.meshgrid(lin, lin, indexing='xy')
    bcast = (1,) * len(batch)
    x = torch.from_numpy(xs).to(c2w.device).reshape(bcast + xs.shape)
    y = torch.from_numpy(ys).to(c2w.device).reshape(bcast + ys.shape)
    c = res / 2.0
    f = res / 2.0 / torch.tan(0.5 * fov[..., 0, None, None])
    dirs = torch.stack([(x - c) / f, -(y - c) / f, -torch.ones_like(x * f)], dim=-1)
    d = torch.einsum('...ij,...hwj->...hwi', c2w[..., :3, :3], dirs)
    return c2w[..., :3, 3], d / torch.linalg.norm(d, dim=-1, keepdim=True)


def _rays_patched_per_call(c2w, fov, res, p):
    c2w, fov = c2w.float(), fov.float()
    hp = res // p
    tok, lane = np.arange(hp * hp), np.arange(p * p)
    pix_y = torch.from_numpy(((tok // hp)[:, None] * p + lane[None, :] // p + 0.5)
                             .astype(np.float32))
    pix_x = torch.from_numpy(((tok % hp)[:, None] * p + lane[None, :] % p + 0.5)
                             .astype(np.float32))
    c = res / 2.0
    f = res / 2.0 / torch.tan(0.5 * fov[..., 0, None, None])
    xd, yd = (pix_x - c) / f, -(pix_y - c) / f
    R = c2w[..., :3, :3]
    w = [R[..., i, 0, None, None] * xd + R[..., i, 1, None, None] * yd
         - R[..., i, 2, None, None] for i in range(3)]
    nrm = torch.sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2])
    return c2w[..., :3, 3], torch.cat([w[0] / nrm, w[1] / nrm, w[2] / nrm], dim=-1)


def _cameras(seed, views=3):
    g = torch.Generator().manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn(views, 3, 3, generator=g))
    c2w = torch.eye(4).repeat(1, views, 1, 1)
    c2w[0, :, :3, :3] = q
    c2w[0, :, :3, 3] = torch.randn(views, 3, generator=g)
    fov = (torch.rand(1, views, 1, generator=g) * 30 + 30) / 180.0 * np.pi
    return c2w, fov


@pytest.mark.parametrize('res', [16, 64, 96])
def test_ray_pixel_grid_is_the_per_call_grid(res):
    c2w, fov = _cameras(res)
    for got, want in zip(rays.generate_rays(c2w, fov, res), _rays_per_call(c2w, fov, res)):
        assert torch.equal(got, want)


@pytest.mark.parametrize('res,p', [(32, 8), (64, 8), (48, 16)])
def test_patched_ray_pixel_grid_is_the_per_call_grid(res, p):
    c2w, fov = _cameras(res + p)
    for got, want in zip(rays.generate_rays_patched(c2w, fov, res, p),
                         _rays_patched_per_call(c2w, fov, res, p)):
        assert torch.equal(got, want)


def test_tables_made_under_inference_mode_serve_autograd():
    """A table first made by a render (inference mode) is no inference
    tensor: a train step's autograd may save it."""
    with torch.inference_mode():
        nerf.frequency_table(5, 0.0, 4.0, torch.float32, torch.device('cpu'))
        rays.pixel_grid(24, torch.device('cpu'))
    x = torch.randn(2, 3, requires_grad=True)
    nerf.nerf_encode(x, 5, 0.0, 4.0).sum().backward()
    c2w, fov = _cameras(1)
    c2w.requires_grad_(True)
    rays.generate_rays(c2w, fov, 24)[1].sum().backward()
    assert x.grad is not None and c2w.grad is not None


# ----------------------------------------------------------------------- gate
def _cuda_like(batch):
    return {k: types.SimpleNamespace(is_cuda=True) for k in batch}


@pytest.mark.parametrize('case', ['cpu_batch', 'mesh', 'dropout', 'debug_nans', 'shadow',
                                  'off'])
def test_gate_chooses_eager(case):
    tc = ts.TrainConfig(**{'debug_nans': case == 'debug_nans',
                           'bf16_shadow_params': case == 'shadow',
                           'cuda_graphs': case != 'off'})
    model = _model(dict(TINY, dropout=0.1 if case == 'dropout' else 0.0))
    batch = _batch() if case == 'cpu_batch' else _cuda_like(_batch())
    mesh = object() if case == 'mesh' else None
    assert not ts.graphs_apply(tc, model, mesh, batch)
    assert ts.graphs_apply(ts.TrainConfig(), _model(), None, _cuda_like(_batch()))


# ------------------------------------------------------------- static inputs
FP32 = dict(precision='float32', view_precision='float32', resolution=RES,
            learning_rate=1e-3, steps_per_epoch=10, num_epochs=1, remat=True)


def _same(a, b):
    """The same metrics (NaN where the other has NaN) and the same bits of
    every master and moment."""
    (ma, pa), (mb, pb) = a, b
    np.testing.assert_array_equal([[m['loss'], m['grad_norm']] for m in ma],
                                  [[m['loss'], m['grad_norm']] for m in mb])
    assert len(pa) == len(pb) and all(torch.equal(x, y) for x, y in zip(pa, pb))


def test_static_inputs_give_eager_steps(direct_graphs):
    """Three steps over two batches in turn through the static inputs: the
    losses, norms, masters and moments of eager steps, with one capture."""
    batches = [_batch(0), _batch(1), _batch(0)]
    tc = ts.TrainConfig(**FP32)
    graphed = _train(tc, batches)
    assert direct_graphs == [2]
    _same(graphed, _train(dataclasses.replace(tc, cuda_graphs=False), batches))


def test_new_batch_length_gets_its_own_capture(direct_graphs):
    """Batches of two lengths in turn: one capture each, each step the eager
    step; a third length, past MAX_SIGNATURES, runs eager."""
    batches = [_batch(0), _batch(1, n=12), _batch(2), _batch(3, n=12), _batch(4, n=10)]
    tc = ts.TrainConfig(**FP32)
    graphed = _train(tc, batches)
    assert direct_graphs == [2] * ts.MAX_SIGNATURES
    _same(graphed, _train(dataclasses.replace(tc, cuda_graphs=False), batches))


def test_moved_masters_capture_anew(direct_graphs):
    """Masters put in place by a load with ``assign`` are read where they
    now lie: the step captures again, and is the eager step."""
    tc = ts.TrainConfig(**FP32)
    runs = []
    for graphs in (True, False):
        model = _model()
        tx = ts.make_optimizer(tc)
        state = ts.TrainState.create(model, tx, tc)
        step, _ = ts.make_train_step(model, tx, dataclasses.replace(tc, cuda_graphs=graphs))
        step(state, _batch(0))
        model.load_state_dict({k: v.clone() for k, v in model.state_dict().items()},
                              assign=True)
        runs.append((step(state, _batch(1))[1], [p.detach().clone()
                                                 for p in model.parameters()]))
    assert direct_graphs == [2, 2]
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_replays_count_the_captured_launches(direct_graphs):
    """The warm-up and the capture leave ``ops.LAUNCHES`` as it was; each
    replay adds the launches counted during the capture."""
    w = torch.nn.Parameter(torch.ones(3))
    state = types.SimpleNamespace(model=torch.nn.Module())
    state.model.w = w

    def forward(state, batch):
        LAUNCHES['rms_norm_fwd'] += 2
        return (batch['gt'] * state.model.w).square().sum()

    def backward(state, loss):
        LAUNCHES['rms_norm_bwd'] += 1
        return list(torch.autograd.grad(loss, [state.model.w]))

    graphs = ts.StepGraphs(ts.TrainConfig(), forward, backward)
    before = dict(LAUNCHES)
    for k in range(3):
        gt = torch.full((3,), float(k + 1))
        loss, (g,) = graphs(state, {'gt': gt})
        assert float(loss) == 3 * (k + 1) ** 2 and torch.equal(g, 2 * gt * gt)
        assert LAUNCHES['rms_norm_fwd'] - before['rms_norm_fwd'] == 2 * (k + 1)
        assert LAUNCHES['rms_norm_bwd'] - before['rms_norm_bwd'] == k + 1
    assert direct_graphs == [2]


def test_model_flags_are_set_once(monkeypatch):
    """``remat`` and ``fused_norm`` are set when the step is built, not at
    every step (the ``fused_norm`` setter walks every module)."""
    sets = []
    for name in ('remat', 'fused_norm'):
        prop = getattr(RenderFormer, name)

        def setter(self, on, prop=prop, name=name):
            sets.append(name)
            prop.fset(self, on)
        monkeypatch.setattr(RenderFormer, name, property(prop.fget, setter))
    tc = ts.TrainConfig(**FP32)
    model = _model()
    tx = ts.make_optimizer(tc)
    state = ts.TrainState.create(model, tx, tc)
    step, eval_step = ts.make_train_step(model, tx, tc)
    assert sorted(sets) == ['fused_norm', 'remat'] and model.remat
    for b in (_batch(0), _batch(1)):
        step(state, b)
    eval_step(state, _batch(2))
    assert sorted(sets) == ['fused_norm', 'remat']


# ------------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


CARD_TC = dict(precision='bfloat16', resolution=128, learning_rate=1e-4, remat=True,
               steps_per_epoch=100)


def _card_batches(dev, ns=(40, 40, 40), seeds=(0, 1, 2)):
    return [_batch(s, n=n, res=128, views=1, dev=dev) for s, n in zip(seeds, ns)]


@pytest.mark.cuda
@pytest.mark.parametrize('cfg', [CARD, CARD_SWIN], ids=['full', 'swin'])
def test_graphs_are_the_eager_steps_bit_for_bit(cuda, cfg):
    """deterministic=True (K9, deterministic cuDNN): three steps over three
    batches, replayed and eager, give the same bits of every loss, norm,
    master and moment, and count the same launches."""
    tc = ts.TrainConfig(**CARD_TC, deterministic=True)
    batches = _card_batches(cuda)
    runs = []
    for graphs in (True, False):
        before = dict(LAUNCHES)
        out = _train(dataclasses.replace(tc, cuda_graphs=graphs), batches, cfg, cuda)
        runs.append((out, {k: LAUNCHES[k] - before[k] for k in LAUNCHES}))
        del out
    (graphed, gl), (eager, el) = runs
    assert len(graphed[0]) == 3
    _same(graphed, eager)
    assert gl == el and gl['flash_bwd_dq'] > 0


def _worst_gap(a, b) -> float:
    """The widest relative L2 gap of a run's metrics, masters and moments
    (``_train``'s first two) from another's, over every number and tensor."""
    xs = [torch.tensor([m['loss'], m['grad_norm']]) for m in a[0]] + a[1]
    ys = [torch.tensor([m['loss'], m['grad_norm']]) for m in b[0]] + b[1]
    return max(float(torch.linalg.vector_norm((x.double() - y.double()).cpu())
                     / max(float(torch.linalg.vector_norm(y.double().cpu())), 1e-30))
               for x, y in zip(xs, ys))


@pytest.mark.cuda
def test_graphs_are_the_eager_steps_within_k8_spread(cuda):
    """The default backward K8 sums dQ by atomics: the replayed steps' widest
    gap from an eager run is within twice the widest gap between three eager
    runs (or 1e-5, where the eager runs happen to agree)."""
    tc = ts.TrainConfig(**CARD_TC)
    batches = _card_batches(cuda)
    eager = [_train(dataclasses.replace(tc, cuda_graphs=False), batches, CARD, cuda)
             for _ in range(3)]
    graphed = _train(tc, batches, CARD, cuda)
    spread = max(_worst_gap(eager[i], eager[j]) for i in range(3) for j in range(i))
    assert _worst_gap(graphed, eager[0]) <= max(2 * spread, 1e-5)


@pytest.mark.cuda
def test_nan_batch_is_skipped_under_graphs_as_eager(cuda):
    """A NaN in ``gt``: the replayed step reads a NaN loss and leaves the
    masters, the moments and AdamW's count as the eager step does."""
    tc = ts.TrainConfig(**CARD_TC, deterministic=True)
    batches = _card_batches(cuda)
    batches[1]['gt'][0, 0, 3, 5, 1] = float('nan')
    runs = [_train(dataclasses.replace(tc, cuda_graphs=g), batches, CARD, cuda)
            for g in (True, False)]
    for metrics, _ in runs:
        assert np.isnan(metrics[1]['loss']) and np.isfinite(metrics[2]['loss'])
    _same(runs[0], runs[1])


@pytest.mark.cuda
def test_second_padded_length_gets_its_own_graphs(cuda):
    """Two triangle counts in turn: each replays its own capture and is the
    eager step."""
    tc = ts.TrainConfig(**CARD_TC, deterministic=True)
    batches = _card_batches(cuda, ns=(40, 48, 40, 48), seeds=(0, 1, 2, 3))
    runs = [_train(dataclasses.replace(tc, cuda_graphs=g), batches, CARD_SWIN, cuda)
            for g in (True, False)]
    _same(runs[0], runs[1])


@pytest.mark.cuda
def test_replayed_step_takes_no_synchronisation(cuda):
    """From the batch's copy into the static inputs to the global norm, a
    replayed step makes no call that waits for the device."""
    tc = ts.TrainConfig(**CARD_TC)
    model = _model(CARD_SWIN, cuda)
    tx = ts.make_optimizer(tc)
    state = ts.TrainState.create(model, tx, tc)
    _, loss_and_grads, forward, backward = ts._loss_fns(model, tc)
    graphs = ts.StepGraphs(tc, forward, backward)
    batches = _card_batches(cuda)
    graphs(state, batches[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        loss, grads = graphs(state, batches[1])
        gnorm = ts.global_norm(grads)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want_loss, want = loss_and_grads(state, batches[1])
    assert float(loss) == float(want_loss)
    assert float(gnorm) == pytest.approx(float(ts.global_norm(want)), rel=1e-3)


@pytest.mark.cuda
def test_dropped_step_returns_its_memory(cuda):
    """The graphs, their pool and the static buffers belong to the step:
    once it is dropped the memory it took comes back."""
    tc = ts.TrainConfig(**CARD_TC)
    model = _model(CARD_SWIN, cuda)
    tx = ts.make_optimizer(tc)
    state = ts.TrainState.create(model, tx, tc)
    batches = _card_batches(cuda)
    # the cached tables, the kernels' first loads and the capture stream's
    # cuBLAS workspace, which live as long as the process, outside the count
    ts.make_train_step(model, tx, tc)[0](state, batches[0])
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    base, base_reserved = torch.cuda.memory_allocated(cuda), torch.cuda.memory_reserved(cuda)
    step, _ = ts.make_train_step(model, tx, tc)
    for b in batches:
        step(state, b)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(cuda) - base
    assert held > 0
    del step
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated(cuda) <= base
    # within one of the allocator's large segments (20 MiB) of where it was
    assert torch.cuda.memory_reserved(cuda) <= base_reserved + 20 * 2 ** 20
