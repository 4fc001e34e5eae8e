"""The split-TF32 product of the port's fp32 linears (``ops/gemm_tf32x3.py``,
``csrc/gemm_tf32x3.cu``) and its route (``nn/core.py:linear``).

On the CPU: the plain version's TF32 split (ties, signs, subnormals, inf and
NaN), hi + lo against x, its product against float64 and against
single-pass TF32 emulated the same way, the kernel's work plan, the route's
gate, and a CPU render through the route bit for bit with ``F.linear``.

Marked ``cuda`` (they skip without a card): the kernel's forward, dX and dW
at the shapes of the v1.1-swin-large fine-tune step's view stage and at a
ragged M with bias, against the plain version and float64, its error beside
torch's fp32 product with TF32 off and single-pass TF32; a CUDA-graph
capture and replay; the same bits in two runs; refusals.  This file imports
no JAX, so on a machine with a card and no JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_gemm_tf32x3.py
"""

import collections
import os
import sys
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from renderformer_tpu_torch.nn import attention, core
from renderformer_tpu_torch.ops import LAUNCHES, gemm_tf32x3 as g3
from renderformer_tpu_torch.ops.gemm_tf32x3 import (
    gemm_tf32x3_dgrad, gemm_tf32x3_fwd, gemm_tf32x3_plain, gemm_tf32x3_wgrad, plan,
    tf32_split, tf32x3_linear, tf32x3_linear_supported)


def _bits(*words):
    return torch.tensor(np.array(words, dtype=np.uint32).view(np.int32)).view(torch.float32)


def _u32(t):
    return t.view(torch.int32).numpy().view(np.uint32)


def _rel_rms(got, ref):
    ref = ref.double()
    return float((got.double() - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())


# ---------------------------------------------------------------- CPU


def test_split_rounds_to_nearest_ties_away_from_zero():
    # 1 + m * 2^-23 with the 13 dropped bits below, at, just above half
    x = _bits(0x3F800FFF, 0x3F801000, 0x3F801001, 0x3F803000, 0x3F807FFF,
              0xBF801000, 0xBF800FFF, 0x3FFFF000)
    hi, lo = tf32_split(x)
    assert list(_u32(hi)) == [0x3F800000, 0x3F802000, 0x3F802000, 0x3F804000, 0x3F808000,
                              0xBF802000, 0xBF800000, 0x40000000]
    assert not (_u32(hi) & 0x1FFF).any() and not (_u32(lo) & 0x1FFF).any()


def test_split_is_odd_in_the_sign():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32))
    hi, lo = tf32_split(x)
    nhi, nlo = tf32_split(-x)
    assert torch.equal(nhi, -hi) and torch.equal(nlo, -lo)


def test_split_of_subnormals():
    x = _bits(0x00000FFF, 0x00001000, 0x00003000, 0x007FF000, 0x007FFFFF, 0x80001000,
              0x00000001)
    hi, lo = tf32_split(x)
    # the same bit rounding; the largest subnormals round up into the normals
    assert list(_u32(hi)) == [0, 0x00002000, 0x00004000, 0x00800000, 0x00800000,
                              0x80002000, 0]
    # lo is a multiple of TF32's subnormal spacing 2^-136, so hi + lo misses
    # x by less than that
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err < 2.0 ** -136).all())


def test_split_passes_inf_and_nan_through():
    x = _bits(0x7F800000, 0xFF800000, 0x7FC00000, 0x7F800001, 0xFFFFFFFF, 0x7F7FFFFF)
    hi, lo = tf32_split(x)
    assert torch.isinf(hi[:2]).all() and torch.equal(hi[:2], x[:2])
    assert torch.isnan(hi[2:5]).all()
    # the largest finite float rounds to inf in TF32, as to-nearest rounding does
    assert float(hi[5]) == float('inf')
    assert torch.equal(lo, torch.zeros_like(lo))


def test_hi_plus_lo_within_2_pow_minus_21():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=1 << 16) * 2.0 ** rng.integers(-100, 100, size=1 << 16))
    x = torch.from_numpy(x.astype(np.float32))
    hi, lo = tf32_split(x)
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err < 2.0 ** -21 * x.double().abs()).all())
    assert bool(((x.double() - hi.double()).abs() <= 2.0 ** -11 * x.double().abs()).all())


@pytest.mark.parametrize('m,n,k', [(64, 96, 1024), (37, 40, 300)])
def test_plain_product_against_float64_and_single_pass_tf32(m, n, k):
    rng = np.random.default_rng(m)
    a = torch.from_numpy(rng.normal(size=(m, k)))
    b = torch.from_numpy(rng.normal(size=(n, k)))
    ref = a @ b.t()
    err = _rel_rms(gemm_tf32x3_plain(a.float(), b.float()), ref)
    ah, _ = tf32_split(a.float())
    bh, _ = tf32_split(b.float())
    err1 = _rel_rms(ah @ bh.t(), ref)
    # fp32's own rounding of the sums: 2.9e-7 at k = 1024 (fp32 product: the same)
    assert err < 5e-7
    assert _rel_rms(a.float() @ b.float().t(), ref) > 0.5 * err
    # single-pass TF32 misses by ~1e3 times more (1041x at k = 1024, seed 64)
    assert err1 > 500 * err


def test_plan_fills_the_card_at_the_step_shapes():
    # forward and dX of the 1024-wide projections and the FFN: tiles enough
    assert plan(4096, 1024, 1024, 132) == (1, 132)
    assert plan(4112, 1024, 1024, 132) == (1, 132)
    assert plan(4096, 4096, 1024, 132) == (1, 132)
    assert plan(4096, 1024, 4096, 132) == (1, 132)
    # dW of a 1024 x 1024 projection: 64 tiles, the token reduction in two
    assert plan(1024, 1024, 4096, 132) == (2, 128)
    assert plan(1024, 1024, 4112, 132) == (2, 128)
    # a small product: one tile, too short to split
    assert plan(64, 64, 64, 132) == (1, 1)
    # a fp32 render's texture encoder at 300 triangles: 18 tiles over 13,312
    assert plan(300, 768, 13312, 132) == (7, 126)
    for m, n, k in [(1024, 1024, 4112), (128, 256, 8000), (100, 100, 300)]:
        splits, grid = plan(m, n, k, 132)
        blocks = -(-k // g3.BK)
        assert 1 <= splits <= max(1, blocks // g3.MIN_SPLIT_BLOCKS)
        assert grid <= 132


@pytest.mark.parametrize('product,shapes', [
    ('fwd', [(5, 8), (4, 12)]), ('fwd', [(5, 8), (4, 8), (5,)]), ('fwd', [(2, 5, 8), (4, 8)]),
    ('dgrad', [(5, 4), (8, 12)]), ('wgrad', [(5, 4), (6, 8)])])
def test_ops_refuse_operands_whose_shapes_disagree(product, shapes):
    ops = {'fwd': gemm_tf32x3_fwd, 'dgrad': gemm_tf32x3_dgrad, 'wgrad': gemm_tf32x3_wgrad}
    with pytest.raises(ValueError, match='do not agree'):
        ops[product](*(torch.zeros(s) for s in shapes))


def _fake(shape, dtype=torch.float32, cuda=True):
    """The attributes the gate reads of a tensor, on a 'device' of choice."""
    return types.SimpleNamespace(is_cuda=cuda, dtype=dtype, shape=torch.Size(shape),
                                 dim=lambda: len(shape),
                                 numel=lambda: int(np.prod(shape)))


@pytest.mark.parametrize('case,want', [
    ('cuda_fp32', True), ('cpu', False), ('bf16', False), ('tf32_allowed', False),
    ('k_misaligned', False), ('n_misaligned', False), ('bias_bf16', False),
    ('empty', False)])
def test_route_gate(monkeypatch, case, want):
    x, w, b = _fake((5, 7, 64)), _fake((96, 64)), None
    if case == 'cpu':
        x = _fake((5, 7, 64), cuda=False)
    elif case == 'bf16':
        x, w = _fake((5, 7, 64), torch.bfloat16), _fake((96, 64), torch.bfloat16)
    elif case == 'tf32_allowed':
        monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', True)
    elif case == 'k_misaligned':
        x, w = _fake((5, 7, 66)), _fake((96, 66))
    elif case == 'n_misaligned':
        w = _fake((98, 64))
    elif case == 'bias_bf16':
        b = _fake((96,), torch.bfloat16)
    elif case == 'empty':
        x = _fake((0, 64))
    if case != 'tf32_allowed':
        monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    assert tf32x3_linear_supported(x, w, b) is want


@pytest.mark.parametrize('supported', [False, True])
def test_route_takes_the_kernel_only_past_the_gate(monkeypatch, supported):
    calls = []
    monkeypatch.setattr(core, 'tf32x3_linear_supported', lambda *a: supported)
    monkeypatch.setattr(core, 'tf32x3_linear', lambda *a: calls.append('kernel') or a[0])
    monkeypatch.setattr(core.F, 'linear', lambda *a: calls.append('F.linear') or a[0])
    lin = core.Linear(8, 4, bias=False)
    lin(torch.zeros(2, 8))
    attention._split_in_proj(torch.zeros(2, 8), core.Linear(8, 24, bias=True), 8)
    assert calls == ['kernel' if supported else 'F.linear'] * 4


def test_cpu_render_through_the_route_is_f_linear_bit_for_bit(monkeypatch):
    from renderformer_tpu_torch import RenderFormerConfig, RenderingPipeline
    cfg = RenderFormerConfig(latent_dim=72, num_layers=2, num_heads=2, dim_feedforward=144,
                             num_register_tokens=4, vertex_pe_num_freqs=4,
                             view_transformer_latent_dim=72,
                             view_transformer_ffn_hidden_dim=144, view_transformer_n_heads=2,
                             view_transformer_n_layers=4, dpt_features=16,
                             dpt_out_channels=[8, 16, 32, 64])
    pipe = RenderingPipeline.from_config(cfg, seed=0, device='cpu')
    rng = np.random.default_rng(0)
    n, v = 8, 2
    args = (rng.normal(size=(1, n, 3, 3)).astype(np.float32) * 0.3,
            rng.uniform(0, 1, (1, n, 13, 32, 32)).astype(np.float32), np.ones((1, n), bool),
            rng.normal(size=(1, n, 3, 3)).astype(np.float32),
            np.tile(np.eye(4, dtype=np.float32), (1, v, 1, 1)),
            np.full((1, v, 1), 40.0, np.float32))
    routed = pipe.render(*args, resolution=64, precision='fp32')
    calls = []

    def plain_linear(x, w, b=None):
        calls.append(1)
        return F.linear(x, w, b)

    monkeypatch.setattr(core, 'linear', plain_linear)
    monkeypatch.setattr(attention, 'linear', plain_linear)
    direct = pipe.render(*args, resolution=64, precision='fp32')
    assert calls and torch.equal(routed, direct)


@pytest.mark.parametrize('bias', [False, True])
def test_op_gradients_on_the_cpu_against_float64(bias):
    # the autograd Function through the plain versions (a CPU tensor)
    rng = np.random.default_rng(3)
    x64 = torch.from_numpy(rng.normal(size=(3, 37, 64))).requires_grad_()
    w64 = torch.from_numpy(rng.normal(size=(40, 64))).requires_grad_()
    b64 = torch.from_numpy(rng.normal(size=40)).requires_grad_() if bias else None
    gy = torch.from_numpy(rng.normal(size=(3, 37, 40)))
    x, w = x64.detach().float().requires_grad_(), w64.detach().float().requires_grad_()
    b = b64.detach().float().requires_grad_() if bias else None
    y = tf32x3_linear(x, w, b)
    y.backward(gy.float())
    F.linear(x64, w64, b64).backward(gy)
    assert _rel_rms(y.detach(), F.linear(x64, w64, b64).detach()) < 5e-7
    assert _rel_rms(x.grad, x64.grad) < 5e-7
    assert _rel_rms(w.grad, w64.grad) < 5e-7
    if bias:
        assert _rel_rms(b.grad, b64.grad) < 5e-7


def _record_route(monkeypatch):
    """Send CPU fp32 linears whose widths pass the gate through the op (its
    plain versions), and count each product at (M tokens, N out, K in,
    bias)."""
    seen = collections.Counter()
    monkeypatch.setattr(core, 'tf32x3_linear_supported', lambda x, w, b=None: (
        x.dtype == torch.float32 and w.dtype == torch.float32 and w.shape[0] % 4 == 0
        and w.shape[1] % 4 == 0))
    fwd, dgrad, wgrad = g3.gemm_tf32x3_fwd, g3.gemm_tf32x3_dgrad, g3.gemm_tf32x3_wgrad

    def rec_fwd(x, w, b=None):
        seen['fwd', x.shape[0], w.shape[0], w.shape[1], b is not None] += 1
        return fwd(x, w, b)

    def rec_dgrad(gy, w):
        seen['dgrad', gy.shape[0], w.shape[0], w.shape[1], False] += 1
        return dgrad(gy, w)

    def rec_wgrad(gy, x):
        seen['wgrad', gy.shape[0], gy.shape[1], x.shape[1], False] += 1
        return wgrad(gy, x)

    monkeypatch.setattr(g3, 'gemm_tf32x3_fwd', rec_fwd)
    monkeypatch.setattr(g3, 'gemm_tf32x3_dgrad', rec_dgrad)
    monkeypatch.setattr(g3, 'gemm_tf32x3_wgrad', rec_wgrad)
    return seen


@pytest.mark.parametrize('case', ['train_remat', 'train_swin', 'render_fp32'])
def test_chip_smoke_gemm_sites_are_the_models_linears(monkeypatch, case):
    """chip_smoke.py's count of the GEMM's launches at each shape, from the
    configuration alone, against what a tiny model sends through the route."""
    from renderformer_tpu_torch import RenderFormerConfig, RenderingPipeline
    from renderformer_tpu_torch.models.renderformer import RenderFormer
    from renderformer_tpu_torch.training.state import (
        TrainConfig, TrainState, make_optimizer, make_train_step)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    swin = case == 'train_swin'
    cfg = RenderFormerConfig(
        latent_dim=72, num_layers=2, num_heads=2, dim_feedforward=144, num_register_tokens=4,
        vertex_pe_num_freqs=4, view_transformer_latent_dim=72,
        view_transformer_ffn_hidden_dim=144, view_transformer_n_heads=2,
        view_transformer_n_layers=4, dpt_features=16, dpt_out_channels=[8, 16, 32, 64],
        view_transformer_use_swin_attn=swin)
    res, n = (128 if swin else 64), 8
    rng = np.random.default_rng(0)
    scene = dict(triangles=rng.normal(size=(1, n, 3, 3)).astype(np.float32) * 0.3,
                 texture=rng.uniform(0, 1, (1, n, 13, 32, 32)).astype(np.float32),
                 mask=np.ones((1, n), bool), vn=rng.normal(size=(1, n, 3, 3)).astype(np.float32),
                 c2w=np.tile(np.eye(4, dtype=np.float32), (1, 1, 1, 1)),
                 fov=np.full((1, 1, 1), 40.0, np.float32))
    seen = _record_route(monkeypatch)
    if case == 'render_fp32':
        pipe = RenderingPipeline.from_config(cfg, seed=0, device='cpu')
        pipe.render(*scene.values(), resolution=res, precision='fp32')
        want = chip_smoke.gemm_sites(cfg, res, n, stage1=True)
    else:
        model = core.init_weights(RenderFormer(cfg), torch.Generator().manual_seed(0))
        tc = TrainConfig(precision='bfloat16', resolution=res, remat=True, num_epochs=1)
        tx = make_optimizer(tc)
        step, _ = make_train_step(model, tx, tc)
        batch = {k: torch.from_numpy(v) for k, v in scene.items()}
        batch['gt'] = torch.from_numpy(rng.uniform(0, 1, (1, 1, res, res, 3)).astype(np.float32))
        step(TrainState.create(model, tx, tc), batch)
        want = chip_smoke.gemm_sites(cfg, res, n, train=True, remat=True)
    assert dict(seen) == want


def test_chip_smoke_expected_gemm_launches_sum_its_sites():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as c
    expected = {**c.EXPECTED_LAUNCHES, **c.PRECISION_LAUNCHES, c.OVERFIT: c.OVERFIT_LAUNCHES}
    for path, sites in c.gemm_paths().items():
        total = collections.Counter()
        for (product, *_), n in sites.items():
            total[f'gemm_tf32x3_{product}'] += n
        assert {k: expected[path][k] for k in total} == dict(total), path
    assert all(v == 0 for k, v in c.EXPECTED_LAUNCHES[c.SWIN].items() if k.startswith('gemm'))


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    return torch.device('cuda')


def _randn(shape, dev, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).to(dev)


# (M tokens, N out, K in) of the v1.1-swin-large step's view-stage linears:
# the 1024-wide projections (q, in_proj's three, both out_proj), the
# cross-attention's k and v over 4,112 stage-1 tokens, the FFN's w1/w3 and w2
STEP_SHAPES = [(4096, 1024, 1024), (4112, 1024, 1024), (4096, 4096, 1024),
               (4096, 1024, 4096)]
# ragged M with bias; small tiles; M of 1; a short reduction; and a few
# tiles over a long reduction with bias (a fp32 render's texture encoder
# at a few hundred triangles), whose reduction the plan splits
EDGE_SHAPES = [(4112, 1024, 1024, True), (100, 36, 200, True), (1, 8, 4, False),
               (300, 1000, 44, True), (300, 768, 13312, True)]


def _check_against_float64(got, a, b, bias=None, step=True):
    """got = a b^T (+ bias): its RMS error against float64 is at least 50
    times below single-pass TF32's (the operands rounded to TF32, the
    products and sums exact: the most that single pass can do) and, at the
    step's shapes (a reduction of 1,024 or more, where the sums' rounding
    leads both), at most twice torch's fp32 product's (TF32 off); and it is
    the plain version's arithmetic, to the two's rounding of their sums."""
    bias64 = 0 if bias is None else bias.double()
    ref = a.double() @ b.double().t() + bias64
    err = _rel_rms(got, ref)
    err32 = _rel_rms(a @ b.t() + (0 if bias is None else bias), ref)
    ah, bh = tf32_split(a)[0], tf32_split(b)[0]
    err_tf32 = _rel_rms(ah.double() @ bh.double().t() + bias64, ref)
    assert not step or err <= 2 * err32, (err, err32)
    assert err * 50 <= err_tf32, (err, err_tf32)
    plain = gemm_tf32x3_plain(a, b, bias)
    assert _rel_rms(got, plain) <= 2 * (err + _rel_rms(plain, ref)), (err, _rel_rms(plain, ref))


@pytest.mark.cuda
@pytest.mark.parametrize('shape', STEP_SHAPES + EDGE_SHAPES)
@pytest.mark.parametrize('product', ['fwd', 'dgrad', 'wgrad'])
def test_kernel_matches_plain_and_float64(cuda, shape, product):
    m, n, k = shape[:3]
    step = len(shape) == 3
    bias = _randn((n,), cuda, 3) if len(shape) > 3 and shape[3] and product == 'fwd' else None
    x, w, gy = _randn((m, k), cuda, 0), _randn((n, k), cuda, 1), _randn((m, n), cuda, 2)
    before = dict(LAUNCHES)
    if product == 'fwd':
        got = gemm_tf32x3_fwd(x, w, bias)
        _check_against_float64(got, x, w, bias, step)
    elif product == 'dgrad':
        got = gemm_tf32x3_dgrad(gy, w)
        _check_against_float64(got, gy, w.t(), step=step)
    else:
        got = gemm_tf32x3_wgrad(gy, x)
        _check_against_float64(got, gy.t(), x.t(), step=step)
    torch.cuda.synchronize()
    assert {k_: LAUNCHES[k_] - before[k_] for k_ in LAUNCHES if LAUNCHES[k_] != before[k_]} \
        == {f'gemm_tf32x3_{product}': 1}


@pytest.mark.cuda
def test_linear_route_and_gradients_on_the_card(cuda):
    x = _randn((2, 2056, 1024), cuda, 4).requires_grad_()
    lin = core.Linear(1024, 512, bias=True).to(cuda)
    before = dict(LAUNCHES)
    y = lin(x)
    gy = _randn(tuple(y.shape), cuda, 5)
    y.backward(gy)
    torch.cuda.synchronize()
    assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]} == {
        'gemm_tf32x3_fwd': 1, 'gemm_tf32x3_dgrad': 1, 'gemm_tf32x3_wgrad': 1}
    x64, w64 = x.detach().double().requires_grad_(), lin.weight.detach().double()
    w64.requires_grad_()
    b64 = lin.bias.detach().double().requires_grad_()
    F.linear(x64, w64, b64).backward(gy.double())
    for got, want in ((x.grad, x64.grad), (lin.weight.grad, w64.grad), (lin.bias.grad, b64.grad)):
        assert _rel_rms(got, want) < 2e-6
    # with TF32 allowed, bf16, or on the CPU the route is F.linear
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        assert not tf32x3_linear_supported(x, lin.weight)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert not tf32x3_linear_supported(x.bfloat16(), lin.weight.bfloat16())


@pytest.mark.cuda
def test_kernel_same_bits_in_two_runs_and_under_a_cuda_graph(cuda):
    x, w = _randn((4112, 1024), cuda, 6), _randn((1024, 1024), cuda, 7)
    gy = _randn((4112, 1024), cuda, 8)

    def products():
        return (gemm_tf32x3_fwd(x, w), gemm_tf32x3_dgrad(gy, w), gemm_tf32x3_wgrad(gy, x))

    first, second = products(), products()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        products()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = products()
    for out in captured:
        out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for a, b, c in zip(first, second, captured):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    x, w = _randn((64, 64), cuda, 9), _randn((32, 64), cuda, 10)
    with pytest.raises(ValueError):
        gemm_tf32x3_fwd(x.double(), w)
    with pytest.raises(ValueError):
        gemm_tf32x3_fwd(x[:, 1:63], w[:, 1:63])      # not contiguous
    with pytest.raises(RuntimeError):
        gemm_tf32x3_fwd(x[:, :62].contiguous(), w[:, :62].contiguous())  # K % 4
