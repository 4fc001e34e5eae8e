"""Kernels K5 (resize into space-to-depth layout), K6 (Swin window
attention) and K7 (shifted-window regroup) against their plain versions on
a CUDA card, at small sizes.  They skip without one.  This file imports no
JAX, so on a machine with a card and no JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from renderformer_tpu_torch.ops import LAUNCHES, reference_kernels
from renderformer_tpu_torch.ops.fused_resize import resize_s2d
from renderformer_tpu_torch.ops.shifted_regroup import shifted_regroup
from renderformer_tpu_torch.ops.swin_attention import region_table, swin_window_attention

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _randn(shape, dtype, dev, seed=0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).to(dev).to(dtype)


def _both(fn):
    """(kernel result, plain result, kernel launches)."""
    with torch.no_grad():
        before = dict(LAUNCHES)
        got = fn()
        torch.cuda.synchronize()
        launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
        with reference_kernels():
            want = fn()
    return got, want, launched


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
def test_resize_s2d_kernel_matches_plain(cuda, dtype):
    x = _randn((2, 12, 20, 64), dtype, cuda)
    got, want, launched = _both(lambda: resize_s2d(x, (24, 40)))
    assert launched == {'resize_s2d': 1}
    # the same fp32 lerps, rounded once: bit for bit
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('inverse', [False, True])
def test_regroup_kernel_matches_plain(cuda, dtype, inverse):
    x = _randn((2, 32 * 16, 256), dtype, cuda)
    got, want, launched = _both(lambda: shifted_regroup(x, (32, 16), 8, inverse=inverse))
    assert launched == {'shifted_regroup': 1}
    assert torch.equal(got, want)  # a permutation


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shift', [0, 4])
def test_swin_kernel_matches_plain(cuda, dtype, shift):
    h, w, b, c = 16, 24, 2, 256           # 6 windows a view, 2 heads of 128
    bw = b * (h // 8) * (w // 8)
    q, k, v = (_randn((bw, 64, c), dtype, cuda, seed=i) for i in range(3))
    regions = region_table(h, w, 8, shift, cuda) if shift else None
    got, want, launched = _both(
        lambda: swin_window_attention(q, k, v, num_heads=2, regions=regions))
    assert launched == {'swin_window_attention': 1}
    amax = float(want.float().abs().max())
    # bf16: q and P round in both, sums in another order: 4 ulps of max|ref|;
    # fp32: summation order, 2^-16 of max|ref|
    tol = amax * (4 * 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -16)
    assert float((got.float() - want.float()).abs().max()) <= tol
