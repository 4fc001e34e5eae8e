"""The FLOP and byte counters against hand counts and against PyTorch's own
FLOP counter run over the reference."""

import collections

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from rfbench import counts, registry
from rfbench.reference import model as ref
from rfbench.weights import make_weights
from rfbench_tiny import tiny_model


def model(name):
    return registry.load(name).model


@pytest.mark.parametrize('swin,res', [(False, 64), (True, 128)])
def test_render_flops_are_the_references_products(swin, res):
    """PyTorch's FLOP counter over the reference render (matrix products and
    convolutions) less the camera transform's 3 x 3 products."""
    cfg = dict(tiny_model(model('v1-base.render')), view_transformer_use_swin_attn=swin)
    n, views = 37, 3
    g = torch.Generator().manual_seed(0)
    args = (torch.randn(n, 3, 3, generator=g) * 0.3, torch.rand(n, 13, 32, 32, generator=g),
            torch.ones(n, dtype=torch.bool), torch.randn(n, 3, 3, generator=g),
            torch.eye(4).repeat(views, 1, 1), torch.full((views,), 40.0))
    with FlopCounterMode(display=False) as fc:
        ref.render(cfg, make_weights(cfg, 1, 'cpu'), *args, res)
    camera = 2 * views * n * 3 * 3 * 3
    assert fc.get_total_flops() - camera == counts.render_flops(cfg, n, views, res)


def test_dpt_flops_by_hand():
    cfg = dict(view_transformer_latent_dim=4, dpt_out_channels=[1, 2, 3, 5], dpt_features=2,
               patch_size=8)
    g = 2                       # a 2 x 2 token grid: maps of 8, 4, 2 and 1
    proj = 2 * 4 * 4 * (1 + 2 + 3 + 5)
    resize = 2 * 4 * 1 * 1 * 16 + 2 * 4 * 2 * 2 * 4 + 2 * 1 * 5 * 5 * 9
    rn = 2 * 9 * 2 * (64 * 1 + 16 * 2 + 4 * 3 + 1 * 5)
    # refinenet4: one residual unit (two 3x3 convs) at 1 x 1, out_conv at 2 x 2;
    # the others two units at s x s and out_conv at 2s x 2s
    conv3 = lambda s: 2 * s * s * 2 * 2 * 9  # noqa: E731
    conv1 = lambda s: 2 * s * s * 2 * 2      # noqa: E731
    refine = 2 * conv3(1) + conv1(2) + sum(4 * conv3(s) + conv1(2 * s) for s in (2, 4, 8))
    full = 16 * 16
    tail = 2 * full * 2 * 1 * 9 + 2 * full * 1 * 32 * 9 + 2 * full * 32 * 3
    assert counts.dpt_flops(cfg, g) == proj + resize + rn + refine + tail


def test_attention_sites_by_hand():
    s = counts.rot_kv(b=2, bkv=1, sk=5, h=3, hd=4, dtype='bfloat16')
    assert (s.flops, s.nbytes) == (3 * 2 * 5 * 3 * 4, 5 * 3 * 4 * 2 + 2 * 2 * 5 * 4 * 4 + 2 * 5 * 3 * 4 * 2)
    s = counts.flash_fwd(b=2, bkv=1, sq=7, sk=5, h=3, hd=4, dtype='float32', masked=True)
    assert s.flops == 4 * 2 * 3 * 7 * 5 * 4
    assert s.nbytes == (2 * 7 * 12 * 2 + 2 * 5 * 12 + 5 * 12) * 4 + 2 * 5 + 2 * 2 * 7 * 4 * 4
    s = counts.flash_bwd(b=1, sq=7, sk=5, h=3, hd=4, dtype='bfloat16', masked=False)
    assert s.flops == 10 * 3 * 7 * 5 * 4
    assert s.nbytes == (4 * 7 * 12 + 4 * 5 * 12) * 2 + 2 * 3 * 7 * 4
    s = counts.swin(views=2, tokens=128, c=8, h=2, dtype='bfloat16')
    assert (s.flops, s.nbytes) == (4 * 2 * 128 * 64 * 4 * 2, 4 * 2 * 128 * 8 * 2)
    s = counts.regroup(views=2, tokens=128, c=8, dtype='float32')
    assert (s.flops, s.nbytes) == (0, 2 * 2 * 128 * 8 * 4)
    # the least time is the larger of the two bounds, at the dtype's peak
    big = counts.Site('flash_fwd', 'float32', 494.7e12, 1.0)
    assert big.least_s == pytest.approx(1.0)
    wide = counts.Site('rot_kv', 'bfloat16', 1.0, 3.35e12)
    assert wide.least_s == pytest.approx(1.0)


def launches(sites):
    return dict(collections.Counter(s.kernel for s in sites))


def test_sites_are_the_kernel_launches_of_a_render_and_a_step():
    """One site per launch, as the card counts them (``ops.LAUNCHES``):
    v1-base K1 18 + K2 6, K3 24; swin-large K1 24, K3 24, K6 12, K7 12;
    the swin-large remat step K1 48, K3 72, K8 24, K6 24, K6T 12, K7 36."""
    base, large = model('v1-base.render'), model('v1.1-swin-large.render')
    assert launches(counts.render_sites(base, 2048, 8, 512)) == {'rot_kv': 24, 'flash_fwd': 24}
    assert launches(counts.render_sites(large, 2048, 8, 512)) == {
        'rot_kv': 24, 'flash_fwd': 24, 'swin_fwd': 12, 'regroup': 12}
    assert launches(counts.train_sites(large, 2048, 1, 512)) == {
        'rot_kv': 72, 'flash_fwd': 48, 'flash_bwd': 24, 'swin_fwd': 24, 'swin_bwd': 12,
        'regroup': 36}
    dtypes = {s.dtype for s in counts.train_sites(large, 2048, 1, 512)
              if s.kernel == 'swin_fwd'}
    assert dtypes == {'float32'}


def test_train_flops_are_three_forward_passes():
    cfg = model('v1.1-swin-large.train')
    assert counts.train_flops(cfg, 3000, 1, 512) == 3 * counts.render_flops(cfg, 3000, 1, 512)
    # more real triangles, more work; the padding is not counted
    assert counts.train_flops(cfg, 4096, 1, 512) > counts.train_flops(cfg, 2048, 1, 512)
