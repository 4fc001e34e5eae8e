"""The port package stands alone: it imports neither JAX nor any module of
renderformer_tpu, and its entry points refuse a CUDA device that is absent
instead of carrying on on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r'''
import importlib, pkgutil, sys
import renderformer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith('jax.') or m.startswith('jaxlib')
             or m == 'renderformer_tpu' or m.startswith('renderformer_tpu.'))
print(len(names), bad)
assert not bad, bad
'''


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['PYTHONPATH'] = REPO
    res = subprocess.run([sys.executable, '-c', _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 15, res.stdout


def test_default_device_refuses_missing_cuda(monkeypatch):
    from renderformer_tpu_torch import RenderFormerConfig, RenderingPipeline
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfg = RenderFormerConfig(latent_dim=72, num_layers=1, num_heads=2,
                             view_transformer_latent_dim=72,
                             view_transformer_n_heads=2,
                             view_transformer_n_layers=4)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        RenderingPipeline.from_config(cfg)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        RenderingPipeline.from_pretrained('v1-base', device='cuda')


def test_unported_configurations_raise():
    from renderformer_tpu_torch import RenderFormerConfig
    from renderformer_tpu_torch.models.renderformer import RenderFormer
    for kw in ({'pe_type': 'nerf'}, {'view_transformer_use_swin_attn': True},
               {'use_dpt_decoder': False}, {'vdir_num_freqs': 2}):
        with pytest.raises(NotImplementedError):
            RenderFormer(RenderFormerConfig(**kw))


@pytest.mark.cuda
def test_kernels_match_plain_on_cuda():
    """On a card: each kernel against its plain version at small shapes."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from renderformer_tpu_torch.encodings.rope import make_cos_sin
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.ops.flash_attention import flash_attention_rope
    from renderformer_tpu_torch.ops.fused_resize import resize_bilinear
    rng = np.random.default_rng(0)
    dev = 'cuda'
    b, bkv, sq, sk, h, d = 4, 2, 100, 70, 2, 128
    q = torch.tensor(rng.normal(size=(b, sq, h, d)), dtype=torch.float32, device=dev)
    k = torch.tensor(rng.normal(size=(bkv, sk, h, d)), dtype=torch.float32, device=dev)
    v = torch.tensor(rng.normal(size=(bkv, sk, h, d)), dtype=torch.float32, device=dev)
    mask = torch.tensor(rng.uniform(size=(b, sk)) > 0.3, device=dev)
    cq, sq_ = make_cos_sin(torch.tensor(rng.normal(size=(b, sq, 9)), dtype=torch.float32,
                                        device=dev), 12, d)
    ck, sk_ = make_cos_sin(torch.tensor(rng.normal(size=(b, sk, 9)), dtype=torch.float32,
                                        device=dev), 12, d)
    tabs = [t[:, :, 0].contiguous() for t in (cq, sq_, ck, sk_)]
    x = torch.tensor(rng.normal(size=(2, 16, 16, 64)), dtype=torch.float32, device=dev)
    with torch.no_grad():
        got = flash_attention_rope(q, k, v, mask, *tabs)
        got_r = resize_bilinear(x, (32, 32))
        with reference_kernels():
            want = flash_attention_rope(q, k, v, mask, *tabs)
            want_r = resize_bilinear(x, (32, 32))
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)  # fp32 summation order
    torch.testing.assert_close(got_r, want_r, atol=1e-6, rtol=0)  # same fp32 ops
