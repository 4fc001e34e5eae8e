"""The one recorded deviation of the ring, isolated on the CPU: in bf16 the
fold of the kernels' plain partials and the ring of the JAX partials
(``impl='xla'``, JAX's ``_partial_fwd_xla`` / ``_partial_bwd_xla``) differ
by about one bf16 unit at the largest dQ element, which on the card read
0.0084 of max|ref| after the cast (the 2^-6 bar of ``RING_TOL_JAX``).

The cause once named was the order of q's scaling: the JAX partial scales
the logits after the product, the kernels round q to bf16 after scaling
it.  Here, at v1-base's view-stage cross site (4,096 rays against 2,064
keys of 128, view 0's last 516 masked: a whole slice, the ring's 4 slices)
with the views and heads cut to 2 and 1, the folds are kept in fp32
before their last cast, and the JAX partials are changed one rounding at a
time.  Changing only that order leaves most of the dQ gap; the gap closes
only when P and dS are rounded as the kernels round them too."""

import math

import numpy as np
import torch

from renderformer_tpu_torch.encodings.rope import apply_rope, make_cos_sin
from renderformer_tpu_torch.ops.flash_attention import LN2, fan_out, q_scale, rotate_kv
from renderformer_tpu_torch.parallel import ring_attention as ra

V, SQ, SK, H, D, N = 2, 4096, 2064, 1, 128, 4


def _site():
    rng = np.random.default_rng(0)

    def t(*shape, dt=torch.bfloat16):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32).to(dt)

    q, k, v = t(V, SQ, H, D), t(1, SK, H, D), t(1, SK, H, D)
    mask = torch.ones(V, SK, dtype=torch.bool)
    mask[0, -SK // N:] = False
    tabs = []
    for n in (SQ, SK):
        cos, sin = make_cos_sin(t(V, n, 9, dt=torch.float32), 12, D)
        tabs += [cos[:, :, 0].contiguous(), sin[:, :, 0].contiguous()]
    qr = apply_rope(q, tabs[0][:, :, None], tabs[1][:, :, None])
    return qr, rotate_kv(k, tabs[2], tabs[3]), fan_out(v, V).contiguous(), mask, t(V, SQ, H, D) * 0.1


def _fold32(q, k, v, mask, g, impl):
    """The ring's fold of N slices, forward and backward, with the results
    kept in fp32 (``_ring_fwd``/``_ring_bwd`` less their last casts):
    (out, dq, dk, dv)."""
    src = ra._Fold(N)
    b, sq, h, d = q.shape
    num = torch.zeros((b, sq, h, d))
    mx, den = torch.full((b, h, sq), ra.NEG_INF), torch.zeros((b, h, sq))
    state = src.place([k, v, mask])
    for i in range(N):
        num, mx, den = ra._merge(num, mx, den, *ra._partial_fwd(q, *src.current(state), impl))
        state = src.hop(state)
    out = num / den.transpose(1, 2)[..., None]
    lse = mx + torch.log(den)
    delta = (g.float() * out.to(q.dtype).float()).sum(-1).transpose(1, 2).contiguous()
    dq = torch.zeros(q.shape)
    state = src.place([k, v, mask])
    acc = src.place([torch.zeros(k.shape), torch.zeros(v.shape)])
    for i in range(N):
        dk_i, dv_i = ra._partial_bwd(q, *src.current(state), lse, delta, g, impl, 'fused', dq)
        src.add(acc, 0, dk_i)
        src.add(acc, 1, dv_i)
        state, acc = src.hop(state), src.hop(acc)
    dk, dv = src.home(acc)
    return out, dq, dk.float(), dv.float()


def _jax_partials(q_order=False, round_p=False, round_ds=False):
    """The JAX partials in torch ops, with the kernels' roundings switched in
    one at a time: q scaled by D^-0.5*log2(e) and rounded to its dtype
    before the product (``q_order``), P rounded before P.V and before dV
    (``round_p``), dS rounded before dQ and dK (``round_ds``)."""
    def q_rounded(q):
        """q * D^-0.5 * log2(e) rounded to q's dtype, in natural-log units."""
        return (q.float() * q_scale(q.shape[-1])).to(q.dtype).float() * LN2

    def logits(q, k, mask):
        if q_order:
            s = torch.einsum('bqhd,bkhd->bhqk', q_rounded(q), k.float())
        else:
            s = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * (
                1.0 / math.sqrt(q.shape[-1]))
        return s if mask is None else s.masked_fill(~mask[:, None, None, :], ra.NEG_INF)

    def fwd(q, k, v, mask):
        s = logits(q, k, mask)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        if round_p:
            o = torch.einsum('bhqk,bkhd->bqhd', p.to(v.dtype).float(), v.float())
            o = (o / l.permute(0, 2, 1, 3)).to(q.dtype)
        else:
            o = torch.einsum('bhqk,bkhd->bqhd', (p / l).to(v.dtype).float(), v.float())
        return o, (m + torch.log(l))[..., 0]

    def bwd(q, k, v, mask, lse, delta, do):
        scale = 1.0 / math.sqrt(q.shape[-1])
        p = torch.exp(logits(q, k, mask) - lse[..., None])
        do32 = do.float()
        dv = torch.einsum('bhqk,bqhd->bkhd', p.to(v.dtype).float() if round_p else p, do32)
        ds0 = p * (torch.einsum('bqhd,bkhd->bhqk', do32, v.float()) - delta[..., None])
        if round_ds:
            ds0 = ds0.to(q.dtype).float()
        ds = ds0 * scale
        dq = torch.einsum('bhqk,bkhd->bqhd', ds, k.float())
        dk = (torch.einsum('bhqk,bqhd->bkhd', ds0, q_rounded(q)) if q_order
              else torch.einsum('bhqk,bqhd->bkhd', ds, q.float()))
        return dq, dk.to(k.dtype), dv.to(v.dtype)

    return logits, fwd, bwd


def _gap(x, ref):
    return float((x - ref).abs().max() / ref.abs().max())


def test_bf16_ring_deviation_is_not_the_scaling_order_alone(monkeypatch):
    q, k, v, mask, g = _site()
    kernels = _fold32(q, k, v, mask, g, 'flash')   # the kernels' plain versions
    jax_order = _fold32(q, k, v, mask, g, 'xla')

    def jax_with(**roundings):
        logits, fwd, bwd = _jax_partials(**roundings)
        with monkeypatch.context() as m:
            m.setattr(ra, '_logits', logits)
            m.setattr(ra, 'partial_fwd_plain', fwd)
            m.setattr(ra, 'partial_bwd_plain', bwd)
            return _fold32(q, k, v, mask, g, 'xla')

    # the patched family reproduces the JAX partials as they are
    same = jax_with()
    assert all(torch.equal(a, b) for a, b in zip(same, jax_order))
    gap = [_gap(a, b) for a, b in zip(jax_order, kernels)]
    q_only = [_gap(a, b) for a, b in zip(jax_with(q_order=True), kernels)]
    every = [_gap(a, b) for a, b in zip(jax_with(q_order=True, round_p=True, round_ds=True),
                                        kernels)]
    print('fp32 gap of max|ref| (out, dq, dk, dv): JAX order', gap, '; q order changed',
          q_only, '; q, P and dS rounded as the kernels', every)
    # the gap: about one bf16 unit (2^-8 .. 2^-7 of max|ref|) before the cast
    assert 2.0 ** -9 < gap[1] < 2.0 ** -7
    # the order of q's scaling alone leaves most of dQ's gap ...
    assert q_only[1] > 0.6 * gap[1]
    # ... which closes when P and dS round as in the kernels as well
    assert every[1] < 0.25 * gap[1] and every[0] < 0.5 * gap[0]

    # after the ring's casts the bf16 results stay within the recorded bar
    def bf16_fold(impl):
        x = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = ra.ring_fold(*x, mask, n=N, impl=impl)
        return (out.detach(), *torch.autograd.grad(out, x, g))

    for a, b in zip(bf16_fold('xla'), bf16_fold('flash')):
        assert 0 < _gap(a.float(), b.float()) <= 2.0 ** -6
