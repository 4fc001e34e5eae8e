"""Sequence-parallel attention over the mesh's ``seq`` axis: ring attention
and sequence-split attention.

The counterpart of ``renderformer_tpu/parallel/ring_attention.py``.  Both
keep the JAX contract: **global tensors in, global out**.  Each rank slices
its part, attends, and all-gathers the output; the backward takes the
global output gradient (the same on every rank, since everything outside
the site is replicated) and returns global dq, dk and dv, the same on
every rank, so no parameter gradient upstream counts a rank twice.

Ring attention: each seq rank keeps its slice of q and its slice of K/V.
The step loop runs one partial attention of the local q against the K/V
slice in hand (K10 with its logsumexp, or its plain version), folds it
into a running fp32 (num, max, den), and passes the slice on.  The
backward is a second ring: each step runs the flash backward (K8, or K9
under ``flash_backward('twokernel')``) of the local q against the slice in
hand, with the *global* logsumexp and delta = rowsum(dO * O), so each
partial gives its exact share; dQ accumulates at home in fp32 (K8 adds
into it by its own atomics, so no slice's dQ rounds to the dtype), and
dK/dV travel with their slice and arrive home after n hops.  The step
loop takes its K/V source as an argument: across a process group,
:class:`_Group` passes the slices around by ``batch_isend_irecv``; on one
device :class:`_Fold` walks the n slices of K/V in ring order, which is
how the ring is held on one card (``ring_fold``).

A fully masked slice reads logsumexp = -1e30 * ln 2 + ln(n_keys) from K10
(its -1e30 bias is in log2 units), -1e30 + ln(n_keys) from the plain
partial: either way it weighs exactly zero beside any slice that has a
key, and its backward's P = exp(s - lse) is exactly 0 against the global
logsumexp.  The merge starts from a maximum of -1e30, below both.

Sequence-split attention, where a site's key length does not divide the
ring (``nn/attention.py`` chooses): each seq rank attends with its slice
of q to the whole K/V (one K1/K2 or K10 launch), the output and dq are
all-gathered, dk and dv all-reduced.  All-gathering K/V first, as XLA
does under GSPMD, needs no code here: K/V are whole on every rank
already.

The plain partials are the JAX file's ``_partial_fwd_xla`` and
``_partial_bwd_xla`` in torch ops (``impl='xla'``).  As every plain version
of the port, they run only on CPU tensors or inside
``ops.reference_kernels()``; on a CUDA tensor the ring launches the
kernels or raises.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from renderformer_tpu_torch.ops import use_plain
from renderformer_tpu_torch.ops.flash_attention import backward_variant, flash_bwd, flash_fwd
from renderformer_tpu_torch.parallel.distributed import all_gather_cat
from renderformer_tpu_torch.parallel.sharding import (
    axis_group, axis_index, axis_ranks, axis_size)

NEG_INF = -1e30
IMPLS = ('xla', 'flash')


# ---------------------------------------------------------------------------
# Per-slice partial attention, forward and backward
# ---------------------------------------------------------------------------

def _logits(q, k, mask):
    s = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * (1.0 / math.sqrt(q.shape[-1]))
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    return s


def partial_fwd_plain(q, k, v, mask):
    """Attention of q against one K/V slice, in torch ops (JAX's
    ``_partial_fwd_xla``): (out [B, Sq, H, D] fp32, lse [B, H, Sq] fp32
    natural-log, finite when the slice is fully masked)."""
    s = _logits(q, k, mask)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum('bhqk,bkhd->bqhd', (p / l).to(v.dtype).float(), v.float())
    return o, (m + torch.log(l))[..., 0]


def partial_bwd_plain(q, k, v, mask, lse, delta, do):
    """Gradients of one K/V slice's share of the attention, in torch ops
    (JAX's ``_partial_bwd_xla``), given the global lse and delta
    [B, H, Sq]: (dq fp32, dk in k's dtype, dv in v's dtype)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_logits(q, k, mask) - lse[..., None])
    do32 = do.float()
    dv = torch.einsum('bhqk,bqhd->bkhd', p, do32)
    dp = torch.einsum('bqhd,bkhd->bhqk', do32, v.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum('bhqk,bkhd->bqhd', ds, k.float())
    dk = torch.einsum('bhqk,bqhd->bkhd', ds, q.float())
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def _check_plain(t):
    if not use_plain(t):
        raise RuntimeError("impl='xla' runs the plain partials, on the CPU or inside "
                           "ops.reference_kernels(); the port has no library attention on "
                           "the card: use impl='flash'")


def _partial_fwd(q, k, v, mask, impl):
    if impl == 'flash':
        return flash_fwd(q, k, v, mask, with_lse=True)
    _check_plain(q)
    return partial_fwd_plain(q, k, v, mask)


def _partial_bwd(q, k, v, mask, lse, delta, do, impl, variant, dq):
    """(dk, dv) of one K/V slice, its dQ added into the fp32 ``dq``."""
    if impl == 'flash':
        return flash_bwd(q, k, v, mask, lse, delta, do, variant, dq_acc=dq)[1:]
    _check_plain(q)
    dq_i, dk, dv = partial_bwd_plain(q, k, v, mask, lse, delta, do)
    dq.add_(dq_i)
    return dk, dv


def _merge(num, mx, den, o_i, lse_i):
    """Fold one partial (o_i [B, Sq, H, D] in any float dtype, lse_i
    [B, H, Sq]) into the running fp32 softmax state, ``num`` in place."""
    m_new = torch.maximum(mx, lse_i)
    a = torch.exp(mx - m_new)
    b = torch.exp(lse_i - m_new)
    num.mul_(a.transpose(1, 2)[..., None]).addcmul_(o_i, b.transpose(1, 2)[..., None])
    return num, m_new, den * a + b


# ---------------------------------------------------------------------------
# K/V sources of the step loop: a mesh's seq group, or one device's fold
# ---------------------------------------------------------------------------

def _slice(x, dim, n, i):
    return x if n == 1 else x.chunk(n, dim=dim)[i].contiguous()


class _Group:
    """This rank's slice of the sequence (dim 1) over the mesh's seq axis,
    and of the batch (dim 0) over its batch axis when there is one; K/V
    slices pass one hop round the seq group's ring (to the next rank, from
    the previous) by ``batch_isend_irecv``."""

    def __init__(self, mesh, seq_axis: str, batch_axis: Optional[str]):
        self.n = axis_size(mesh, seq_axis)
        self.i = axis_index(mesh, seq_axis)
        self.group = axis_group(mesh, seq_axis) if self.n > 1 else None
        ranks = axis_ranks(mesh, seq_axis)
        self.next, self.prev = ranks[(self.i + 1) % self.n], ranks[(self.i - 1) % self.n]
        self.nb = axis_size(mesh, batch_axis) if batch_axis else 1
        self.ib = axis_index(mesh, batch_axis) if batch_axis else 0
        self.bgroup = axis_group(mesh, batch_axis) if self.nb > 1 else None

    def local(self, x):
        return None if x is None else _slice(_slice(x, 0, self.nb, self.ib), 1, self.n, self.i)

    def gather(self, x):
        return all_gather_cat(all_gather_cat(x, 1, self.group, self.n), 0, self.bgroup, self.nb)

    def reduce(self, x):
        if self.n > 1:
            dist.all_reduce(x, group=self.group)
        return x

    def place(self, tensors):
        return list(tensors)

    def current(self, state):
        return state

    def add(self, state, i, x):
        state[i].add_(x)

    def hop(self, state):
        if self.n == 1:
            return state
        out, ops = [], []
        for t in state:
            if t is None:
                out.append(None)
                continue
            wire = t.view(torch.uint8) if t.dtype == torch.bool else t
            recv = torch.empty_like(wire)
            ops += [dist.P2POp(dist.isend, wire, self.next, self.group),
                    dist.P2POp(dist.irecv, recv, self.prev, self.group)]
            out.append(recv.view(torch.bool) if t.dtype == torch.bool else recv)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    def home(self, state):
        return state


class _Fold:
    """One device, nothing sliced or gathered: the n slices of K/V along the
    sequence, walked in ring order (slice 0, n-1, ..., 1, as rank 0 of a
    ring receives them)."""

    def __init__(self, n: int):
        self.n = n

    def local(self, x):
        return x

    def gather(self, x):
        return x

    def place(self, tensors):
        return [None if t is None else [c.contiguous() for c in t.chunk(self.n, dim=1)]
                for t in tensors]

    def current(self, state):
        return [None if s is None else s[0] for s in state]

    def add(self, state, i, x):
        state[i][0].add_(x)

    def hop(self, state):
        return [None if s is None else [s[-1]] + s[:-1] for s in state]

    def home(self, state):
        return [torch.cat(s, dim=1) for s in state]


def _ring_fwd(q, k, v, mask, source, impl):
    """The forward ring on local q and the local K/V slice: (out in q's
    dtype, global lse [B, H, Sq] fp32)."""
    b, sq, h, d = q.shape
    num = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    mx = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    den = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    state = source.place([k, v, mask])
    for i in range(source.n):
        o_i, lse_i = _partial_fwd(q, *source.current(state), impl)
        num, mx, den = _merge(num, mx, den, o_i, lse_i)
        if i + 1 < source.n:
            state = source.hop(state)
    den = den.clamp_min(1e-30)
    return (num / den.transpose(1, 2)[..., None]).to(q.dtype), mx + torch.log(den)


def _ring_bwd(q, k, v, mask, out, lse, g, source, impl, variant):
    """The backward ring: (dq, dk, dv) of the local slices, in their dtypes."""
    delta = (g.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    state = source.place([k, v, mask])
    acc = source.place([torch.zeros(k.shape, dtype=torch.float32, device=k.device),
                        torch.zeros(v.shape, dtype=torch.float32, device=v.device)])
    for i in range(source.n):
        dk_i, dv_i = _partial_bwd(q, *source.current(state), lse, delta, g, impl, variant,
                                  dq)
        source.add(acc, 0, dk_i)
        source.add(acc, 1, dv_i)
        if i + 1 < source.n:
            state = source.hop(state)
        acc = source.hop(acc)  # dK/dV travel with their slice: home after n hops
    dk, dv = source.home(acc)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Global in, global out
# ---------------------------------------------------------------------------

class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, source, impl):
        ql, kl, vl, ml = (source.local(t) for t in (q, k, v, mask))
        out, lse = _ring_fwd(ql, kl, vl, ml, source, impl)
        ctx.save_for_backward(ql, kl, vl, ml, out, lse)
        ctx.source, ctx.impl, ctx.variant = source, impl, backward_variant()
        return source.gather(out)

    @staticmethod
    def backward(ctx, g):
        ql, kl, vl, ml, out, lse = ctx.saved_tensors
        src = ctx.source
        dq, dk, dv = _ring_bwd(ql, kl, vl, ml, out, lse, src.local(g.contiguous()), src,
                               ctx.impl, ctx.variant)
        return src.gather(dq), src.gather(dk), src.gather(dv), None, None, None


def _prepare(q, k, v, mask, n, impl):
    if impl not in IMPLS:
        raise ValueError(f'ring attention impl {impl!r} is not one of {IMPLS}')
    if q.dim() != 4 or k.shape != v.shape or k.shape[0] != q.shape[0]:
        raise ValueError('q, k and v must be [B, S, H, D], k and v at the q batch')
    if q.shape[1] % n or k.shape[1] % n:
        raise ValueError(f'ring_attention: Sq={q.shape[1]}, Sk={k.shape[1]} must divide '
                         f'the ring size {n}')
    if mask is not None:
        if mask.dim() == 4:
            mask = mask[:, 0, 0, :]
        mask = mask.to(torch.bool).contiguous()
    return q.contiguous(), k.contiguous(), v.contiguous(), mask


def ring_attention(q, k, v, mask=None, *, mesh, seq_axis: str = 'seq',
                   batch_axis: Optional[str] = 'data', impl: str = 'flash'):
    """Ring attention over ``mesh[seq_axis]``.

    q [B, Sq, H, D]; k, v [B, Sk, H, D] (at the q batch); mask [B, Sk] or
    [B, 1, 1, Sk] bool (True = attend) or None.  Global tensors in: each
    rank takes its slice of Sq and Sk over ``seq_axis`` (and of B over
    ``batch_axis``, when the mesh has it), runs the ring, and gets the
    global [B, Sq, H, D] out.  Sq and Sk must divide the ring size and B the
    batch axis.  ``impl``: ``'flash'`` (K10 and K8/K9) or ``'xla'`` (the
    plain partials)."""
    n = axis_size(mesh, seq_axis)
    q, k, v, mask = _prepare(q, k, v, mask, n, impl)
    if batch_axis is not None and batch_axis not in mesh.mesh_dim_names:
        batch_axis = None
    if batch_axis is not None and q.shape[0] % axis_size(mesh, batch_axis):
        raise ValueError(f'ring_attention: batch {q.shape[0]} must divide the '
                         f'{batch_axis} axis {axis_size(mesh, batch_axis)}')
    return _RingAttention.apply(q, k, v, mask, _Group(mesh, seq_axis, batch_axis), impl)


def ring_fold(q, k, v, mask=None, *, n: int, impl: str = 'flash'):
    """The ring of ``n`` slices on one device: the whole q against the n
    K/V slices in ring order, forward and backward, with the launches of a
    ring's rank (n partials each way).  Shapes as :func:`ring_attention`."""
    q, k, v, mask = _prepare(q, k, v, mask, n, impl)
    return _RingAttention.apply(q, k, v, mask, _Fold(n), impl)


# ---------------------------------------------------------------------------
# Sequence-split attention
# ---------------------------------------------------------------------------

class _SeqSplit(torch.autograd.Function):
    """``fn`` on this rank's slice of the q-side arguments and the whole
    K/V-side ones; the backward recomputes ``fn`` on the slice, all-gathers
    the q-side gradients and all-reduces the K/V-side ones."""

    @staticmethod
    def forward(ctx, fn, group, n_q, *args):
        local = [group.local(a) if i < n_q else a for i, a in enumerate(args)]
        with torch.no_grad():
            out = fn(*local)
        ctx.fn, ctx.group, ctx.n_q = fn, group, n_q
        ctx.save_for_backward(*local)
        return group.gather(out)

    @staticmethod
    def backward(ctx, g):
        local = ctx.saved_tensors
        needs = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_(True) if need else a
                      for a, need in zip(local, needs)]
            out = ctx.fn(*leaves)
            wrt = [a for a, need in zip(leaves, needs) if need]
            grads = iter(torch.autograd.grad(out, wrt, ctx.group.local(g).contiguous()))
        result = []
        for i, need in enumerate(needs):
            if not need:
                result.append(None)
            elif i < ctx.n_q:
                result.append(ctx.group.gather(next(grads)))
            else:
                result.append(ctx.group.reduce(next(grads).contiguous()))
        return (None, None, None, *result)


def seq_split_attention(fn: Callable, q_args: Sequence, kv_args: Sequence, *, mesh,
                        seq_axis: str = 'seq'):
    """``fn(*q_args, *kv_args)`` with the q-side arguments (dim 1 = the query
    sequence) split over ``mesh[seq_axis]``: global in, global out.  The
    query length must divide the axis."""
    group = _Group(mesh, seq_axis, None)
    if q_args[0].shape[1] % group.n:
        raise ValueError(f'sequence-split attention: Sq={q_args[0].shape[1]} must divide '
                         f'the seq axis {group.n}')
    return _SeqSplit.apply(fn, group, len(q_args), *q_args, *kv_args)
