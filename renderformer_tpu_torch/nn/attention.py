"""Attention stack: MHA with or without RoPE, Swin window attention,
pre-norm blocks, encoder and decoder.

Layouts follow the JAX package: activations ``[B, S, C]``, per-head
``[B, S, H, Dh]`` with the head axis after the sequence, key masks
``[B, Sk]`` bool with True = attend.  A full attention site with RoPE goes
through :func:`renderformer_tpu_torch.ops.flash_attention.
flash_attention_rope` (kernels K3 then K1/K2 on the card); one without
(``pe_type='nerf'``, encoder and decoder built with ``rope_dim=None``)
fans K/V out to the query batch and goes through ``flash_attention``
(kernel K10), the JAX package's ``attend`` path.  The JAX ``attend`` sends
a query shorter than 256 tokens to XLA attention, because its TPU kernel
pads to 128-row blocks; the port launches K10 at every such site, as it
launches K1/K2 at every RoPE site: the function is the same, and the tests
hold it against the JAX ``impl='xla'`` path.  Cross attention with RoPE
takes K/V at a batch ``Bkv`` dividing the query batch: the K/V projections
and the k-norm run once per scene and the kernels read the scene's rows for
each of its views.  Swin self-attention has no RoPE: it attends inside 8x8
windows (kernel K6), and its shifted layers regroup the window-ordered
stream around it (kernel K7).

Inside ``parallel.sharding.use_sharding`` with more than one rank on the
mesh's ``seq`` axis, a full attention site splits over those ranks
(``parallel/ring_attention.py``): by ring attention where both lengths
divide the axis (q rotated in fp32 torch ops, K rotated and fanned out per
view by K3, then K10 partials), otherwise, with a notice, by
sequence-split attention (each rank's query slice against the whole K/V,
the same kernels) where the query length divides it, or whole on every
rank.  Swin windows stay local.

With ``remat`` set on the encoder or decoder, each block runs under
``torch.utils.checkpoint`` (non-reentrant) where autograd records it, as
``jax.checkpoint`` wraps each block in the JAX package: the backward
recomputes the block's forward instead of keeping its activations.

Dropout (a ``dropout`` rate > 0 and a :class:`~renderformer_tpu_torch.nn.
core.DropoutKey`) sits where the JAX package puts it: in a block, on the
attention output, the self-attention output, the FFN's hidden activation,
the FFN's output and the FFN branch at its residual join, in that order;
the encoder and the decoder fold the layer index into the key, a block
the site index, so a recomputed block draws its forward's masks.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from renderformer_tpu_torch.encodings.rope import (
    apply_rope, freqs_to_cos_sin, rope_frequencies, triangle_freqs)
from renderformer_tpu_torch.nn.core import (
    ATTN_EPS, DropoutKey, Linear, RopeFreqs, dropout, gelu, linear, make_norm, silu)
from renderformer_tpu_torch.nn.swin import seq_from_window_order, seq_to_window_order
from renderformer_tpu_torch.ops.flash_attention import (
    fan_out, flash_attention, flash_attention_rope, rotate_kv)
from renderformer_tpu_torch.ops.shifted_regroup import shifted_regroup
from renderformer_tpu_torch.ops.swin_attention import region_table, swin_window_attention
from renderformer_tpu_torch.parallel.ring_attention import ring_attention, seq_split_attention
from renderformer_tpu_torch.parallel.sharding import (
    active_mesh, axis_size, current_sharding, restored_sharding)


def sdpa(q, k, v, mask=None):
    """Masked scaled-dot-product attention, plain: q/k/v [B, S, H, Dh],
    mask broadcastable to [B, H, Sq, Sk] (True = attend); fp32 logits and
    softmax, P.V in v's dtype."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    logits = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, float('-inf'))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum('bhqk,bkhd->bqhd', probs, v)


def rope_tables(pos, freqs, head_dim: int):
    """Positions [B, S, 9] -> head-shared (cos, sin) [B, S, head_dim] fp32."""
    cos, sin = freqs_to_cos_sin(triangle_freqs(pos, freqs), head_dim=head_dim)
    return cos[:, :, 0].contiguous(), sin[:, :, 0].contiguous()


class FeedForward(nn.Module):
    """SwiGLU (w2(silu(w1 x) * w3 x)) or GeLU FFN, with dropout on the
    hidden activation and on the output."""

    def __init__(self, dim: int, hidden_dim: int, activation: str = 'swiglu',
                 bias: bool = False, dropout: float = 0.0):
        super().__init__()
        if activation not in ('swiglu', 'gelu'):
            raise ValueError(f'Unsupported activation: {activation}')
        self.activation = activation
        self.dropout = dropout
        self.w1 = Linear(dim, hidden_dim, bias=bias)
        self.w2 = Linear(hidden_dim, dim, bias=bias)
        if activation == 'swiglu':
            self.w3 = Linear(dim, hidden_dim, bias=bias)

    def forward(self, x, key: Optional[DropoutKey] = None):
        if self.activation == 'swiglu':
            h = silu(self.w1(x)) * self.w3(x)
        else:
            h = gelu(self.w1(x))
        h = dropout(h, self.dropout, _fold(key, 0))
        return dropout(self.w2(h), self.dropout, _fold(key, 1))


def _fold(key: Optional[DropoutKey], i: int) -> Optional[DropoutKey]:
    return None if key is None else key.fold(i)


def _split_in_proj(x, in_proj: nn.Linear, d: int):
    """q, k, v as three products from the sliced packed weight instead of one
    packed product and a split along its minor dim."""
    w, b3 = in_proj.weight, in_proj.bias
    return tuple(linear(x, w[i * d:(i + 1) * d],
                        None if b3 is None else b3[i * d:(i + 1) * d])
                 for i in range(3))


class MultiHeadAttention(nn.Module):
    """Self-attention (``kv_dim=None``, packed ``in_proj``) or cross-attention,
    with optional qk-norm, and RoPE on q and k unless the tables are None."""

    def __init__(self, query_dim: int, num_heads: int, kv_dim: Optional[int] = None,
                 bias: bool = False, qk_norm: bool = False, norm_type: str = 'rms_norm'):
        super().__init__()
        self.query_dim = query_dim
        self.num_heads = num_heads
        self.is_self_attn = kv_dim is None
        d = query_dim
        if self.is_self_attn:
            self.in_proj = Linear(d, 3 * d, bias=bias)
        else:
            self.q_proj = Linear(d, d, bias=bias)
            self.k_proj = Linear(kv_dim, d, bias=bias)
            self.v_proj = Linear(kv_dim, d, bias=bias)
        self.out_proj = Linear(d, d, bias=bias)
        self.qk_norm = qk_norm
        if qk_norm:
            self.q_norm = make_norm(norm_type, d, ATTN_EPS)
            self.k_norm = make_norm(norm_type, d, ATTN_EPS)

    def forward(self, q, k, v, mask, rope_cos, rope_sin, rope_ctx_cos=None,
                rope_ctx_sin=None):
        """q [B, Sq, Dq]; k/v [Bkv, Sk, Dkv] with Bkv dividing B; mask [B, Sk]
        bool or None; q-side tables [B, Sq, Dh], or None for no RoPE; k-side
        tables [B, Sk, Dh] (default: the q-side ones)."""
        bs, sq = q.shape[0], q.shape[1]
        bs_kv, sk = k.shape[0], k.shape[1]
        out_dtype = q.dtype
        if self.is_self_attn:
            q, k, v = _split_in_proj(q, self.in_proj, self.query_dim)
        else:
            q, k, v = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        if self.qk_norm:
            q = self.q_norm(q).to(v.dtype)
            k = self.k_norm(k).to(v.dtype)
        h = self.num_heads
        q = q.reshape(bs, sq, h, -1).to(v.dtype)
        k = k.reshape(bs_kv, sk, h, -1).to(v.dtype)
        v = v.reshape(bs_kv, sk, h, -1)
        if rope_cos is not None and rope_ctx_cos is None:
            rope_ctx_cos, rope_ctx_sin = rope_cos, rope_sin
        tables = (rope_cos, rope_sin, rope_ctx_cos, rope_ctx_sin)
        mesh, how = _seq_split(bs, sq, sk)
        if how == 'ring':
            out = _ring_site(q, k, v, mask, *tables, mesh)
        else:
            out = _attend(q, k, v, mask, *tables, mesh if how == 'split' else None)
        return self.out_proj(out.reshape(bs, sq, -1)).to(out_dtype)


_RING_FALLBACK_WARNED = set()


def _seq_split(bs: int, sq: int, sk: int):
    """(the active mesh, how a full attention site splits over its seq
    axis): ``'ring'`` where both lengths divide the axis, else
    ``'split'`` (sequence-split attention) where the query length does,
    else None, the site attending whole on every rank.  The fallback from
    the ring says so once per shape; correctness never depends on it."""
    mesh = active_mesh()
    n = axis_size(mesh, 'seq') if mesh is not None else 1
    if n <= 1:
        return None, None
    if sq % n == 0 and sk % n == 0:
        return mesh, 'ring'
    key = (bs, sq, sk, n)
    if key not in _RING_FALLBACK_WARNED:
        _RING_FALLBACK_WARNED.add(key)
        print(f'NOTICE: attention shapes [B={bs}, Sq={sq}, Sk={sk}] do not divide the '
              f'mesh (seq={n}); this site takes '
              + ('sequence-split attention' if sq % n == 0 else 'whole attention on every rank'))
    return mesh, 'split' if sq % n == 0 else None


def _attend(q, k, v, mask, cos, sin, ctx_cos, ctx_sin, mesh=None):
    """The site's attention: K3 then K1/K2 with RoPE, K10 on K/V fanned out
    to the query batch without; with a ``mesh``, split over its seq axis by
    query slices."""
    bs = q.shape[0]
    if cos is None:
        k, v = fan_out(k, bs), fan_out(v, bs)
        if mesh is None:
            return flash_attention(q, k, v, mask)
        return seq_split_attention(flash_attention, (q,), (k, v, mask), mesh=mesh)
    if mesh is None:
        return flash_attention_rope(q, k, v, mask, cos, sin, ctx_cos, ctx_sin)

    def site(q_, cos_, sin_, k_, v_, mask_, ctx_cos_, ctx_sin_):
        return flash_attention_rope(q_, k_, v_, mask_, cos_, sin_, ctx_cos_, ctx_sin_)

    return seq_split_attention(site, (q, cos, sin), (k, v, mask, ctx_cos, ctx_sin), mesh=mesh)


def _ring_site(q, k, v, mask, cos, sin, ctx_cos, ctx_sin, mesh):
    """Ring attention at a site: q rotated in fp32 torch ops, per-scene K
    rotated and fanned out per view by K3 (a token's rotation travels with
    it round the ring), V fanned out, then the ring's partials."""
    bs = q.shape[0]
    if cos is not None:
        q = apply_rope(q, cos[:, :, None, :], sin[:, :, None, :])
        k = rotate_kv(k, ctx_cos, ctx_sin)
    else:
        k = fan_out(k, bs)
    return ring_attention(q, k, fan_out(v, bs), mask, mesh=mesh, batch_axis=None)


class SwinSelfAttention(nn.Module):
    """Window self-attention over a window-ordered stream ``[B, S, C]`` of
    an h x w token grid: no RoPE, packed ``in_proj``, optional qk-norm.  A
    shifted layer (``shift_size = window_size // 2``) regroups the stream
    into shifted-window order before the projections and back after
    ``out_proj``, and masks pairs of tokens from different regions."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift_size: int = 0,
                 bias: bool = False, qk_norm: bool = False, norm_type: str = 'rms_norm'):
        super().__init__()
        if shift_size not in (0, window_size // 2):
            raise ValueError(f'shift {shift_size}: the model shifts by 0 or '
                             f'window_size // 2 = {window_size // 2}')
        self.dim = dim
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift_size = shift_size
        self.in_proj = Linear(dim, 3 * dim, bias=bias)
        self.out_proj = Linear(dim, dim, bias=bias)
        self.qk_norm = qk_norm
        if qk_norm:
            self.q_norm = make_norm(norm_type, dim, ATTN_EPS)
            self.k_norm = make_norm(norm_type, dim, ATTN_EPS)

    def forward(self, x, grid):
        """x [B, S, C] in unshifted-window order of the (h, w) grid."""
        b, s, c = x.shape
        h, w = grid
        ws = self.window_size
        shifted = self.shift_size > 0
        if shifted:
            x = shifted_regroup(x, (h, w), ws)
        q, k, v = _split_in_proj(x, self.in_proj, c)
        if self.qk_norm:
            q = self.q_norm(q).to(v.dtype)
            k = self.k_norm(k).to(v.dtype)
        win = (b * s // (ws * ws), ws * ws, c)
        regions = region_table(h, w, ws, self.shift_size, x.device) if shifted else None
        out = swin_window_attention(
            q.to(v.dtype).reshape(win), k.to(v.dtype).reshape(win), v.reshape(win),
            num_heads=self.num_heads, regions=regions)
        out = self.out_proj(out).reshape(b, s, c)
        if shifted:
            out = shifted_regroup(out, (h, w), ws, inverse=True)
        return out


class AttentionLayer(nn.Module):
    """Pre-norm block: x += MHA(norm(x)); [x += self_attn(norm(x))];
    x += FFN(norm(x)).  With ``use_swin_attn`` the self-attention is
    :class:`SwinSelfAttention` on the window-ordered stream."""

    def __init__(self, query_dim: int, num_heads: int, ffn_hidden_dim: int,
                 kv_dim: Optional[int] = None, bias: bool = False,
                 activation: str = 'swiglu', norm_type: str = 'rms_norm',
                 qk_norm: bool = False, add_self_attn: bool = False,
                 use_swin_attn: bool = False, window_size: int = 8,
                 shift_size: int = 0, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.multihead_attn = MultiHeadAttention(query_dim, num_heads, kv_dim, bias,
                                                 qk_norm, norm_type)
        self.query_norm = make_norm(norm_type, query_dim, ATTN_EPS)
        self.ffn = FeedForward(query_dim, ffn_hidden_dim, activation, bias, dropout)
        self.ffn_norm = make_norm(norm_type, query_dim, ATTN_EPS)
        self.is_cross = kv_dim is not None
        if self.is_cross:
            self.kv_norm = make_norm(norm_type, kv_dim, ATTN_EPS)
        self.add_self_attn = add_self_attn
        self.use_swin_attn = use_swin_attn
        if add_self_attn:
            if use_swin_attn:
                self.self_attn = SwinSelfAttention(query_dim, num_heads, window_size,
                                                   shift_size, bias, qk_norm, norm_type)
            else:
                self.self_attn = MultiHeadAttention(query_dim, num_heads, None, bias,
                                                    qk_norm, norm_type)
            self.self_attn_norm = make_norm(norm_type, query_dim, ATTN_EPS)

    def forward(self, query, kv=None, mask=None, rope_cos=None, rope_sin=None,
                rope_ctx_cos=None, rope_ctx_sin=None, grid=None,
                key: Optional[DropoutKey] = None):
        """``grid`` = (patch_h, patch_w) of a window-ordered Swin stream;
        ``key`` the block's dropout key (None: no dropout)."""
        q = self.query_norm(query)
        kv = self.kv_norm(kv) if self.is_cross else q
        attn = self.multihead_attn(q, kv, kv, mask, rope_cos, rope_sin,
                                   rope_ctx_cos, rope_ctx_sin)
        query = query + dropout(attn, self.dropout, _fold(key, 0))
        if self.add_self_attn:
            q = self.self_attn_norm(query)
            if self.use_swin_attn:
                sa = self.self_attn(q, grid)
            else:
                sa = self.self_attn(q, q, q, None, rope_cos, rope_sin)
            query = query + dropout(sa, self.dropout, _fold(key, 1))
        ffn = self.ffn(self.ffn_norm(query), _fold(key, 2))
        return query + dropout(ffn, self.dropout, _fold(key, 3))


def remat_call(module: nn.Module, *args):
    """``module(*args)`` under torch.utils.checkpoint(use_reentrant=False).

    The module's parameters and buffers are passed in as inputs of the
    checkpointed call, so the recomputation in the backward uses the tensors
    of this forward: the stage casts a train step puts in place with
    ``functional_call`` are gone by the time the backward runs.  So is the
    sharding context: the recomputation re-enters this forward's, so that
    its attention sites split as the forward's did.  The RNG states are not
    stashed (``preserve_rng_state=False``, which a CUDA graph's capture
    needs): no block draws from them, dropout takes its masks from
    :class:`DropoutKey` generators."""
    named = dict(module.named_parameters())
    named.update(module.named_buffers())
    names, n = list(named), len(args)
    sharding = current_sharding()

    def run(*flat):
        with restored_sharding(sharding):
            return functional_call(module, dict(zip(names, flat[n:])), flat[:n])

    return checkpoint(run, *args, *named.values(), use_reentrant=False,
                      preserve_rng_state=False)


def _run_block(remat: bool, layer: nn.Module, *args):
    if remat and torch.is_grad_enabled():
        return remat_call(layer, *args)
    return layer(*args)


def _resolved_rope_dim(rope_dim, rope_type, head_dim):
    """'triangle_mixed' overrides rope_dim with head_dim; None (no RoPE)
    stays None."""
    if rope_dim is None:
        return None
    if rope_type == 'triangle_mixed':
        return head_dim
    if rope_dim // 2 * 9 > head_dim:
        raise ValueError(f'rope_dim {rope_dim} too large for head_dim {head_dim}')
    return rope_dim


class TransformerEncoder(nn.Module):
    """Self-attention blocks sharing one set of triangle-RoPE tables, or none
    with ``rope_dim=None``."""

    def __init__(self, num_layers: int, num_heads: int, hidden_dim: int,
                 ffn_hidden_dim: int, rope_dim: Optional[int], bias: bool = False,
                 activation: str = 'swiglu', norm_type: str = 'rms_norm',
                 rope_type: str = 'triangle', rope_double_max_freq: bool = False,
                 qk_norm: bool = False, dropout: float = 0.0):
        super().__init__()
        self.head_dim = hidden_dim // num_heads
        self.layers = nn.ModuleList([
            AttentionLayer(hidden_dim, num_heads, ffn_hidden_dim, bias=bias,
                           activation=activation, norm_type=norm_type, qk_norm=qk_norm,
                           dropout=dropout)
            for _ in range(num_layers)])
        rd = _resolved_rope_dim(rope_dim, rope_type, self.head_dim)
        self.rope_emb = (None if rd is None
                         else RopeFreqs(rope_frequencies(rd, rope_double_max_freq)))
        self.remat = False

    def forward(self, x, mask, triangle_pos, key: Optional[DropoutKey] = None):
        cos = sin = None
        if self.rope_emb is not None:
            cos, sin = rope_tables(triangle_pos, self.rope_emb.freqs, self.head_dim)
        for idx, layer in enumerate(self.layers):
            x = _run_block(self.remat, layer, x, None, mask, cos, sin, None, None, None,
                           _fold(key, idx))
        return x


class TransformerDecoder(nn.Module):
    """Cross-attention (rays -> triangles) + self-attention blocks, with
    intermediate-layer taps for the DPT head.

    With ``use_swin_attn`` the self-attention is window attention, unshifted
    on even layers and shifted by ``shift_size`` on odd ones, and the
    residual stream and the q-side RoPE tables stay in unshifted-window
    order for the whole stack (cross-attention, norms and FFN do not depend
    on the token order); each tap and the output go back to row-major
    order."""

    def __init__(self, num_layers: int, num_heads: int, hidden_dim: int,
                 ffn_hidden_dim: int, ctx_dim: int, rope_dim: Optional[int],
                 include_self_attn: bool = True, bias: bool = False,
                 activation: str = 'swiglu', norm_type: str = 'rms_norm',
                 qk_norm: bool = False, rope_type: str = 'triangle',
                 rope_double_max_freq: bool = False, use_swin_attn: bool = False,
                 window_size: int = 8, shift_size: int = 4, dropout: float = 0.0):
        super().__init__()
        self.head_dim = hidden_dim // num_heads
        self.use_swin_attn = use_swin_attn
        self.window_size = window_size
        self.layers = nn.ModuleList([
            AttentionLayer(hidden_dim, num_heads, ffn_hidden_dim, kv_dim=ctx_dim,
                           bias=bias, activation=activation, norm_type=norm_type,
                           qk_norm=qk_norm, add_self_attn=include_self_attn,
                           use_swin_attn=use_swin_attn, window_size=window_size,
                           shift_size=0 if idx % 2 == 0 else shift_size, dropout=dropout)
            for idx in range(num_layers)])
        rd = _resolved_rope_dim(rope_dim, rope_type, self.head_dim)
        self.rope_emb = (None if rd is None
                         else RopeFreqs(rope_frequencies(rd, rope_double_max_freq)))
        self.remat = False

    def forward(self, x, ctx, mask, triangle_pos, ray_pos,
                out_layers: Sequence[int] = (), grid=None,
                key: Optional[DropoutKey] = None):
        """``grid`` = (patch_h, patch_w) of the ray tokens, for Swin.  Without
        RoPE the positions are not read."""
        cos = sin = ctx_cos = ctx_sin = None
        if self.rope_emb is not None:
            freqs = self.rope_emb.freqs
            cos, sin = rope_tables(ray_pos, freqs, self.head_dim)
            ctx_cos, ctx_sin = rope_tables(triangle_pos, freqs, self.head_dim)
        windowed = self.use_swin_attn
        if windowed:
            if grid is None:
                raise ValueError('a Swin decoder needs the token grid')
            ph, pw, ws = grid[0], grid[1], self.window_size
            x = seq_to_window_order(x, ph, pw, ws)
            if cos is not None:
                cos = seq_to_window_order(cos, ph, pw, ws)
                sin = seq_to_window_order(sin, ph, pw, ws)
        outs = []
        for idx, layer in enumerate(self.layers):
            x = _run_block(self.remat, layer, x, ctx, mask, cos, sin, ctx_cos, ctx_sin, grid,
                           _fold(key, idx))
            if idx in out_layers:
                outs.append(seq_from_window_order(x, ph, pw, ws) if windowed else x)
        if windowed:
            x = seq_from_window_order(x, ph, pw, ws)
        return x, outs
