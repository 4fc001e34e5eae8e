"""Attention stack: MHA with RoPE, pre-norm blocks, encoder and decoder.

Layouts follow the JAX package: activations ``[B, S, C]``, per-head
``[B, S, H, Dh]`` with the head axis after the sequence, key masks
``[B, Sk]`` bool with True = attend.  Every attention site carries RoPE
and goes through :func:`renderformer_tpu_torch.ops.flash_attention.
flash_attention_rope` (kernels K3 then K1/K2 on the card).  Cross
attention takes K/V at a batch ``Bkv`` dividing the query batch: the K/V
projections and the k-norm run once per scene and the kernels read the
scene's rows for each of its views.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from renderformer_tpu_torch.encodings.rope import (
    freqs_to_cos_sin, rope_frequencies, triangle_freqs)
from renderformer_tpu_torch.nn.core import ATTN_EPS, RopeFreqs, gelu, make_norm, silu
from renderformer_tpu_torch.ops.flash_attention import flash_attention_rope


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
    """SwiGLU (w2(silu(w1 x) * w3 x)) or GeLU FFN."""

    def __init__(self, dim: int, hidden_dim: int, activation: str = 'swiglu',
                 bias: bool = False):
        super().__init__()
        if activation not in ('swiglu', 'gelu'):
            raise ValueError(f'Unsupported activation: {activation}')
        self.activation = activation
        self.w1 = nn.Linear(dim, hidden_dim, bias=bias)
        self.w2 = nn.Linear(hidden_dim, dim, bias=bias)
        if activation == 'swiglu':
            self.w3 = nn.Linear(dim, hidden_dim, bias=bias)

    def forward(self, x):
        if self.activation == 'swiglu':
            h = silu(self.w1(x)) * self.w3(x)
        else:
            h = gelu(self.w1(x))
        return self.w2(h)


class MultiHeadAttention(nn.Module):
    """Self-attention (``kv_dim=None``, packed ``in_proj``) or cross-attention,
    with optional qk-norm, RoPE on q and k."""

    def __init__(self, query_dim: int, num_heads: int, kv_dim: Optional[int] = None,
                 bias: bool = False, qk_norm: bool = False, norm_type: str = 'rms_norm'):
        super().__init__()
        self.query_dim = query_dim
        self.num_heads = num_heads
        self.is_self_attn = kv_dim is None
        d = query_dim
        if self.is_self_attn:
            self.in_proj = nn.Linear(d, 3 * d, bias=bias)
        else:
            self.q_proj = nn.Linear(d, d, bias=bias)
            self.k_proj = nn.Linear(kv_dim, d, bias=bias)
            self.v_proj = nn.Linear(kv_dim, d, bias=bias)
        self.out_proj = nn.Linear(d, d, bias=bias)
        self.qk_norm = qk_norm
        if qk_norm:
            self.q_norm = make_norm(norm_type, d, ATTN_EPS)
            self.k_norm = make_norm(norm_type, d, ATTN_EPS)

    def forward(self, q, k, v, mask, rope_cos, rope_sin, rope_ctx_cos=None,
                rope_ctx_sin=None):
        """q [B, Sq, Dq]; k/v [Bkv, Sk, Dkv] with Bkv dividing B; mask [B, Sk]
        bool or None; q-side tables [B, Sq, Dh]; k-side tables [B, Sk, Dh]
        (default: the q-side ones)."""
        bs, sq = q.shape[0], q.shape[1]
        bs_kv, sk = k.shape[0], k.shape[1]
        out_dtype = q.dtype
        if self.is_self_attn:
            # three products from the sliced weight instead of one packed
            # product and a split along its minor dim
            d = self.query_dim
            w, b3 = self.in_proj.weight, self.in_proj.bias
            x = q
            q, k, v = (F.linear(x, w[i * d:(i + 1) * d],
                                None if b3 is None else b3[i * d:(i + 1) * d])
                       for i in range(3))
        else:
            q, k, v = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        if self.qk_norm:
            q = self.q_norm(q).to(v.dtype)
            k = self.k_norm(k).to(v.dtype)
        h = self.num_heads
        q = q.reshape(bs, sq, h, -1)
        k = k.reshape(bs_kv, sk, h, -1)
        v = v.reshape(bs_kv, sk, h, -1)
        if rope_ctx_cos is None:
            rope_ctx_cos, rope_ctx_sin = rope_cos, rope_sin
        out = flash_attention_rope(q.to(v.dtype), k.to(v.dtype), v, mask,
                                   rope_cos, rope_sin, rope_ctx_cos, rope_ctx_sin)
        return self.out_proj(out.reshape(bs, sq, -1)).to(out_dtype)


class AttentionLayer(nn.Module):
    """Pre-norm block: x += MHA(norm(x)); [x += self_attn(norm(x))];
    x += FFN(norm(x))."""

    def __init__(self, query_dim: int, num_heads: int, ffn_hidden_dim: int,
                 kv_dim: Optional[int] = None, bias: bool = False,
                 activation: str = 'swiglu', norm_type: str = 'rms_norm',
                 qk_norm: bool = False, add_self_attn: bool = False):
        super().__init__()
        self.multihead_attn = MultiHeadAttention(query_dim, num_heads, kv_dim, bias,
                                                 qk_norm, norm_type)
        self.query_norm = make_norm(norm_type, query_dim, ATTN_EPS)
        self.ffn = FeedForward(query_dim, ffn_hidden_dim, activation, bias)
        self.ffn_norm = make_norm(norm_type, query_dim, ATTN_EPS)
        self.is_cross = kv_dim is not None
        if self.is_cross:
            self.kv_norm = make_norm(norm_type, kv_dim, ATTN_EPS)
        self.add_self_attn = add_self_attn
        if add_self_attn:
            self.self_attn = MultiHeadAttention(query_dim, num_heads, None, bias,
                                                qk_norm, norm_type)
            self.self_attn_norm = make_norm(norm_type, query_dim, ATTN_EPS)

    def forward(self, query, kv=None, mask=None, rope_cos=None, rope_sin=None,
                rope_ctx_cos=None, rope_ctx_sin=None):
        q = self.query_norm(query)
        kv = self.kv_norm(kv) if self.is_cross else q
        query = query + self.multihead_attn(q, kv, kv, mask, rope_cos, rope_sin,
                                            rope_ctx_cos, rope_ctx_sin)
        if self.add_self_attn:
            q = self.self_attn_norm(query)
            query = query + self.self_attn(q, q, q, None, rope_cos, rope_sin)
        return query + self.ffn(self.ffn_norm(query))


def _resolved_rope_dim(rope_dim, rope_type, head_dim):
    """'triangle_mixed' overrides rope_dim with head_dim."""
    if rope_type == 'triangle_mixed':
        return head_dim
    if rope_dim // 2 * 9 > head_dim:
        raise ValueError(f'rope_dim {rope_dim} too large for head_dim {head_dim}')
    return rope_dim


class TransformerEncoder(nn.Module):
    """Self-attention blocks sharing one set of triangle-RoPE tables."""

    def __init__(self, num_layers: int, num_heads: int, hidden_dim: int,
                 ffn_hidden_dim: int, rope_dim: int, bias: bool = False,
                 activation: str = 'swiglu', norm_type: str = 'rms_norm',
                 rope_type: str = 'triangle', rope_double_max_freq: bool = False,
                 qk_norm: bool = False):
        super().__init__()
        self.head_dim = hidden_dim // num_heads
        self.layers = nn.ModuleList([
            AttentionLayer(hidden_dim, num_heads, ffn_hidden_dim, bias=bias,
                           activation=activation, norm_type=norm_type, qk_norm=qk_norm)
            for _ in range(num_layers)])
        rd = _resolved_rope_dim(rope_dim, rope_type, self.head_dim)
        self.rope_emb = RopeFreqs(rope_frequencies(rd, rope_double_max_freq))

    def forward(self, x, mask, triangle_pos):
        cos, sin = rope_tables(triangle_pos, self.rope_emb.freqs, self.head_dim)
        for layer in self.layers:
            x = layer(x, mask=mask, rope_cos=cos, rope_sin=sin)
        return x


class TransformerDecoder(nn.Module):
    """Cross-attention (rays -> triangles) + self-attention blocks, with
    intermediate-layer taps for the DPT head."""

    def __init__(self, num_layers: int, num_heads: int, hidden_dim: int,
                 ffn_hidden_dim: int, ctx_dim: int, rope_dim: int,
                 include_self_attn: bool = True, bias: bool = False,
                 activation: str = 'swiglu', norm_type: str = 'rms_norm',
                 qk_norm: bool = False, rope_type: str = 'triangle',
                 rope_double_max_freq: bool = False):
        super().__init__()
        self.head_dim = hidden_dim // num_heads
        self.layers = nn.ModuleList([
            AttentionLayer(hidden_dim, num_heads, ffn_hidden_dim, kv_dim=ctx_dim,
                           bias=bias, activation=activation, norm_type=norm_type,
                           qk_norm=qk_norm, add_self_attn=include_self_attn)
            for _ in range(num_layers)])
        rd = _resolved_rope_dim(rope_dim, rope_type, self.head_dim)
        self.rope_emb = RopeFreqs(rope_frequencies(rd, rope_double_max_freq))

    def forward(self, x, ctx, mask, triangle_pos, ray_pos,
                out_layers: Sequence[int] = ()):
        freqs = self.rope_emb.freqs
        cos, sin = rope_tables(ray_pos, freqs, self.head_dim)
        ctx_cos, ctx_sin = rope_tables(triangle_pos, freqs, self.head_dim)
        outs = []
        for idx, layer in enumerate(self.layers):
            x = layer(x, ctx, mask, cos, sin, ctx_cos, ctx_sin)
            if idx in out_layers:
                outs.append(x)
        return x, outs
