"""RenderFormer in plain PyTorch: the yardstick's own copy of the model's math.

The architecture of the two released models (``microsoft/renderformer-v1-base``
and ``microsoft/renderformer-v1.1-swin-large``, SIGGRAPH 2025), written from
the published description and nothing else: no kernel, no cache, no fused
or reordered evaluation.  It imports neither JAX nor any package of the
program it judges, and it takes nothing the program made: the weights come
from :func:`param_spec` and ``rfbench.weights``, rays, camera transform and
HDR codec are worked out here.

Stage 1 (view independent): each triangle token is a learned token plus the
RMS-normed projection of its 13 x 32 x 32 texture patch (emission channels
log10(x + 1) encoded) plus that of a NeRF encoding of its vertex normals;
register tokens lead the sequence.  Pre-norm blocks of self-attention with
q/k RMS norm and triangle RoPE (the 9 vertex coordinates times log-spaced
frequencies; registers at the mask-weighted scene centroid), then a SwiGLU
FFN.  Stage 2 (per view, camera space): ray tokens from 8 x 8 patches of
ray directions; blocks of cross-attention to the stage-1 tokens (RoPE from
the camera-space triangles), self-attention (full, or 8 x 8 windows shifted
by 4 on odd layers, no RoPE), SwiGLU FFN; the last four blocks feed a DPT
head whose ELU(1e-3) output is the log10 radiance, decoded as 10^y - 1.

Precision is an argument: ``Precision()`` is the reference, float32 with
TF32 off; a stage at ``'fp8'`` (``'bf16'``) rounds the inputs, weights and
outputs of each of its linear layers and convolutions to float8 e4m3 with a
scale per tensor (to bfloat16), and the gradients that flow back through
them to float8 e5m2 (bfloat16), as a stage that computed and stored its
values in that type would; ``tf32`` lets cuBLAS and cuDNN use TF32: the
controls of the comparison.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

RMS_EPS = float(np.finfo(np.float32).eps)   # torch RMSNorm's default, the encoders' norms
ATTN_EPS = 1e-6                             # the attention blocks' norms
FP8_MAX = 448.0                             # largest float8 e4m3 value
FP8_GRAD_MAX = 57344.0                      # largest float8 e5m2 value

# the settings this reference implements; a config that departs from them is refused
FIXED = {
    'dropout': 0.0, 'activation': 'swiglu', 'norm_type': 'rms_norm', 'norm_first': True,
    'view_indep_qk_norm': True, 'qk_norm': True, 'bias': False, 'pe_type': 'rope',
    'rope_type': 'triangle', 'rope_double_max_freq': False, 'use_vn_encoder': True,
    'vn_encoder_norm_type': 'rms_norm', 'texture_encoder_norm_type': 'rms_norm',
    'view_transformer_include_self_attn': True, 'vdir_pe_type': 'nerf', 'vdir_num_freqs': 0,
    'include_alpha': False, 'use_dpt_decoder': True, 'dpt_out_layers': None,
    'turn_to_cam_coord': True, 'use_ldr': False,
}
WINDOW, SHIFT = 8, 4


def check_config(cfg: dict) -> None:
    for key, want in FIXED.items():
        if cfg.get(key, want) != want:
            raise ValueError(f'the reference implements {key}={want!r}, not {cfg[key]!r}')


# --------------------------------------------------------------------------- weights

def rope_base_freqs(dim: int) -> np.ndarray:
    """dim // 2 log-spaced base frequencies 2^linspace(0, log2(dim/2 - 1))."""
    return (2.0 ** np.linspace(0.0, math.log2(dim // 2 - 1), dim // 2)).astype(np.float32)


def view_rope_dim(cfg: dict) -> int:
    head = cfg['view_transformer_latent_dim'] // cfg['view_transformer_n_heads']
    return min(cfg['vertex_pe_num_freqs'], head // 18 * 2)


def param_spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """Every weight of the model: (name, shape, init) with init one of
    ``'normal'`` (learned tokens), ``'ones'`` (norm scales), ``'freqs'``
    (RoPE base frequencies, fixed) or ``'uniform:<fan_in>'`` (U(+-1/sqrt(fan_in)),
    linear and conv weights and biases).  Names follow the reference
    checkpoint's layout."""
    check_config(cfg)
    d, dv = cfg['latent_dim'], cfg['view_transformer_latent_dim']
    ff, ffv = cfg['dim_feedforward'], cfg['view_transformer_ffn_hidden_dim']
    ps, p = cfg['texture_encode_patch_size'], cfg['patch_size']
    spec: List[Tuple[str, Tuple[int, ...], str]] = []

    def lin(name, n_out, n_in, bias):
        spec.append((f'{name}.weight', (n_out, n_in), f'uniform:{n_in}'))
        if bias:
            spec.append((f'{name}.bias', (n_out,), f'uniform:{n_in}'))

    def conv(name, c_out, c_in, k, bias=True):
        spec.append((f'{name}.weight', (c_out, c_in, k, k), f'uniform:{c_in * k * k}'))
        if bias:
            spec.append((f'{name}.bias', (c_out,), f'uniform:{c_in * k * k}'))

    def norm(name, dim):
        spec.append((f'{name}.weight', (dim,), 'ones'))

    def block(pre, dim, ffn, kv_dim=None, self_attn=False):
        mha = f'{pre}.multihead_attn'
        if kv_dim is None:
            lin(f'{mha}.in_proj', 3 * dim, dim, False)
        else:
            lin(f'{mha}.q_proj', dim, dim, False)
            lin(f'{mha}.k_proj', dim, kv_dim, False)
            lin(f'{mha}.v_proj', dim, kv_dim, False)
        lin(f'{mha}.out_proj', dim, dim, False)
        norm(f'{mha}.q_norm', dim)
        norm(f'{mha}.k_norm', dim)
        norm(f'{pre}.query_norm', dim)
        lin(f'{pre}.ffn.w1', ffn, dim, False)
        lin(f'{pre}.ffn.w2', dim, ffn, False)
        lin(f'{pre}.ffn.w3', ffn, dim, False)
        norm(f'{pre}.ffn_norm', dim)
        if kv_dim is not None:
            norm(f'{pre}.kv_norm', kv_dim)
        if self_attn:
            lin(f'{pre}.self_attn.in_proj', 3 * dim, dim, False)
            lin(f'{pre}.self_attn.out_proj', dim, dim, False)
            norm(f'{pre}.self_attn.q_norm', dim)
            norm(f'{pre}.self_attn.k_norm', dim)
            norm(f'{pre}.self_attn_norm', dim)

    spec.append(('tri_token', (1, 1, d), 'normal'))
    spec.append(('reg_tokens', (1, cfg['num_register_tokens'], d), 'normal'))
    lin('texture_encoder', d, cfg['texture_channels'] * ps * ps, True)
    norm('texture_encoder_norm', d)
    lin('vn_encoding_proj', d, 9 * cfg['vn_pe_num_freqs'] * 2 + 9, True)
    norm('vn_encoder_norm', d)
    for i in range(cfg['num_layers']):
        block(f'transformer.layers.{i}', d, ff)
    spec.append(('transformer.rope_emb.freqs', (cfg['vertex_pe_num_freqs'] // 2,), 'freqs'))

    vt = 'view_transformer'
    spec.append((f'{vt}.ray_map_patch_token', (1, 1, dv), 'normal'))
    lin(f'{vt}.ray_map_encoder', dv, 3 * p * p, True)
    norm(f'{vt}.ray_map_encoder_norm', dv)
    for i in range(cfg['view_transformer_n_layers']):
        block(f'{vt}.transformer.layers.{i}', dv, ffv, kv_dim=d, self_attn=True)
    spec.append((f'{vt}.transformer.rope_emb.freqs', (view_rope_dim(cfg) // 2,), 'freqs'))

    dpt, oc, feat = f'{vt}.out_dpt', cfg['dpt_out_channels'], cfg['dpt_features']
    for i in range(4):
        conv(f'{dpt}.projects.{i}', oc[i], dv, 1)
    # transposed convs: weight [C_in, C_out, k, k], fan-in C_in * k * k
    for i, k in ((0, 4), (1, 2)):
        spec.append((f'{dpt}.resize_layers.{i}.weight', (oc[i], oc[i], k, k),
                     f'uniform:{oc[i] * k * k}'))
        spec.append((f'{dpt}.resize_layers.{i}.bias', (oc[i],), f'uniform:{oc[i] * k * k}'))
    conv(f'{dpt}.resize_layers.3', oc[3], oc[3], 3)
    for i in range(4):
        conv(f'{dpt}.scratch.layer{i + 1}_rn', feat, oc[i], 3, bias=False)
    for r in (1, 2, 3, 4):
        rn = f'{dpt}.scratch.refinenet{r}'
        conv(f'{rn}.out_conv', feat, feat, 1)
        for unit in ((1, 2) if r != 4 else (2,)):
            conv(f'{rn}.resConvUnit{unit}.conv1', feat, feat, 3)
            conv(f'{rn}.resConvUnit{unit}.conv2', feat, feat, 3)
    conv(f'{dpt}.scratch.output_conv1', feat // 2, feat, 3)
    conv(f'{dpt}.scratch.output_conv2.0', 32, feat // 2, 3)
    conv(f'{dpt}.scratch.output_conv2.2', 3, 32, 1)
    return spec


# --------------------------------------------------------------------------- precision

@dataclasses.dataclass(frozen=True)
class Precision:
    """How the reference computes each stage: ``'fp32'``, or ``'fp8'`` /
    ``'bf16'``: the inputs, weights and outputs of its linear layers and
    convolutions rounded to float8 e4m3 with a scale per tensor / to
    bfloat16, the products in float32; ``tf32`` lets every matrix product
    and convolution use TF32."""

    encoder: str = 'fp32'
    view: str = 'fp32'
    tf32: bool = False

    @property
    def name(self) -> str:
        return f"encoder_{self.encoder}.view_{self.view}{'.tf32' if self.tf32 else ''}"


FP32 = Precision()


@contextlib.contextmanager
def tf32_mode(on: bool):
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = cuda.allow_tf32, cudnn.allow_tf32
    cuda.allow_tf32 = cudnn.allow_tf32 = on
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = prev


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _scaled(x: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    """x rounded to a float8 type under a per-tensor scale, back in float32."""
    scale = x.abs().amax().float().clamp(min=1e-30) / largest
    return (x / scale).to(dtype).float() * scale


def _e4m3(x):
    return _scaled(x, torch.float8_e4m3fn, FP8_MAX)


def _e5m2(x):
    return _scaled(x, torch.float8_e5m2, FP8_GRAD_MAX)


class _Round(torch.autograd.Function):
    """A value rounded as a lower precision stores it, and the gradient
    that flows back through it rounded as that precision's backward would."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g), None, None


def to_bf16(x: torch.Tensor) -> torch.Tensor:
    """x in bfloat16 (back in float32); its gradient in bfloat16 too."""
    return _Round.apply(x, _bf16, _bf16)


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """x in float8 e4m3 under a per-tensor scale (back in float32); its
    gradient in float8 e5m2 under a per-tensor scale, as fp8 training keeps
    values and gradients."""
    return _Round.apply(x, _e4m3, _e5m2)


ROUNDING = {'fp32': None, 'bf16': to_bf16, 'fp8': to_fp8}


# --------------------------------------------------------------------------- pieces

class Model:
    """The forward pass over a name -> tensor dict of weights."""

    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor],
                 precision: Precision = FP32):
        check_config(cfg)
        self.cfg, self.w, self.prec = cfg, params, precision
        self.rounding = None     # the rounding of the stage being computed

    def stage(self, name: str) -> None:
        self.rounding = ROUNDING[getattr(self.prec, name)]

    def q(self, x):
        """x as the stage's precision stores it."""
        return x if self.rounding is None else self.rounding(x)

    # -- elementary layers
    def linear(self, x, name, bias=False):
        w = self.w[f'{name}.weight']
        b = self.w[f'{name}.bias'] if bias else None
        return self.q(F.linear(self.q(x), self.q(w), b))

    def rms(self, x, name, eps):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * self.w[f'{name}.weight']

    def conv(self, x, name, stride=1, padding=0, bias=True):
        w = self.w[f'{name}.weight']
        b = self.w[f'{name}.bias'] if bias else None
        return self.q(F.conv2d(self.q(x), self.q(w), b, stride=stride, padding=padding))

    def ffn(self, x, pre):
        return self.linear(F.silu(self.linear(x, f'{pre}.w1')) * self.linear(x, f'{pre}.w3'),
                           f'{pre}.w2')

    # -- attention
    @staticmethod
    def attend(q, k, v, key_mask=None, bias=None):
        """q [B, H, Sq, Dh], k/v [B, H, Sk, Dh]; key_mask [B, Sk] (True =
        attend); bias added to the logits."""
        logits = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
        if bias is not None:
            logits = logits + bias
        if key_mask is not None:
            logits = logits.masked_fill(~key_mask[:, None, None, :], float('-inf'))
        return torch.softmax(logits, dim=-1) @ v

    @staticmethod
    def rope_tables(pos, freqs, head_dim):
        """pos [B, S, 9] -> cos, sin [B, 1, S, head_dim]: the 9 coordinates
        times each base frequency fill the first angles of each half of the
        head dims, the rest rotate by 0."""
        ang = (pos[..., None] * freqs).reshape(pos.shape[0], pos.shape[1], -1)
        ang = F.pad(ang, (0, head_dim // 2 - ang.shape[-1]))
        full = torch.cat([ang, ang], dim=-1)[:, None]
        return torch.cos(full), torch.sin(full)

    @staticmethod
    def rotate(x, cos, sin):
        half = x.shape[-1] // 2
        return x * cos + torch.cat([-x[..., half:], x[..., :half]], dim=-1) * sin

    def heads(self, x, n):
        b, s, c = x.shape
        return x.reshape(b, s, n, c // n).transpose(1, 2)

    @staticmethod
    def merge(x):
        b, h, s, d = x.shape
        return x.transpose(1, 2).reshape(b, s, h * d)

    def self_attention(self, x, pre, n_heads, mask=None, tables=None):
        """Packed in_proj, q/k norm over the full width, optional RoPE."""
        c = x.shape[-1]
        wq, wk, wv = self.w[f'{pre}.in_proj.weight'].split(c)
        xq = self.q(x)
        q, k, v = (self.q(F.linear(xq, self.q(w))) for w in (wq, wk, wv))
        q = self.heads(self.rms(q, f'{pre}.q_norm', ATTN_EPS), n_heads)
        k = self.heads(self.rms(k, f'{pre}.k_norm', ATTN_EPS), n_heads)
        v = self.heads(v, n_heads)
        if tables is not None:
            q, k = self.rotate(q, *tables), self.rotate(k, *tables)
        return self.linear(self.merge(self.attend(q, k, v, mask)), f'{pre}.out_proj')

    # -- stage 1
    def encode_scene(self, tris, texture, mask, vn):
        """tris [B, N, 9] world space, texture [B, N, 13, ps, ps] (raw),
        mask [B, N], vn [B, N, 9] -> tokens [B, R+N, D], their mask."""
        cfg = self.cfg
        self.stage('encoder')
        b, n = tris.shape[:2]
        tex = texture.clone()
        tex[:, :, -3:] = torch.log10(tex[:, :, -3:] + 1.0)
        emb = self.w['tri_token'] + self.rms(
            self.linear(tex.reshape(b, n, -1), 'texture_encoder', bias=True),
            'texture_encoder_norm', RMS_EPS)
        vn_pe = nerf_encode(vn, cfg['vn_pe_num_freqs'])
        emb = emb + self.rms(self.linear(vn_pe, 'vn_encoding_proj', bias=True),
                             'vn_encoder_norm', RMS_EPS)
        reg = self.w['reg_tokens'].expand(b, -1, -1)
        x = torch.cat([reg, emb], dim=1)
        pos, full_mask = with_centroid(tris, mask, cfg['num_register_tokens'])
        head = cfg['latent_dim'] // cfg['num_heads']
        tables = self.rope_tables(pos, self.w['transformer.rope_emb.freqs'], head)
        for i in range(cfg['num_layers']):
            pre = f'transformer.layers.{i}'
            h = self.rms(x, f'{pre}.query_norm', ATTN_EPS)
            x = x + self.self_attention(h, f'{pre}.multihead_attn', cfg['num_heads'],
                                        full_mask, tables)
            x = x + self.ffn(self.rms(x, f'{pre}.ffn_norm', ATTN_EPS), f'{pre}.ffn')
        return x, full_mask

    # -- stage 2
    def swin(self, x, pre, n_heads, grid, shift):
        """Window self-attention on row-major tokens [V, h*w, C]; a shifted
        layer rolls the grid by -shift first, masks pairs from different
        bands of the rolled grid, and rolls back."""
        v, s, c = x.shape
        gh, gw = grid
        img = x.reshape(v, gh, gw, c)
        if shift:
            img = torch.roll(img, (-shift, -shift), dims=(1, 2))
        win = (img.reshape(v, gh // WINDOW, WINDOW, gw // WINDOW, WINDOW, c)
               .permute(0, 1, 3, 2, 4, 5).reshape(-1, WINDOW * WINDOW, c))
        bias = None
        if shift:
            labels = window_labels(gh, gw, shift).to(x.device)       # [nW, 64]
            same = labels[:, :, None] == labels[:, None, :]
            bias = torch.where(same, 0.0, float('-inf'))[:, None]     # [nW, 1, 64, 64]
            bias = bias.repeat(v, 1, 1, 1)
        wq, wk, wv = self.w[f'{pre}.in_proj.weight'].split(c)
        win = self.q(win)
        q, k, val = (self.q(F.linear(win, self.q(w))) for w in (wq, wk, wv))
        q = self.heads(self.rms(q, f'{pre}.q_norm', ATTN_EPS), n_heads)
        k = self.heads(self.rms(k, f'{pre}.k_norm', ATTN_EPS), n_heads)
        out = self.linear(self.merge(self.attend(q, k, self.heads(val, n_heads), bias=bias)),
                          f'{pre}.out_proj')
        img = (out.reshape(v, gh // WINDOW, gw // WINDOW, WINDOW, WINDOW, c)
               .permute(0, 1, 3, 2, 4, 5).reshape(v, gh, gw, c))
        if shift:
            img = torch.roll(img, (shift, shift), dims=(1, 2))
        return img.reshape(v, s, c)

    def decode_views(self, ctx, ctx_mask, tris_cam, mask, rays_d, grid):
        """ctx [1, R+N, D] one scene's stage-1 tokens; tris_cam [V, N, 9]
        camera space; rays_d [V, T, 3*p*p] patch-layout directions (camera at
        the origin) -> the four DPT taps [V, T, Dv] each."""
        cfg = self.cfg
        self.stage('view')
        nv = rays_d.shape[0]
        dv, nh = cfg['view_transformer_latent_dim'], cfg['view_transformer_n_heads']
        head = dv // nh
        vt = 'view_transformer'
        x = self.w[f'{vt}.ray_map_patch_token'] + self.rms(
            self.linear(rays_d, f'{vt}.ray_map_encoder', bias=True),
            f'{vt}.ray_map_encoder_norm', RMS_EPS)
        freqs = self.w[f'{vt}.transformer.rope_emb.freqs']
        # every ray token sits at the camera origin, tiled x3
        ray_pos = torch.zeros(nv, x.shape[1], 9, dtype=x.dtype, device=x.device)
        q_tables = self.rope_tables(ray_pos, freqs, head)
        tri_pos, _ = with_centroid(tris_cam, mask.expand(nv, -1), cfg['num_register_tokens'])
        k_tables = self.rope_tables(tri_pos, freqs, head)
        key_mask = ctx_mask.expand(nv, -1)
        taps = []
        n_layers = cfg['view_transformer_n_layers']
        swin = cfg['view_transformer_use_swin_attn']
        for i in range(n_layers):
            pre = f'{vt}.transformer.layers.{i}'
            mha = f'{pre}.multihead_attn'
            h = self.rms(x, f'{pre}.query_norm', ATTN_EPS)
            kv = self.rms(ctx, f'{pre}.kv_norm', ATTN_EPS)
            q = self.heads(self.rms(self.linear(h, f'{mha}.q_proj'), f'{mha}.q_norm', ATTN_EPS), nh)
            k = self.heads(self.rms(self.linear(kv, f'{mha}.k_proj'), f'{mha}.k_norm', ATTN_EPS), nh)
            val = self.heads(self.linear(kv, f'{mha}.v_proj'), nh)
            q = self.rotate(q, *q_tables)
            k = self.rotate(k.expand(nv, -1, -1, -1), *k_tables)
            att = self.attend(q, k, val.expand(nv, -1, -1, -1), key_mask)
            x = x + self.linear(self.merge(att), f'{mha}.out_proj')
            h = self.rms(x, f'{pre}.self_attn_norm', ATTN_EPS)
            if swin:
                x = x + self.swin(h, f'{pre}.self_attn', nh, grid, SHIFT if i % 2 else 0)
            else:
                x = x + self.self_attention(h, f'{pre}.self_attn', nh, None, q_tables)
            x = x + self.ffn(self.rms(x, f'{pre}.ffn_norm', ATTN_EPS), f'{pre}.ffn')
            if i >= n_layers - 4:
                taps.append(x)
        return taps

    # -- DPT head
    def rcu(self, x, pre):
        out = self.conv(F.silu(x), f'{pre}.conv1', padding=1)
        out = self.conv(F.silu(out), f'{pre}.conv2', padding=1)
        return out + x

    def fusion(self, x, pre, res=None, size=None):
        if res is not None:
            x = x + self.rcu(res, f'{pre}.resConvUnit1')
        x = self.rcu(x, f'{pre}.resConvUnit2')
        x = F.interpolate(x, size=size, mode='bilinear', align_corners=True)
        return self.conv(x, f'{pre}.out_conv')

    def dpt(self, taps, grid, out_hw):
        """Four token maps [V, T, Dv] -> log-radiance [V, 3, H, W]."""
        pre = 'view_transformer.out_dpt'
        gh, gw = grid
        feats = []
        for i, t in enumerate(taps):
            x = t.transpose(1, 2).reshape(t.shape[0], t.shape[2], gh, gw)
            x = self.conv(x, f'{pre}.projects.{i}')
            if i in (0, 1):
                w = self.w[f'{pre}.resize_layers.{i}.weight']
                x = self.q(F.conv_transpose2d(self.q(x), self.q(w),
                                              self.w[f'{pre}.resize_layers.{i}.bias'],
                                              stride=w.shape[-1]))
            elif i == 3:
                x = self.conv(x, f'{pre}.resize_layers.3', stride=2, padding=1)
            feats.append(x)
        s = f'{pre}.scratch'
        l1, l2, l3, l4 = (self.conv(f, f'{s}.layer{i + 1}_rn', padding=1, bias=False)
                          for i, f in enumerate(feats))
        p4 = self.fusion(l4, f'{s}.refinenet4', size=l3.shape[-2:])
        p3 = self.fusion(p4, f'{s}.refinenet3', l3, size=l2.shape[-2:])
        p2 = self.fusion(p3, f'{s}.refinenet2', l2, size=l1.shape[-2:])
        p1 = self.fusion(p2, f'{s}.refinenet1', l1, size=(l1.shape[-2] * 2, l1.shape[-1] * 2))
        out = self.conv(p1, f'{s}.output_conv1', padding=1)
        out = F.interpolate(out, size=out_hw, mode='bilinear', align_corners=True)
        out = F.silu(self.conv(out, f'{s}.output_conv2.0', padding=1))
        out = self.conv(out, f'{s}.output_conv2.2')
        return F.elu(out, alpha=1e-3)

    # -- the whole render
    def log_radiance(self, tris, texture, mask, vn, c2w, fov, resolution, view_chunk=8,
                     ctx=None):
        """One scene: tris [N, 3, 3], texture [N, 13, ps, ps], mask [N],
        vn [N, 3, 3], c2w [V, 4, 4], fov [V] degrees -> log10(1 + radiance)
        [V, H, W, 3].  A given ``ctx`` [1, R+N, D] takes the place of stage
        1's tokens (texture and vn are then not read)."""
        n = tris.shape[0]
        if ctx is None:
            ctx, ctx_mask = self.encode_scene(tris.reshape(1, n, 9), texture[None], mask[None],
                                              vn.reshape(1, n, 9))
        else:
            ctx_mask = with_centroid(tris.reshape(1, n, 9), mask[None],
                                     self.cfg['num_register_tokens'])[1]
        p = self.cfg['patch_size']
        grid = (resolution // p, resolution // p)
        outs = []
        for lo in range(0, c2w.shape[0], view_chunk):
            cams, fovs = c2w[lo:lo + view_chunk], fov[lo:lo + view_chunk]
            tris_cam = to_camera(cams, tris).reshape(cams.shape[0], n, 9)
            rays = patch_rays(fovs, resolution, p)
            taps = self.decode_views(ctx, ctx_mask, tris_cam, mask[None], rays, grid)
            outs.append(self.dpt(taps, grid, (resolution, resolution)).permute(0, 2, 3, 1))
        return torch.cat(outs)


# --------------------------------------------------------------------------- geometry

def nerf_encode(x, num_freqs):
    """[*, D] -> [*, D + 2*D*F]: x, then sin(x*2^f) for every (d, f), then
    their cosines as sin(. + pi/2)."""
    freqs = torch.as_tensor(2.0 ** np.arange(num_freqs), dtype=x.dtype, device=x.device)
    scaled = (x[..., None] * freqs).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(torch.cat([scaled, scaled + math.pi / 2], dim=-1))], dim=-1)


def with_centroid(tris, mask, n_reg):
    """Positions [B, N, 9] -> [B, R+N, 9] with the registers at the
    mask-weighted centroid of all vertices, tiled x3; the mask with R
    leading Trues."""
    m = mask.to(tris.dtype)
    wgt = m / (m.sum(1, keepdim=True) + 1e-5)
    center = (wgt[..., None] * tris).sum(1).reshape(-1, 3, 3).mean(1)
    reg = center[:, None].repeat(1, n_reg, 3)
    lead = torch.ones(mask.shape[0], n_reg, dtype=torch.bool, device=mask.device)
    return torch.cat([reg, tris], dim=1), torch.cat([lead, mask], dim=1)


def to_camera(c2w, tris):
    """World triangles [N, 3, 3] into each camera's frame, x_cam = R^T (x - t)."""
    rot, t = c2w[:, :3, :3], c2w[:, :3, 3]
    return torch.einsum('vnkj,vji->vnki', tris[None] - t[:, None, None], rot)


def patch_rays(fov_deg, resolution, p):
    """Unit ray directions of a camera at the origin looking down -Z, pixel
    centres at +0.5, focal res/2/tan(fov/2), grouped into p x p patches:
    [V, (res/p)^2, 3*p*p], column c*p*p + i*p + j for component c of patch
    pixel (i, j)."""
    dev = fov_deg.device
    pix = torch.arange(resolution, dtype=torch.float32, device=dev) + 0.5
    f = resolution / 2.0 / torch.tan(torch.deg2rad(fov_deg) / 2)
    x = (pix[None, None, :] - resolution / 2.0) / f[:, None, None]
    y = -(pix[None, :, None] - resolution / 2.0) / f[:, None, None]
    x, y = torch.broadcast_tensors(x, y)
    d = torch.stack([x, y, -torch.ones_like(x)], dim=-1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)             # [V, H, W, 3]
    g = resolution // p
    d = d.reshape(-1, g, p, g, p, 3).permute(0, 1, 3, 5, 2, 4)      # [V, gh, gw, 3, p, p]
    return d.reshape(d.shape[0], g * g, 3 * p * p)


def window_labels(gh, gw, shift):
    """[nW, 64] band label of each token of each window of the grid rolled
    by -shift: three bands per axis, (0, -8), (-8, -shift), (-shift, end)."""
    lab = torch.zeros(gh, gw, dtype=torch.int64)
    bands = (slice(0, -WINDOW), slice(-WINDOW, -shift), slice(-shift, None))
    for i, hb in enumerate(bands):
        for j, wb in enumerate(bands):
            lab[hb, wb] = 3 * i + j
    return (lab.reshape(gh // WINDOW, WINDOW, gw // WINDOW, WINDOW).permute(0, 2, 1, 3)
            .reshape(-1, WINDOW * WINDOW))


def render(cfg: dict, params, tris, texture, mask, vn, c2w, fov, resolution,
           precision: Precision = FP32, view_chunk: int = 8):
    """HDR radiance [V, H, W, 3] of one scene: 10^y - 1 of the model's
    log-radiance y, in float32, TF32 as ``precision`` says."""
    with tf32_mode(precision.tf32):
        y = Model(cfg, params, precision).log_radiance(
            tris.float(), texture.float(), mask, vn.float(), c2w.float(), fov.float(),
            resolution, view_chunk)
        return torch.pow(10.0, y) - 1.0
