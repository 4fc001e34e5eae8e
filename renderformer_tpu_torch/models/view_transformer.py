"""Stage 2: view-dependent ray decoding.

Patch-layout ray tokens -> cross/self-attention decoder (full or Swin
window self-attention) over the stage-1 triangle tokens -> DPT head ->
ELU(alpha=1e-3).  The view stage runs in the dtype of its weights.  With
``pe_type='nerf'`` the ray tokens and the triangle tokens each get a NeRF
encoding of their camera-space position; the triangle tokens are fanned
out per view first, so the cross-attention K/V projections run once per
view.

With ``vdir_num_freqs != 0`` the rays come as a 2-D map [B, H, W, 3]: each
direction is NeRF-encoded (raw input first) and the map patchified as
``'b (h1 p1) (w1 p2) c -> b (h1 w1) (c p1 p2)'`` into the ray encoder.
With ``use_dpt_decoder=False`` the linear head replaces the DPT head:
``out_proj``, ELU(1e-3) in the stage's dtype, then the unpatchify
``'b (h1 w1) (c p1 p2) -> b (h1 p1) (w1 p2) c'``.  ``(c p1 p2)`` is the
reference's torch layout of ``ray_map_encoder.weight`` and
``out_proj.weight``.  Under a profiler session the DPT head is the range
``rf.model.dpt``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from renderformer_tpu_torch.config import RenderFormerConfig
from renderformer_tpu_torch.encodings.nerf import nerf_encode, nerf_out_dim
from renderformer_tpu_torch.nn.attention import TransformerDecoder
from renderformer_tpu_torch.nn.core import DropoutKey, Linear, elu, make_norm
from renderformer_tpu_torch.nn.dpt import DPTHead
from renderformer_tpu_torch.ops.flash_attention import fan_out
from renderformer_tpu_torch.utils.profiling import annotate


class ViewTransformer(nn.Module):
    def __init__(self, config: RenderFormerConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        d = cfg.view_transformer_latent_dim
        self.ray_map_patch_token = nn.Parameter(torch.zeros(1, 1, d))
        p = cfg.patch_size
        vdir_dim = nerf_out_dim(3, cfg.vdir_num_freqs, include_input=True)
        self.ray_map_encoder = Linear(vdir_dim * p * p, d, bias=True)
        self.ray_map_encoder_norm = make_norm(cfg.norm_type, d)
        if cfg.pe_type == 'nerf':
            self.pe_token_proj = Linear(
                nerf_out_dim(9, cfg.vertex_pe_num_freqs, include_input=True), d, bias=True)
            self.token_pos_pe_norm = make_norm(cfg.norm_type, d)
        self.transformer = TransformerDecoder(
            num_layers=cfg.view_transformer_n_layers,
            num_heads=cfg.view_transformer_n_heads,
            hidden_dim=d,
            ffn_hidden_dim=cfg.view_transformer_ffn_hidden_dim,
            ctx_dim=cfg.latent_dim,
            rope_dim=cfg.view_rope_dim,
            include_self_attn=cfg.view_transformer_include_self_attn,
            bias=cfg.bias,
            activation=cfg.activation,
            norm_type=cfg.norm_type,
            qk_norm=cfg.qk_norm,
            rope_type=cfg.rope_type,
            rope_double_max_freq=cfg.rope_double_max_freq,
            use_swin_attn=cfg.view_transformer_use_swin_attn,
            dropout=cfg.dropout,
        )
        if cfg.use_dpt_decoder:
            self.out_dpt = DPTHead(in_channels=d, features=cfg.dpt_features,
                                   out_channels=tuple(cfg.dpt_out_channels),
                                   out_dim=cfg.out_dim)
        else:
            self.out_proj = Linear(d, p * p * cfg.out_dim, bias=True)

    def pos_pe(self, pos, dtype):
        """The NeRF encoding of positions [B, S, 9] (fp32), projected and
        normed in ``dtype``."""
        pe = nerf_encode(pos, self.config.vertex_pe_num_freqs, include_input=True)
        return self.token_pos_pe_norm(self.pe_token_proj(pe.to(dtype)))

    def patchify_rays(self, ray_map):
        """[B, H, W, 3] directions -> ([B, T, c*p*p] NeRF-encoded patches in
        the ``(c p1 p2)`` order, (patch_h, patch_w))."""
        p = self.config.patch_size
        b, h, w, _ = ray_map.shape
        enc = nerf_encode(ray_map, self.config.vdir_num_freqs, include_input=True)
        c = enc.shape[-1]
        x = enc.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4)
        return x.reshape(b, (h // p) * (w // p), c * p * p), (h // p, w // p)

    def forward(self, camera_o, ray_map, tri_tokens, tri_pos, valid_mask,
                dropout_key: Optional[DropoutKey] = None):
        """camera_o [B, 3]; ray_map [B, T, 3*p*p] patch-layout directions,
        or [B, H, W, 3] with ``vdir_num_freqs != 0``; tri_tokens [Bkv, N, D]
        with Bkv dividing B (views share their scene's tokens); tri_pos
        [B, N, 9] camera-space positions; valid_mask [B, N] bool.  Returns
        the image [B, H, W, out_dim] fp32."""
        cfg = self.config
        dtype = self.ray_map_encoder.weight.dtype
        if ray_map.dim() == 4:
            ray_map, (patch_h, patch_w) = self.patchify_rays(ray_map)
        else:
            if cfg.vdir_num_freqs:
                raise ValueError('patch-layout rays need vdir_num_freqs=0; pass the '
                                 '2-D ray map [B, H, W, 3]')
            patch_h = patch_w = int(round(ray_map.shape[1] ** 0.5))
            if patch_h * patch_w != ray_map.shape[1]:
                raise ValueError(f'ray tokens {ray_map.shape[1]} do not form a square grid')
        n_tok = ray_map.shape[1]
        enc = self.ray_map_encoder(ray_map.to(dtype))
        ray_tokens = self.ray_map_patch_token.to(dtype) + self.ray_map_encoder_norm(enc)
        # position of a ray token: the camera origin tiled x3
        ray_pos = camera_o[:, None, :].repeat(1, n_tok, 3)
        if cfg.pe_type == 'nerf':
            ray_tokens = ray_tokens + self.pos_pe(ray_pos, dtype)
            tri_tokens = fan_out(tri_tokens, ray_map.shape[0]) + self.pos_pe(tri_pos, dtype)
        out_layers = tuple(cfg.dpt_tap_layers()) if cfg.use_dpt_decoder else ()
        seq, taps = self.transformer(
            ray_tokens, tri_tokens.to(dtype), valid_mask, tri_pos, ray_pos,
            out_layers=out_layers, grid=(patch_h, patch_w), key=dropout_key)
        p = cfg.patch_size
        if cfg.use_dpt_decoder:
            with annotate('rf.model.dpt'):
                img = self.out_dpt(taps, patch_h, patch_w, patch_size=p)
            return elu(img.float(), alpha=1e-3)
        dec = elu(self.out_proj(seq), alpha=1e-3)
        b, od = dec.shape[0], cfg.out_dim
        dec = dec.reshape(b, patch_h, patch_w, od, p, p).permute(0, 1, 4, 2, 5, 3)
        return dec.reshape(b, patch_h * p, patch_w * p, od).float()
