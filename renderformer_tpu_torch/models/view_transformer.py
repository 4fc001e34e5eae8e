"""Stage 2: view-dependent ray decoding.

Patch-layout ray tokens -> cross/self-attention decoder over the stage-1
triangle tokens -> DPT head -> ELU(alpha=1e-3).  The view stage runs in
the dtype of its weights.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from renderformer_tpu_torch.config import RenderFormerConfig
from renderformer_tpu_torch.nn.attention import TransformerDecoder
from renderformer_tpu_torch.nn.core import elu, make_norm
from renderformer_tpu_torch.nn.dpt import DPTHead


class ViewTransformer(nn.Module):
    def __init__(self, config: RenderFormerConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        d = cfg.view_transformer_latent_dim
        self.ray_map_patch_token = nn.Parameter(torch.zeros(1, 1, d))
        self.ray_map_encoder = nn.Linear(3 * cfg.patch_size * cfg.patch_size, d, bias=True)
        self.ray_map_encoder_norm = make_norm(cfg.norm_type, d)
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
        )
        self.out_dpt = DPTHead(in_channels=d, features=cfg.dpt_features,
                               out_channels=tuple(cfg.dpt_out_channels),
                               out_dim=cfg.out_dim)

    def forward(self, camera_o, ray_map, tri_tokens, tri_pos, valid_mask):
        """camera_o [B, 3]; ray_map [B, T, 3*p*p] patch-layout directions;
        tri_tokens [Bkv, N, D] with Bkv dividing B (views share their
        scene's tokens); tri_pos [B, N, 9] camera-space positions;
        valid_mask [B, N] bool.  Returns the image [B, H, W, out_dim] fp32."""
        cfg = self.config
        dtype = self.ray_map_encoder.weight.dtype
        n_tok = ray_map.shape[1]
        patch_h = patch_w = int(round(n_tok ** 0.5))
        if patch_h * patch_w != n_tok:
            raise ValueError(f'ray tokens {n_tok} do not form a square grid')
        enc = self.ray_map_encoder(ray_map.to(dtype))
        ray_tokens = self.ray_map_patch_token.to(dtype) + self.ray_map_encoder_norm(enc)
        # RoPE position of a ray token: the camera origin tiled x3
        ray_pos = camera_o[:, None, :].repeat(1, n_tok, 3)
        _, taps = self.transformer(
            ray_tokens, tri_tokens.to(dtype), valid_mask, tri_pos, ray_pos,
            out_layers=tuple(cfg.dpt_tap_layers()))
        img = self.out_dpt(taps, patch_h, patch_w, patch_size=cfg.patch_size)
        return elu(img.float(), alpha=1e-3)
