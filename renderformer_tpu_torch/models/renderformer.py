"""RenderFormer: view-independent triangle light transport (stage 1) and
the dispatch into the view-dependent decoder (stage 2).

Register tokens take the mask-weighted scene centroid, computed in fp32,
as their RoPE position.  Stage-1 tokens are not copied per view: with
triangle RoPE (``pe_type='rope'``) the decoder's K/V projections read them
once per scene, and masks and camera-space positions stay per view.  With
``pe_type='nerf'`` a NeRF encoding of the vertex positions is added to the
triangle embeddings, and the view stage fans the tokens out per view,
since their camera-space encoding differs between views.

The port renders the released architecture family and its ablations:
triangle RoPE or NeRF positions, patch-layout rays (``vdir_num_freqs=0``)
or a NeRF-encoded 2-D ray map, the DPT head or the linear head, and full
or Swin window self-attention in the view stage; ``pe_type='learned'``
raises.  A :class:`~renderformer_tpu_torch.nn.core.DropoutKey` turns on
the config's dropout: the encoder takes the key folded with 0, the view
stage with 1, as the JAX package splits its dropout rng in two.  Under a
profiler session stage 1 is the range ``rf.model.encoder`` and the call of
the view stage ``rf.model.view``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from renderformer_tpu_torch.config import RenderFormerConfig
from renderformer_tpu_torch.encodings.nerf import nerf_encode, nerf_out_dim
from renderformer_tpu_torch.models.view_transformer import ViewTransformer
from renderformer_tpu_torch.nn.attention import TransformerEncoder
from renderformer_tpu_torch.nn.core import DropoutKey, Linear, RMSNorm, make_norm
from renderformer_tpu_torch.utils.profiling import annotate


def check_supported(cfg: RenderFormerConfig) -> None:
    if cfg.pe_type not in ('rope', 'nerf'):
        raise NotImplementedError(f"not ported yet: pe_type {cfg.pe_type!r} not in "
                                  "('rope', 'nerf')")


class RenderFormer(nn.Module):
    def __init__(self, config: RenderFormerConfig):
        super().__init__()
        check_supported(config)
        cfg = config
        self.config = cfg
        d = cfg.latent_dim
        tex_in = cfg.texture_channels * cfg.texture_encode_patch_size ** 2
        self.tri_token = nn.Parameter(torch.zeros(1, 1, d))
        self.reg_tokens = nn.Parameter(torch.zeros(1, cfg.num_register_tokens, d))
        self.texture_encoder = Linear(tex_in, d, bias=True)
        self.texture_encoder_norm = make_norm(cfg.texture_encoder_norm_type, d)
        if cfg.use_vn_encoder:
            self.vn_encoding_proj = Linear(
                nerf_out_dim(9, cfg.vn_pe_num_freqs, include_input=True), d, bias=True)
            self.vn_encoder_norm = make_norm(cfg.vn_encoder_norm_type, d)
        if cfg.pe_type == 'nerf':
            self.tri_encoding_proj = Linear(
                nerf_out_dim(9, cfg.vertex_pe_num_freqs, include_input=True), d, bias=True)
            # the JAX package builds this norm with the vn encoder's type
            self.tri_encoding_norm = make_norm(cfg.vn_encoder_norm_type, d)
        self.transformer = TransformerEncoder(
            num_layers=cfg.num_layers, num_heads=cfg.num_heads, hidden_dim=d,
            ffn_hidden_dim=cfg.dim_feedforward, rope_dim=cfg.rope_dim, bias=cfg.bias,
            activation=cfg.activation, norm_type=cfg.norm_type,
            rope_type=cfg.rope_type, rope_double_max_freq=cfg.rope_double_max_freq,
            qk_norm=cfg.view_indep_qk_norm, dropout=cfg.dropout)
        self.view_transformer = ViewTransformer(cfg)

    @property
    def remat(self) -> bool:
        """Gradient checkpointing of every transformer block of both stages
        (the JAX package's ``RenderFormer.remat``)."""
        return self.transformer.remat

    @remat.setter
    def remat(self, on: bool) -> None:
        self.transformer.remat = bool(on)
        self.view_transformer.transformer.remat = bool(on)

    @property
    def fused_norm(self) -> bool:
        """Whether the RMSNorms take kernel K11 where its gate passes (the
        JAX package's ``RFTPU_FUSE_NORM``)."""
        return any(m.fused for m in self.modules() if isinstance(m, RMSNorm))

    @fused_norm.setter
    def fused_norm(self, on: bool) -> None:
        for m in self.modules():
            if isinstance(m, RMSNorm):
                m.fused = bool(on)

    def process_tri_vpos(self, tri_vpos, valid_mask):
        """Prepend the mask-weighted scene centroid (tiled x3) as the RoPE
        position of the register tokens; fp32."""
        n_reg = self.config.num_register_tokens
        pos = tri_vpos.float()
        maskf = valid_mask.float()
        weight = maskf / (maskf.sum(dim=1, keepdim=True) + 1e-5)
        center = (weight[..., None] * pos).sum(dim=1).reshape(-1, 3, 3).mean(dim=1)
        center = center[:, None, :].repeat(1, n_reg, 3)
        pos_out = torch.cat([center, pos], dim=1)
        mask_out = torch.cat([torch.ones(pos.shape[0], n_reg, dtype=torch.bool,
                                         device=pos.device), valid_mask], dim=1)
        return pos_out, mask_out

    def construct_seq(self, tri_vpos, texture_patches, valid_mask, vns):
        """Stage-1 tokens [B, R+N, D], their mask [B, R+N] and RoPE
        positions [B, R+N, 9], in the dtype of the weights."""
        cfg = self.config
        dtype = self.texture_encoder.weight.dtype
        b, n = tri_vpos.shape[0], tri_vpos.shape[1]
        tex = texture_patches.reshape(b, n, -1).to(dtype)
        tri_emb = (self.tri_token.to(dtype)
                   + self.texture_encoder_norm(self.texture_encoder(tex)))
        if cfg.use_vn_encoder:
            vn_pe = nerf_encode(vns.float(), cfg.vn_pe_num_freqs,
                                include_input=True).to(dtype)
            tri_emb = tri_emb + self.vn_encoder_norm(self.vn_encoding_proj(vn_pe))
        if cfg.pe_type == 'nerf':
            pe = nerf_encode(tri_vpos.float(), cfg.vertex_pe_num_freqs,
                             include_input=True).to(dtype)
            tri_emb = tri_emb + self.tri_encoding_norm(self.tri_encoding_proj(pe))
        reg = self.reg_tokens.to(dtype).expand(b, -1, -1)
        seq = torch.cat([reg, tri_emb], dim=1)
        rope_pos, mask = self.process_tri_vpos(tri_vpos, valid_mask)
        return seq, mask, rope_pos

    def forward(self, tri_vpos, texture_patches, valid_mask, vns, rays_o, rays_d,
                tri_vpos_view_tf, dropout_key: Optional[DropoutKey] = None):
        """tri_vpos [B, N, 9]; texture_patches [B, N, C, ps, ps]; valid_mask
        [B, N] bool; vns [B, N, 9]; rays_o [B, V, 3]; rays_d [B, V, T, 3*p*p]
        (patch layout) or, with ``vdir_num_freqs != 0``, [B, V, H, W, 3];
        tri_vpos_view_tf [B, V, N, 9] camera-space positions.  Returns
        images [B, V, H, W, out_dim] fp32."""
        enc_key = view_key = None
        if dropout_key is not None and self.config.dropout > 0.0:
            enc_key, view_key = dropout_key.fold(0), dropout_key.fold(1)
        with annotate('rf.model.encoder'):
            seq, mask_padded, rope_pos = self.construct_seq(
                tri_vpos, texture_patches, valid_mask, vns)
            seq = self.transformer(seq, mask_padded, rope_pos, enc_key)

        b, v = rays_o.shape[0], rays_o.shape[1]
        n_tok = seq.shape[1]
        mask_bv = mask_padded[:, None].expand(b, v, n_tok).reshape(b * v, n_tok).contiguous()
        valid_bv = valid_mask[:, None].expand(b, v, valid_mask.shape[1]).reshape(b * v, -1)
        tri_view = tri_vpos_view_tf.reshape(b * v, *tri_vpos_view_tf.shape[2:])
        pos_seq, _ = self.process_tri_vpos(tri_view, valid_bv)
        with annotate('rf.model.view'):
            img = self.view_transformer(
                rays_o.reshape(b * v, 3), rays_d.reshape(b * v, *rays_d.shape[2:]),
                seq, pos_seq, mask_bv, view_key)
        return img.reshape(b, v, *img.shape[1:])
