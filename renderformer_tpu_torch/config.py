"""Model configuration of the PyTorch port.

The field set is the reference architecture schema, the same as
``renderformer_tpu/config.py``, so HF-style ``config.json`` files load
unchanged into either package.  :class:`RuntimeConfig` holds only the
compute dtypes: the port runs on one CUDA device and has no sharding or
attention-backend knobs.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass(frozen=True)
class RenderFormerConfig:
    """Architecture hyper-parameters (reference config schema)."""

    # --- core view-independent transformer ---
    latent_dim: int = 768
    num_layers: int = 12
    num_heads: int = 6
    dim_feedforward: int = 768 * 4
    num_register_tokens: int = 16
    dropout: float = 0.0
    activation: str = 'swiglu'  # 'gelu' | 'swiglu'
    norm_type: str = 'rms_norm'  # 'layer_norm' | 'rms_norm'
    norm_first: bool = True
    view_indep_qk_norm: bool = True
    qk_norm: bool = True
    bias: bool = False

    # --- positional encoding ---
    pe_type: str = 'rope'  # 'nerf' | 'rope'
    rope_type: str = 'triangle'  # 'triangle' | 'triangle_learned' | 'triangle_mixed'
    rope_double_max_freq: bool = False
    vertex_pe_num_freqs: int = 12

    # --- vertex normal encoder ---
    use_vn_encoder: bool = True
    vn_pe_num_freqs: int = 6
    vn_encoder_norm_type: str = 'rms_norm'  # 'none' | 'layer_norm' | 'rms_norm'

    # --- texture patch encoder ---
    texture_encode_patch_size: int = 32
    texture_channels: int = 13  # diffuse, specular, roughness, normal, irradiance
    texture_encoder_norm_type: str = 'rms_norm'

    # --- view transformer ---
    view_transformer_latent_dim: int = 768
    view_transformer_ffn_hidden_dim: int = 768 * 4
    view_transformer_n_heads: int = 6
    view_transformer_n_layers: int = 6
    view_transformer_include_self_attn: bool = True
    view_transformer_use_swin_attn: bool = False
    vdir_pe_type: str = 'nerf'
    vdir_num_freqs: int = 0
    patch_size: int = 8
    include_alpha: bool = False
    use_dpt_decoder: bool = True
    dpt_features: int = 128
    dpt_out_channels: List[int] = field(default_factory=lambda: [96, 192, 384, 768])
    dpt_out_layers: Optional[List[int]] = None
    turn_to_cam_coord: bool = True
    use_ldr: bool = False

    @property
    def view_rope_dim(self) -> Optional[int]:
        """rope_dim of the view transformer."""
        if self.pe_type != 'rope':
            return None
        return min(
            self.vertex_pe_num_freqs,
            self.view_transformer_latent_dim // self.view_transformer_n_heads // 18 * 2,
        )

    @property
    def rope_dim(self) -> Optional[int]:
        """rope_dim of the view-independent stage."""
        if self.pe_type != 'rope':
            return None
        return self.vertex_pe_num_freqs

    @property
    def out_dim(self) -> int:
        return 4 if self.include_alpha else 3

    def dpt_tap_layers(self) -> List[int]:
        """Decoder layers whose outputs feed the DPT head."""
        if self.dpt_out_layers is not None:
            return list(self.dpt_out_layers)
        n = self.view_transformer_n_layers
        return list(range(n - 4, n))

    @classmethod
    def from_dict(cls, d: dict) -> 'RenderFormerConfig':
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @classmethod
    def from_json(cls, path: str) -> 'RenderFormerConfig':
        with open(path) as f:
            return cls.from_dict(json.load(f))


@dataclass(frozen=True)
class RuntimeConfig:
    """Compute dtypes of a render: stage 1 and the view stage (stage 2 and
    the DPT head).  RoPE, camera math and softmax statistics are fp32
    regardless."""

    compute_dtype: str = 'bfloat16'
    view_dtype: str = 'bfloat16'


V1_BASE = RenderFormerConfig()

V1_1_SWIN_LARGE = RenderFormerConfig(
    latent_dim=1024,
    num_layers=12,
    num_heads=8,
    dim_feedforward=4096,
    view_transformer_latent_dim=1024,
    view_transformer_ffn_hidden_dim=4096,
    view_transformer_n_heads=8,
    view_transformer_n_layers=12,
    view_transformer_use_swin_attn=True,
    dpt_out_channels=[128, 256, 512, 1024],
)

PRESETS = {
    'v1-base': V1_BASE,
    'v1.1-swin-large': V1_1_SWIN_LARGE,
}
