"""Model configuration of the PyTorch port.

The field set is the reference architecture schema, the same as
``renderformer_tpu/config.py``, so HF-style ``config.json`` files load
unchanged into either package.  :class:`RuntimeConfig` holds the
execution policy: compute dtypes, the DPT tail and the fused norm.  The
(data, seq) mesh of a multi-GPU render is the pipeline's
(``RenderingPipeline.use_mesh``).
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

    def get(self, key, default=None):
        return getattr(self, key, default)

    @property
    def head_dim(self) -> int:
        return self.latent_dim // self.num_heads

    @property
    def view_head_dim(self) -> int:
        return self.view_transformer_latent_dim // self.view_transformer_n_heads

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

    # --- serialization: the JAX package's config.json, byte for byte ---
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> 'RenderFormerConfig':
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @classmethod
    def from_json(cls, path: str) -> 'RenderFormerConfig':
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save_json(self, path: str) -> None:
        with open(path, 'w') as f:
            json.dump(self.to_dict(), f, indent=2)


DPT_TAILS = ('composed', 's2d', 'plain')


@dataclass(frozen=True)
class RuntimeConfig:
    """Compute dtypes of a render: stage 1 and the view stage (stage 2 and
    the DPT head).  RoPE, camera math and softmax statistics are fp32
    regardless.  ``dpt_tail`` evaluates the DPT output tail as
    ``'composed'`` (one composed 5x5 conv in space-to-depth layout, the
    JAX package's default), ``'s2d'`` or ``'plain'``; all three are the
    same function up to summation order (``nn/dpt.py``).  ``fused_norm``
    sends every RMSNorm whose shape passes the gate through kernel K11, as
    ``RFTPU_FUSE_NORM=1`` does in the JAX package.  It is on by default
    here and off there: XLA fuses the jnp norm into one pass on a TPU,
    while eager CUDA runs the torch-op norm as about nine launches over
    the tensor.  On the CPU the norm takes K11's plain version, the
    torch-op norm's arithmetic bit for bit; ``fused_norm=False`` keeps the
    torch ops everywhere.  Training has its own ``TrainConfig.fused_norm``,
    off by default."""

    compute_dtype: str = 'bfloat16'
    view_dtype: str = 'bfloat16'
    dpt_tail: str = 'composed'
    fused_norm: bool = True

    def __post_init__(self):
        if self.dpt_tail not in DPT_TAILS:
            raise ValueError(f'dpt_tail {self.dpt_tail!r} is not one of {DPT_TAILS}')


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

# the v1-base widths with NeRF positional encodings in place of triangle
# RoPE (``pe_type`` is one of the reference's ablation knobs); not a preset:
# no released checkpoint uses it
V1_BASE_NERF = dataclasses.replace(V1_BASE, pe_type='nerf')

PRESETS = {
    'v1-base': V1_BASE,
    'v1.1-swin-large': V1_1_SWIN_LARGE,
}
