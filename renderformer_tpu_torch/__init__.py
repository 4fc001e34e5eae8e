"""PyTorch/CUDA port of renderformer_tpu for one NVIDIA H100.

The JAX package ``renderformer_tpu`` stays the reference; this package
imports nothing of it.  Its hand-written kernels (``csrc/``) build at first
use; on CPU tensors each kernel's plain PyTorch version runs instead.
"""

from renderformer_tpu_torch.config import (
    PRESETS, RenderFormerConfig, RuntimeConfig, V1_1_SWIN_LARGE, V1_BASE)
from renderformer_tpu_torch.pipelines.rendering_pipeline import RenderingPipeline

__all__ = ['PRESETS', 'RenderFormerConfig', 'RuntimeConfig', 'RenderingPipeline',
           'V1_BASE', 'V1_1_SWIN_LARGE']
