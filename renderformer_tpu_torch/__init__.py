"""PyTorch/CUDA port of renderformer_tpu for one NVIDIA H100.

The JAX package ``renderformer_tpu`` stays the reference; this package
imports nothing of it.  Its hand-written kernels (``csrc/``) build at first
use; on CPU tensors each kernel's plain PyTorch version runs instead.
``RenderingPipeline.from_pretrained`` loads a local checkpoint directory
that ``export_params`` (or the JAX package's) wrote, or an HF directory in
the reference layout; ``python -m renderformer_tpu_torch.infer``,
``.batch_infer``, ``.train`` (fine-tuning), ``.scene.convert_scene``,
``.render_h5_to_png`` and ``.generate_dataset`` (scenes and their
path-traced ground truth) are the command lines.
"""

from renderformer_tpu_torch.config import (
    PRESETS, RenderFormerConfig, RuntimeConfig, V1_1_SWIN_LARGE, V1_BASE, V1_BASE_NERF)
from renderformer_tpu_torch.pipelines.rendering_pipeline import RenderingPipeline
from renderformer_tpu_torch.training.checkpoint import export_params

__all__ = ['PRESETS', 'RenderFormerConfig', 'RuntimeConfig', 'RenderingPipeline',
           'V1_BASE', 'V1_BASE_NERF', 'V1_1_SWIN_LARGE', 'export_params']
