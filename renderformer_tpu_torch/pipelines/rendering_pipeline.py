"""User-facing rendering pipeline of the port.

``render`` runs the whole render step eagerly on the pipeline's device:
HDR encode, camera-space transform, patch-layout ray generation, both
transformer stages, HDR decode.

Precision map, the JAX package's: ``'bf16'``/``'bfloat16'`` and also
``'fp16'``/``'float16'`` compute in bfloat16; ``'fp32'``/``'float32'`` in
float32.  The view stage runs in the stage-1 dtype unless
``view_precision`` says otherwise.  An ``output_dtype`` of float16 clamps
the HDR image to [0, 65504] before the cast, since radiance above the
float16 maximum would become inf.

Entry points run on ``cuda`` unless the caller passes ``device='cpu'``;
asked for CUDA on a machine without it, they raise.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from renderformer_tpu_torch.config import PRESETS, RenderFormerConfig, RuntimeConfig
from renderformer_tpu_torch.models.renderformer import RenderFormer
from renderformer_tpu_torch.nn.core import cast_params, init_weights
from renderformer_tpu_torch.utils.hdr import hdr_decode_image, hdr_encode_texture
from renderformer_tpu_torch.utils.rays import generate_rays_patched
from renderformer_tpu_torch.utils.transform import trans_to_cam_coord

_DTYPES = {
    'bf16': torch.bfloat16, 'bfloat16': torch.bfloat16,
    'fp16': torch.bfloat16, 'float16': torch.bfloat16,
    'fp32': torch.float32, 'float32': torch.float32,
}
_OUT_DTYPES = {
    'float32': torch.float32, 'fp32': torch.float32,
    'float16': torch.float16, 'fp16': torch.float16,
    'bfloat16': torch.bfloat16, 'bf16': torch.bfloat16,
}


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless told otherwise; refuses a CUDA device that is absent."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available; pass device="cpu" to run the '
                           'plain PyTorch versions on the CPU')
    return dev


def render_fn(model: RenderFormer, triangles, texture, mask, vn, c2w, fov, *,
              resolution: int, output_dtype: Optional[torch.dtype] = None):
    """One render step on tensors of the model's device.

    triangles [bs, N, 3, 3], texture [bs, N, C, ps, ps], mask [bs, N] bool,
    vn [bs, N, 3, 3], c2w [bs, V, 4, 4], fov [bs, V, 1] degrees.  Returns
    HDR images [bs, V, H, W, 3]."""
    cfg = model.config
    bs, nv = c2w.shape[0], c2w.shape[1]
    if resolution % cfg.patch_size:
        raise ValueError(f'resolution {resolution} is not a multiple of the '
                         f'patch size {cfg.patch_size}')
    if cfg.texture_encode_patch_size == 1 and texture.dim() == 5:
        texture = texture[:, :, :, 0, 0]
    texture = texture.float()
    if not cfg.use_ldr:
        texture = hdr_encode_texture(texture)

    if cfg.turn_to_cam_coord:
        tris_rep = triangles[:, None].expand(bs, nv, *triangles.shape[1:])
        tris_view, c2w_view, _ = trans_to_cam_coord(
            c2w.reshape(-1, 4, 4), tris_rep.reshape(bs * nv, *triangles.shape[1:]))
        tris_view = tris_view.reshape(bs, nv, -1, 3, 3)
        c2w_view = c2w_view.reshape(bs, nv, 4, 4)
    else:
        tris_view = triangles[:, None].expand(bs, nv, *triangles.shape[1:])
        c2w_view = c2w
    rays_o, rays_d = generate_rays_patched(c2w_view, fov / 180.0 * np.pi, resolution,
                                           cfg.patch_size)

    imgs = model(triangles.reshape(bs, -1, 9), texture, mask, vn.reshape(bs, -1, 9),
                 rays_o, rays_d, tris_view.reshape(bs, nv, -1, 9))
    imgs = imgs.float()
    if not cfg.use_ldr:
        imgs = hdr_decode_image(imgs)
    if output_dtype is not None:
        if output_dtype == torch.float16:
            imgs = torch.clamp(imgs, 0.0, 65504.0)
        imgs = imgs.to(output_dtype)
    return imgs


class RenderingPipeline:
    """Holds a model with fp32 master weights on one device, and its
    weight copies cast to each compute dtype asked for."""

    def __init__(self, model: RenderFormer, runtime: Optional[RuntimeConfig] = None,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.config = model.config
        self.runtime = runtime or RuntimeConfig()
        self._cast = {}

    @classmethod
    def from_config(cls, config: RenderFormerConfig, seed: int = 0, device=None, **kw):
        """A model of ``config`` with seeded random weights."""
        dev = resolve_device(device)
        with torch.device('meta'):
            model = RenderFormer(config)
        model = model.to_empty(device='cpu')
        init_weights(model, torch.Generator().manual_seed(seed))
        return cls(model, device=dev, **kw)

    @classmethod
    def from_pretrained(cls, model_id: str, seed: int = 0, device=None, **kw):
        """A named preset with seeded random weights.  Loading a local
        checkpoint directory is not ported yet."""
        if model_id in PRESETS:
            return cls.from_config(PRESETS[model_id], seed=seed, device=device, **kw)
        raise ValueError(f'{model_id!r} is not a preset name (presets: '
                         f'{sorted(PRESETS)}); checkpoint loading is not ported yet')

    def _model_for(self, dtype, view_dtype) -> RenderFormer:
        key = (dtype, view_dtype)
        if key not in self._cast:
            m = cast_params(self.model, dtype)
            if view_dtype != dtype:
                if m is self.model:
                    m = copy.deepcopy(m)
                m.view_transformer = cast_params(self.model.view_transformer, view_dtype)
            self._cast[key] = m
        return self._cast[key]

    def render(self, triangles, texture, mask, vn, c2w, fov, resolution: int = 512,
               precision: Optional[str] = None, view_precision: Optional[str] = None,
               output_dtype: Optional[str] = None) -> torch.Tensor:
        """Render numpy arrays or tensors; returns HDR [bs, V, H, W, 3] on the
        pipeline's device."""
        if precision is None:
            precision = self.runtime.compute_dtype
            view_precision = view_precision or self.runtime.view_dtype
        dtype = _DTYPES[precision]
        view_dtype = dtype if view_precision is None else _DTYPES[view_precision]
        out_dt = _OUT_DTYPES[output_dtype] if output_dtype else None
        model = self._model_for(dtype, view_dtype)

        def arg(x, dt):
            return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                                   device=self.device).to(dt)

        with torch.inference_mode():
            return render_fn(model, arg(triangles, torch.float32),
                             arg(texture, torch.float32), arg(mask, torch.bool),
                             arg(vn, torch.float32), arg(c2w, torch.float32),
                             arg(fov, torch.float32), resolution=resolution,
                             output_dtype=out_dt)

    __call__ = render
