"""User-facing rendering pipeline of the port.

``render`` runs the whole render step eagerly on the pipeline's device:
HDR encode, camera-space transform, ray generation (in the view
transformer's patch layout, or the 2-D map that ``vdir_num_freqs != 0``
encodes), both transformer stages, HDR decode.  ``render_many`` renders K camera chunks
of one scene, the video path: the scene moves to the device and its
texture is HDR-encoded once, then each chunk is one ``render_fn``.
``from_pretrained`` loads a local checkpoint directory (an HF directory in
the reference layout, or either package's ``export_params``) or builds a
preset with seeded weights.

Precision map, the JAX package's: ``'bf16'``/``'bfloat16'`` and also
``'fp16'``/``'float16'`` compute in bfloat16; ``'fp32'``/``'float32'`` in
float32.  The view stage runs in the stage-1 dtype unless
``view_precision`` says otherwise.  An ``output_dtype`` of float16 clamps
the HDR image to [0, 65504] before the cast, since radiance above the
float16 maximum would become inf.

Entry points run on ``cuda`` unless the caller passes ``device='cpu'``;
asked for CUDA on a machine without it, they raise.

:data:`UPLOADS` counts the calls of ``render`` and ``render_many``, and the
bytes they moved from host memory (numpy arrays, CPU tensors) to the
pipeline's device; inputs already there add nothing.  Under a profiler
session each call is the range ``rf.render`` and its uploads
``rf.render.upload`` (``utils/profiling.annotate``).

``use_mesh`` renders on a (data, seq) mesh of the process group's ranks,
one GPU each: ``render`` gives each ``data`` rank its slice of the scenes,
splits the full attention sites over the ``seq`` ranks (ring attention
where the lengths divide the axis, else sequence-split attention:
``nn/attention.py``), and all-gathers the HDR images to every rank.  What lies outside the attention sites (the
embeddings, the norms and FFNs, the DPT head) is computed whole on every
seq rank; ``render_many`` takes no mesh.
"""

from __future__ import annotations

import copy
import os
from typing import Optional

import numpy as np
import torch

from renderformer_tpu_torch.config import PRESETS, RenderFormerConfig, RuntimeConfig
from renderformer_tpu_torch.convert import import_params, load_pretrained
from renderformer_tpu_torch.models.renderformer import RenderFormer
from renderformer_tpu_torch.nn.core import DropoutKey, cast_params, init_weights
from renderformer_tpu_torch.parallel.distributed import all_gather_cat, rank_and_world
from renderformer_tpu_torch.parallel.sharding import (
    axis_group, axis_index, axis_size, make_mesh, use_sharding)
from renderformer_tpu_torch.utils.hdr import hdr_decode_image, hdr_encode_texture
from renderformer_tpu_torch.utils.profiling import annotate
from renderformer_tpu_torch.utils.rays import generate_rays, generate_rays_patched
from renderformer_tpu_torch.utils.transform import trans_to_cam_coord

_DTYPES = {
    'bf16': torch.bfloat16, 'bfloat16': torch.bfloat16,
    'fp16': torch.bfloat16, 'float16': torch.bfloat16,
    'fp32': torch.float32, 'float32': torch.float32,
}
# calls of render/render_many, and the bytes they moved from host memory to
# the pipeline's device
UPLOADS = {'renders': 0, 'bytes': 0}

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
              resolution: int, output_dtype: Optional[torch.dtype] = None,
              texture_encoded: bool = False, dropout_key: Optional[DropoutKey] = None):
    """One render step on tensors of the model's device.

    triangles [bs, N, 3, 3], texture [bs, N, C, ps, ps], mask [bs, N] bool,
    vn [bs, N, 3, 3], c2w [bs, V, 4, 4], fov [bs, V, 1] degrees.  Returns
    HDR images [bs, V, H, W, 3].  ``texture_encoded``: the texture is
    already HDR-encoded (``render_many`` encodes it once for all chunks).
    ``dropout_key``: the train step's dropout masks (None: none)."""
    cfg = model.config
    bs, nv = c2w.shape[0], c2w.shape[1]
    if resolution % cfg.patch_size:
        raise ValueError(f'resolution {resolution} is not a multiple of the '
                         f'patch size {cfg.patch_size}')
    if cfg.texture_encode_patch_size == 1 and texture.dim() == 5:
        texture = texture[:, :, :, 0, 0]
    texture = texture.float()
    if not cfg.use_ldr and not texture_encoded:
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
    if cfg.vdir_num_freqs == 0:
        rays_o, rays_d = generate_rays_patched(c2w_view, fov / 180.0 * np.pi, resolution,
                                               cfg.patch_size)
    else:
        rays_o, rays_d = generate_rays(c2w_view, fov / 180.0 * np.pi, resolution)

    imgs = model(triangles.reshape(bs, -1, 9), texture, mask, vn.reshape(bs, -1, 9),
                 rays_o, rays_d, tris_view.reshape(bs, nv, -1, 9), dropout_key)
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
        self.mesh = None
        self._whole_noticed = False

    def use_mesh(self, mesh_shape=None) -> 'RenderingPipeline':
        """Render on a (data, seq) mesh over the process group's ranks; by
        default (1, world): every rank on ``seq``, for a batch of one scene."""
        if mesh_shape is None:
            mesh_shape = (1, rank_and_world()[1])
        self.mesh = make_mesh(mesh_shape)
        return self

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
        """A local checkpoint directory (``config.json`` +
        ``model.safetensors``: with ``jax_format.json`` the JAX tree's
        leaves, else the reference layout), or a named preset with seeded
        random weights."""
        if os.path.isdir(model_id):
            dev = resolve_device(device)
            load = (import_params if os.path.exists(os.path.join(model_id, 'jax_format.json'))
                    else load_pretrained)
            cfg, sd = load(model_id)
            # built on meta, so no init runs for weights that are replaced;
            # the fp32 master moves to the device once, in __init__
            with torch.device('meta'):
                model = RenderFormer(cfg)
            model.load_state_dict({k: v.float() if v.is_floating_point() else v
                                   for k, v in sd.items()}, strict=True, assign=True)
            return cls(model, device=dev, **kw)
        if model_id in PRESETS:
            return cls.from_config(PRESETS[model_id], seed=seed, device=device, **kw)
        raise ValueError(
            f'{model_id!r} is not a local checkpoint dir or preset name '
            f'(presets: {sorted(PRESETS)}). Hub download is not supported; '
            f'pass a directory with config.json and model.safetensors.')

    def _model_for(self, dtype, view_dtype) -> RenderFormer:
        key = (dtype, view_dtype)
        if key not in self._cast:
            m = cast_params(self.model, dtype)
            if view_dtype != dtype:
                if m is self.model:
                    m = copy.deepcopy(m)
                m.view_transformer = cast_params(self.model.view_transformer, view_dtype)
            m.fused_norm = self.runtime.fused_norm
            self._cast[key] = m
        m = self._cast[key]
        if m is self.model:
            # the fp32 master is no copy: other pipelines may share it and
            # set its norms otherwise (a walk over every module, so the
            # pipeline's own copies are set once, above)
            m.fused_norm = self.runtime.fused_norm
        return m

    def _prepare(self, precision, view_precision, output_dtype):
        """The model cast for a render's dtypes, and its output dtype."""
        if precision is None:
            precision = self.runtime.compute_dtype
            view_precision = view_precision or self.runtime.view_dtype
        dtype = _DTYPES[precision]
        view_dtype = dtype if view_precision is None else _DTYPES[view_precision]
        model = self._model_for(dtype, view_dtype)
        # pipelines may share a model, so the tail is set at every render
        if model.config.use_dpt_decoder:
            model.view_transformer.out_dpt.tail = self.runtime.dpt_tail
        return model, (_OUT_DTYPES[output_dtype] if output_dtype else None)

    def _arg(self, x, dtype) -> torch.Tensor:
        """x on the pipeline's device in ``dtype``; no copy if it is there.
        A copy from host memory adds its bytes to ``UPLOADS``."""
        x = x if torch.is_tensor(x) else np.asarray(x)
        if self.device.type != 'cpu' and (not torch.is_tensor(x) or x.device.type == 'cpu'):
            UPLOADS['bytes'] += x.nbytes
        return torch.as_tensor(x, device=self.device).to(dtype)

    def render(self, triangles, texture, mask, vn, c2w, fov, resolution: int = 512,
               precision: Optional[str] = None, view_precision: Optional[str] = None,
               output_dtype: Optional[str] = None) -> torch.Tensor:
        """Render numpy arrays or tensors; returns HDR [bs, V, H, W, 3] on the
        pipeline's device."""
        UPLOADS['renders'] += 1
        with annotate('rf.render'):
            model, out_dt = self._prepare(precision, view_precision, output_dtype)
            with torch.inference_mode():
                with annotate('rf.render.upload'):
                    args = (self._arg(triangles, torch.float32),
                            self._arg(texture, torch.float32), self._arg(mask, torch.bool),
                            self._arg(vn, torch.float32), self._arg(c2w, torch.float32),
                            self._arg(fov, torch.float32))
                if self.mesh is None:
                    return render_fn(model, *args, resolution=resolution, output_dtype=out_dt)
                return self._render_sharded(model, args, resolution, out_dt)

    __call__ = render

    def _render_sharded(self, model, args, resolution, out_dt):
        """This ``data`` rank's scenes rendered with the attention sites split
        over ``seq``; the images all-gathered over ``data``."""
        mesh = self.mesh
        nd, seq = axis_size(mesh, 'data'), axis_size(mesh, 'seq')
        bs = args[0].shape[0]
        if bs % nd:
            raise ValueError(f'a batch of {bs} scenes does not divide the data axis {nd}')
        if nd > 1:
            args = tuple(a.chunk(nd)[axis_index(mesh, 'data')] for a in args)
        if seq > 1 and not self._whole_noticed:
            self._whole_noticed = True
            print(f'NOTICE: the attention sites split over {seq} seq ranks; everything '
                  f'outside the attention sites is computed whole on every seq rank')
        with use_sharding(mesh):
            imgs = render_fn(model, *args, resolution=resolution, output_dtype=out_dt)
        return all_gather_cat(imgs, 0, axis_group(mesh, 'data') if nd > 1 else None, nd)

    def render_many(self, triangles, texture, mask, vn, c2w_seq, fov_seq,
                    resolution: int = 512, precision: Optional[str] = None,
                    view_precision: Optional[str] = None,
                    output_dtype: Optional[str] = None) -> torch.Tensor:
        """Render K camera chunks of one scene: c2w_seq [K, bs, V, 4, 4],
        fov_seq [K, bs, V, 1].  Returns HDR [K, bs, V, H, W, 3] on the
        pipeline's device.  Each chunk is ``render`` of its cameras; the
        scene moves to the device and the texture is HDR-encoded once.
        One device: raises under a mesh."""
        if self.mesh is not None:
            raise NotImplementedError('render_many is the one-device video path; '
                                      'sharded rendering uses render()')
        UPLOADS['renders'] += 1
        with annotate('rf.render'):
            model, out_dt = self._prepare(precision, view_precision, output_dtype)
            cfg = model.config
            with torch.inference_mode():
                with annotate('rf.render.upload'):
                    tris, msk, vns = (self._arg(triangles, torch.float32),
                                      self._arg(mask, torch.bool), self._arg(vn, torch.float32))
                    tex = self._arg(texture, torch.float32)
                    c2w_seq = self._arg(c2w_seq, torch.float32)
                    fov_seq = self._arg(fov_seq, torch.float32)
                if not cfg.use_ldr:
                    tex = hdr_encode_texture(tex)
                k, bs, nv = c2w_seq.shape[:3]
                out = torch.empty((k, bs, nv, resolution, resolution, cfg.out_dim),
                                  dtype=out_dt or torch.float32, device=self.device)
                for i in range(k):
                    out[i] = render_fn(model, tris, tex, msk, vns, c2w_seq[i], fov_seq[i],
                                       resolution=resolution, output_dtype=out_dt,
                                       texture_encoded=True)
                return out
