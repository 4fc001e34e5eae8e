"""Render one H5 scene to per-view EXR and PNG files.

    python -m renderformer_tpu_torch.infer --h5_file scene.h5 \
        --model_id <dir|preset> [--precision bf16] [--resolution 512] \
        [--output_dir out] [--tone_mapper agx] [--cpu]

The JAX package's ``infer.py`` without its attention-backend and sharding
flags: the port runs on one CUDA device, or on the CPU with ``--cpu``.
Reading the H5 scene needs ``h5py``; ``render_scene`` takes the scene as a
dict of arrays and needs neither ``h5py`` nor ``cv2``.
"""

from __future__ import annotations

import argparse
import os
from typing import Mapping, Optional

import numpy as np

PRECISIONS = ['bf16', 'fp16', 'fp32']
TONE_MAPPERS = ['none', 'agx', 'filmic', 'pbr_neutral']


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='Infer using triangle radiosity transformer model (PyTorch/CUDA)')
    parser.add_argument('--h5_file', type=str, required=True,
                        help='Path to the input H5 file')
    parser.add_argument('--model_id', type=str, default='v1-base',
                        help='Local checkpoint dir (config.json + '
                             'model.safetensors) or preset name')
    parser.add_argument('--precision', type=str, choices=PRECISIONS, default='bf16',
                        help='Precision for inference (fp16 computes in bf16, as the '
                             'JAX package)')
    parser.add_argument('--view_precision', type=str, choices=PRECISIONS, default=None,
                        help='Stage-2 (view transformer + DPT) precision; '
                             'default = same as --precision')
    parser.add_argument('--resolution', type=int, default=512)
    parser.add_argument('--output_dir', type=str, required=False,
                        help='Output directory (default: same as input H5)')
    parser.add_argument('--tone_mapper', type=str, choices=TONE_MAPPERS, default='none')
    parser.add_argument('--cpu', action='store_true',
                        help='Run on the CPU (the kernels\' plain PyTorch versions)')
    return parser


def to_ldr(hdr: np.ndarray, tone_mapper=None) -> np.ndarray:
    """One HDR view [H, W, 3] fp32 -> uint8, tone-mapped or clipped."""
    ldr = tone_mapper.hdr_to_ldr(hdr) if tone_mapper else np.clip(hdr, 0, 1)
    return (ldr * 255).astype(np.uint8)


def render_scene(pipeline, scene: Mapping[str, np.ndarray], output_dir: str, base: str,
                 resolution: int = 512, precision: str = 'bf16',
                 view_precision: Optional[str] = None, tone_mapper=None) -> np.ndarray:
    """Render one scene dict (``triangles`` [N, 3, 3], ``texture``, ``mask``
    [N], ``vn``, ``c2w`` [V, 4, 4], ``fov`` [V]) and write
    ``<base>_view_<i>.exr`` and ``.png`` under ``output_dir``; returns the
    HDR images [1, V, H, W, 3] fp32."""
    rendered = pipeline.render(
        triangles=scene['triangles'][None], texture=scene['texture'][None],
        mask=scene['mask'][None], vn=scene['vn'][None], c2w=scene['c2w'][None],
        fov=np.asarray(scene['fov'])[None, :, None], resolution=resolution,
        precision=precision, view_precision=view_precision)
    rendered = rendered.float().cpu().numpy()
    print('Inference completed. Rendered images shape:', rendered.shape)

    from renderformer_tpu_torch.io.image import write_exr, write_png
    os.makedirs(output_dir, exist_ok=True)
    for i in range(rendered.shape[1]):
        hdr = rendered[0, i]
        hdr_path = os.path.join(output_dir, f'{base}_view_{i}.exr')
        ldr_path = os.path.join(output_dir, f'{base}_view_{i}.png')
        write_exr(hdr_path, hdr)
        write_png(ldr_path, to_ldr(hdr, tone_mapper))
        print(f'Saved {hdr_path} and {ldr_path}')
    return rendered


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from renderformer_tpu_torch.io.h5 import load_scene_h5
    from renderformer_tpu_torch.pipelines.rendering_pipeline import RenderingPipeline
    from renderformer_tpu_torch.utils.tone_map import ToneMapper

    pipeline = RenderingPipeline.from_pretrained(
        args.model_id, device='cpu' if args.cpu else None)
    tone_mapper = None
    if args.tone_mapper != 'none':
        tone_mapper = ToneMapper(args.tone_mapper)
        print(f'Using {args.tone_mapper} tone mapper')

    scene = load_scene_h5(args.h5_file)
    output_dir = args.output_dir or os.path.dirname(args.h5_file) or '.'
    base = os.path.splitext(os.path.basename(args.h5_file))[0]
    render_scene(pipeline, scene, output_dir, base, resolution=args.resolution,
                 precision=args.precision, view_precision=args.view_precision,
                 tone_mapper=tone_mapper)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
