"""Render one H5 scene to per-view EXR and PNG files.

    python -m renderformer_tpu_torch.infer --h5_file scene.h5 \
        --model_id <dir|preset> [--precision bf16] [--resolution 512] \
        [--output_dir out] [--tone_mapper agx] [--attn_impl auto] [--shard] [--cpu]

The JAX package's ``infer.py``.  ``--attn_impl`` is the JAX command
line's, accepted and checked here: ``auto`` and ``flash`` run the
attention kernels; ``xla``, the plain versions, is what ``--cpu`` runs
anyway, and on the card it is an error (the port has no library
attention path).  ``--shard`` renders on a (1, world) mesh of the process group that
torchrun's environment describes, one GPU a process, the attention sites
split over the ranks (``torchrun --nproc_per_node=N -m
renderformer_tpu_torch.infer --shard ...``; rank 0 writes the files); in
one process it renders as without it and says so.  The H5 scene is read
by the port's ``io/hdf5`` (no ``h5py``); ``render_scene`` takes the scene
as a dict of arrays and needs no ``cv2``.
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
    add_parallel_flags(parser)
    parser.add_argument('--cpu', action='store_true',
                        help='Run on the CPU (the kernels\' plain PyTorch versions)')
    return parser


def add_parallel_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument('--attn_impl', type=str, choices=['auto', 'xla', 'flash'],
                        default='auto',
                        help='auto/flash: the attention kernels; xla: their plain '
                             'versions (with --cpu only)')
    parser.add_argument('--shard', action='store_true',
                        help='Shard inference over the ranks of the process group '
                             '(torchrun; a (1, world) data x seq mesh)')


def check_attn_impl(impl: str, device: torch.device) -> None:
    """Refuse ``--attn_impl xla`` off the CPU: ``auto`` and ``flash`` run
    the kernels, ``xla`` the plain versions, which the CPU runs anyway."""
    if impl == 'xla' and device.type != 'cpu':
        raise ValueError("--attn_impl xla runs the attention's plain versions, which the "
                         "port takes on the CPU only (--cpu): it has no library attention "
                         "path on the card; auto and flash run the kernels")


def open_pipeline(args):
    """The pipeline of ``args.model_id`` after ``--attn_impl`` is checked;
    with ``--shard`` in a process group of more than one rank, on its
    (1, world) mesh.  Returns (pipeline, whether this process writes,
    whether a group was made)."""
    from renderformer_tpu_torch.parallel.distributed import (
        rank_and_world, setup_distributed)
    from renderformer_tpu_torch.pipelines.rendering_pipeline import (
        RenderingPipeline, resolve_device)
    device = 'cpu' if args.cpu else None
    check_attn_impl(args.attn_impl, resolve_device(device))
    grouped = setup_distributed(device=device) if args.shard else False
    pipeline = RenderingPipeline.from_pretrained(args.model_id, device=device)
    rank, world = rank_and_world()
    if args.shard:
        if world > 1:
            pipeline.use_mesh()
            if rank == 0:
                print(f'sharded inference over mesh {tuple(pipeline.mesh.shape)}')
        else:
            print('NOTICE: --shard with one device (no process group of more than one '
                  'rank): rendering unsharded')
    return pipeline, rank == 0, grouped


def to_ldr(hdr: np.ndarray, tone_mapper=None) -> np.ndarray:
    """One HDR view [H, W, 3] fp32 -> uint8, tone-mapped or clipped."""
    ldr = tone_mapper.hdr_to_ldr(hdr) if tone_mapper else np.clip(hdr, 0, 1)
    return (ldr * 255).astype(np.uint8)


def render_scene(pipeline, scene: Mapping[str, np.ndarray], output_dir: str, base: str,
                 resolution: int = 512, precision: str = 'bf16',
                 view_precision: Optional[str] = None, tone_mapper=None) -> np.ndarray:
    """Render one scene dict (``triangles`` [N, 3, 3], ``texture``, ``mask``
    [N], ``vn``, ``c2w`` [V, 4, 4], ``fov`` [V]) and write
    ``<base>_view_<i>.exr`` and ``.png`` under ``output_dir`` (nothing when
    it is None); returns the HDR images [1, V, H, W, 3] fp32."""
    rendered = pipeline.render(
        triangles=scene['triangles'][None], texture=scene['texture'][None],
        mask=scene['mask'][None], vn=scene['vn'][None], c2w=scene['c2w'][None],
        fov=np.asarray(scene['fov'])[None, :, None], resolution=resolution,
        precision=precision, view_precision=view_precision)
    rendered = rendered.float().cpu().numpy()
    print('Inference completed. Rendered images shape:', rendered.shape)
    if output_dir is None:
        return rendered

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
    from renderformer_tpu_torch.parallel.distributed import teardown_distributed
    from renderformer_tpu_torch.utils.tone_map import ToneMapper

    pipeline, writes, grouped = open_pipeline(args)
    try:
        tone_mapper = None
        if args.tone_mapper != 'none':
            tone_mapper = ToneMapper(args.tone_mapper)
            print(f'Using {args.tone_mapper} tone mapper')

        scene = load_scene_h5(args.h5_file)
        output_dir = args.output_dir or os.path.dirname(args.h5_file) or '.'
        base = os.path.splitext(os.path.basename(args.h5_file))[0]
        if not writes:
            output_dir = None
        render_scene(pipeline, scene, output_dir, base, resolution=args.resolution,
                     precision=args.precision, view_precision=args.view_precision,
                     tone_mapper=tone_mapper)
        return 0
    finally:
        if grouped:
            teardown_distributed()


if __name__ == '__main__':
    raise SystemExit(main())
