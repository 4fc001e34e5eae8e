"""Render a folder of per-frame H5 scenes to per-view EXR and PNG files
and an MP4.

    python -m renderformer_tpu_torch.batch_infer --h5_folder frames/ \
        --model_id <dir|preset> [--batch_size 8 --padding_length 4096] \
        [--video_mode auto|on|off] [--frames_per_call 4] [--no_output] \
        [--attn_impl auto|xla|flash] [--shard] [--cpu]

The JAX package's ``batch_infer.py``.  ``--attn_impl`` and ``--shard`` are
``infer``'s: under torchrun ``--shard`` renders each batch on a (1, world)
mesh, rank 0 writing; it takes the per-batch path (``--video_mode on``
with it is an error, ``auto`` says so).  Two paths: frames batched with static-shape padding
(``render`` a batch), and, where the frames share one scene and differ only
in their cameras, the video path (the scene moves to the device once and
``render_many`` renders ``--frames_per_call`` chunks of ``--batch_size``
views a call).  The H5 files are read by the port's ``io/hdf5`` (no
``h5py``); writing the video
needs ``cv2``, which is imported before the first render so that a missing
``cv2`` fails at once.  ``run_batches`` and ``run_video`` take iterables of
the dicts that ``SceneFolderDataset.batches`` and
``VideoSceneDataset.view_chunks`` yield.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from renderformer_tpu_torch.infer import (
    PRECISIONS, TONE_MAPPERS, add_parallel_flags, open_pipeline, to_ldr)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='Batch inference using triangle radiosity transformer (PyTorch/CUDA)')
    parser.add_argument('--h5_folder', type=str, required=True)
    parser.add_argument('--model_id', type=str, default='v1-base')
    parser.add_argument('--precision', type=str, choices=PRECISIONS, default='bf16')
    parser.add_argument('--view_precision', type=str, choices=PRECISIONS, default=None,
                        help='Stage-2 precision; default = --precision')
    parser.add_argument('--resolution', type=int, default=512)
    parser.add_argument('--batch_size', type=int, default=8)
    parser.add_argument('--padding_length', type=int, default=None,
                        help='Pad all scenes to this triangle count '
                             '(required for batch_size > 1)')
    parser.add_argument('--output_dir', type=str, default=None)
    parser.add_argument('--save_video', action='store_true', default=True)
    parser.add_argument('--fps', type=int, default=24)
    parser.add_argument('--tone_mapper', type=str, choices=TONE_MAPPERS, default='none')
    add_parallel_flags(parser)
    parser.add_argument('--cpu', action='store_true',
                        help='Run on the CPU (the kernels\' plain PyTorch versions)')
    parser.add_argument('--video_mode', choices=['auto', 'on', 'off'], default='auto',
                        help='Static-scene path: move the scene to the device '
                             'once, stream only cameras per frame, render '
                             'frames as views of the device-resident scene. '
                             'auto = probe whether frames 0/1 share scene '
                             'tensors bitwise')
    parser.add_argument('--transfer_dtype', choices=['float32', 'float16'],
                        default='float16',
                        help='Device->host image dtype: float16 halves '
                             'transfer bytes at EXR-half precision '
                             '(radiance is clamped to the fp16 max 65504 '
                             'on device; pass float32 for unquantized HDR)')
    parser.add_argument('--frames_per_call', type=int, default=4,
                        help='Video mode: camera chunks rendered per '
                             'render_many call')
    parser.add_argument('--no_output', action='store_true',
                        help='Benchmark mode: skip image fetch + file '
                             'writes, sync each batch with a 1-element '
                             'fetch (measures the device render path '
                             'without host-transfer cost)')
    return parser


class Output:
    """The overlap of the two loops: one render in flight while the last
    one's images are fetched and handed to a writer pool, or, with
    ``--no_output``, a one-element fetch of the last render as the sync.

    Pipelined timing (both paths): window i measures the enqueue of render
    i and the fetch of render i-1, so a window is one render through the
    pipeline only in steady state; the first window (enqueue only) is
    dropped by ``summary(warmup=1)`` and the last render's fetch lands
    outside every window, so the rays/s line needs >= 3 batches."""

    def __init__(self, args, output_dir: str, tone_mapper=None):
        from renderformer_tpu_torch.io.image import write_exr, write_png
        from renderformer_tpu_torch.utils.prefetch import AsyncWriter
        if args.save_video and not args.no_output:
            import cv2  # noqa: F401  write_video's module: fail before rendering
        self.args, self.output_dir, self.tone_mapper = args, output_dir, tone_mapper
        self._write_exr, self._write_png = write_exr, write_png
        self.writer = AsyncWriter(max_workers=max(2, os.cpu_count() or 2))
        self.video_slots: Dict[int, np.ndarray] = {}
        self.frame_counter = 0
        self._inflight: List = []
        self._prev: Optional[torch.Tensor] = None

    def _postprocess(self, hdr, exr_path, png_path, frame_idx):
        """Tone map, encode and write one view (on the writer pool)."""
        ldr_u8 = to_ldr(hdr, self.tone_mapper)
        self._write_exr(exr_path, hdr)
        self._write_png(png_path, ldr_u8)
        if frame_idx is not None:
            self.video_slots[frame_idx] = ldr_u8

    def _flush(self, rendered_dev: torch.Tensor, views: Sequence[Tuple[tuple, str, int]]):
        """Fetch a finished render; hand each (index, file, view) to the pool."""
        rendered = rendered_dev.cpu().numpy()
        bases = []
        for idx, file_path, view_idx in views:
            base = os.path.splitext(os.path.basename(file_path))[0]
            self.writer.submit(
                self._postprocess, rendered[idx].astype(np.float32),
                os.path.join(self.output_dir, f'{base}_view_{view_idx}.exr'),
                os.path.join(self.output_dir, f'{base}_view_{view_idx}.png'),
                self.frame_counter if self.args.save_video else None)
            self.frame_counter += 1
            if not bases or bases[-1] != base:
                bases.append(base)
        for base in bases:
            print(f'Rendered {base}')

    def put(self, rendered_dev: torch.Tensor, views):
        if self.args.no_output:
            if self._prev is not None:
                self._prev.reshape(-1)[:1].cpu()
            self._prev = rendered_dev
        else:
            self._inflight.append((rendered_dev, views))
            if len(self._inflight) > 1:
                self._flush(*self._inflight.pop(0))

    def close(self) -> List[np.ndarray]:
        """Drain every render and write; returns the video frames in order."""
        for item in self._inflight:
            self._flush(*item)
        self._inflight = []
        if self._prev is not None:
            self._prev.reshape(-1)[:1].cpu()
            self._prev = None
        self.writer.close()
        return [self.video_slots[k] for k in sorted(self.video_slots)]


def run_batches(pipeline, batches: Iterable[dict], out: Output, args):
    """The per-batch loop: ``render`` each stacked batch dict; returns the
    ThroughputMeter."""
    from renderformer_tpu_torch.utils.prefetch import prefetch
    from renderformer_tpu_torch.utils.profiling import ThroughputMeter
    meter = None
    for batch in prefetch(batches, depth=2):
        if meter is None:
            meter = ThroughputMeter(
                resolution=args.resolution, views_per_step=batch['c2w'].shape[1],
                batch_size=batch['c2w'].shape[0],
                triangle_tokens=batch['triangles'].shape[1])
        meter.start()
        rendered_dev = pipeline.render(
            triangles=batch['triangles'], texture=batch['texture'], mask=batch['mask'],
            vn=batch['vn'], c2w=batch['c2w'], fov=batch['fov'][..., None],
            resolution=args.resolution, precision=args.precision,
            view_precision=args.view_precision, output_dtype=args.transfer_dtype)
        views = [((i, v), fp, v) for i, fp in enumerate(batch['file_paths'])
                 for v in range(batch['c2w'].shape[1])]
        out.put(rendered_dev, views)
        meter.stop()
    return meter


def _grouped(chunks: Iterable[dict], k: int):
    """Groups of k camera chunks, the last one short."""
    group = []
    for chunk in chunks:
        group.append(chunk)
        if len(group) == k:
            yield group
            group = []
    if group:
        yield group


def run_video(pipeline, scene: Dict[str, np.ndarray], chunks: Iterable[dict],
              out: Output, args):
    """The video loop: the scene (unbatched arrays) on the device once, then
    ``render_many`` over groups of ``--frames_per_call`` camera chunks (a
    short last group padded by its last chunk, whose images are dropped);
    returns the ThroughputMeter."""
    from renderformer_tpu_torch.utils.prefetch import prefetch
    from renderformer_tpu_torch.utils.profiling import ThroughputMeter
    dev = {k: torch.as_tensor(np.asarray(scene[k])[None], device=pipeline.device)
           for k in ('triangles', 'texture', 'mask', 'vn')}
    kpc = max(1, args.frames_per_call)
    meter = None
    for group in prefetch(_grouped(chunks, kpc), depth=2):
        if meter is None:
            meter = ThroughputMeter(
                resolution=args.resolution, views_per_step=kpc * group[0]['c2w'].shape[1],
                batch_size=1, triangle_tokens=scene['triangles'].shape[0])
        padded = group + [group[-1]] * (kpc - len(group))
        c2w_seq = np.stack([c['c2w'] for c in padded])
        fov_seq = np.stack([c['fov'][..., None] for c in padded])
        meter.start()
        rendered_dev = pipeline.render_many(
            dev['triangles'], dev['texture'], dev['mask'], dev['vn'], c2w_seq, fov_seq,
            resolution=args.resolution, precision=args.precision,
            view_precision=args.view_precision, output_dtype=args.transfer_dtype)
        views = [((ci, 0, i), fp, v) for ci, chunk in enumerate(group)
                 for i, (fp, v) in enumerate(chunk['entries'])]
        out.put(rendered_dev, views)
        meter.stop()
    return meter


def report(meter) -> None:
    """The rays/s line of a loop's ThroughputMeter."""
    summary = meter.summary() if meter is not None else {}
    if summary:
        qualifier = '' if len(meter._times) >= 3 else ', <3 batches: not steady-state'
        print('throughput: %.0f rays/s median / %.0f rays/s mean '
              '(steady-state pipelined; median %.3fs mean %.3fs per '
              'batch, first batch excluded; median is robust to the '
              'one-time weight/scene-upload window%s)' % (
                  summary['rays_per_s_median'], summary['rays_per_s'],
                  summary['median_step_s'], summary['mean_step_s'], qualifier),
              flush=True)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.video_mode == 'on' and args.shard:
        # an explicit request that cannot be honoured fails loudly
        parser.error('--video_mode on is incompatible with --shard (the video path is '
                     'one device); drop --shard or use --video_mode auto/off')

    from renderformer_tpu_torch.parallel.distributed import teardown_distributed

    pipeline, writes, grouped = open_pipeline(args)
    try:
        return run(args, pipeline, writes)
    finally:
        if grouped:
            teardown_distributed()


def run(args, pipeline, writes: bool = True) -> int:
    """main() after the pipeline is open; a rank that does not write renders
    as with ``--no_output``."""
    from renderformer_tpu_torch.io.h5 import (
        SceneFolderDataset, VideoSceneDataset, list_scene_files, probe_static_scene)
    from renderformer_tpu_torch.io.image import write_video
    from renderformer_tpu_torch.utils.tone_map import ToneMapper

    if not writes:
        args.no_output = True
    tone_mapper = None
    if args.tone_mapper != 'none':
        tone_mapper = ToneMapper(args.tone_mapper)
        print(f'Using {args.tone_mapper} tone mapper')

    files = list_scene_files(args.h5_folder)
    print(f'Found {len(files)} h5 files in {args.h5_folder}')
    if len(files) == 0:
        return 1

    use_video = not args.shard and (args.video_mode == 'on' or (
        args.video_mode == 'auto' and probe_static_scene(files)))
    if args.shard and args.video_mode == 'auto' and len(files) > 1:
        print('NOTICE: --shard disables the static-scene video path; frames render '
              'through the sharded per-batch path')
    if args.video_mode == 'auto' and use_video and len(files) > 1:
        print('video mode: static scene detected (frames 0/1 share scene '
              'tensors bitwise); moving the scene to the device once, streaming '
              'cameras. Pass --video_mode off to disable.')
    if not use_video and args.batch_size > 1 and args.padding_length is None:
        print('NOTICE: batch_size > 1 requires --padding_length '
              '(static shapes across frames); falling back to '
              'batch_size=1 — pass --padding_length to batch frames together')
        args.batch_size = 1

    output_dir = args.output_dir or args.h5_folder
    os.makedirs(output_dir, exist_ok=True)
    out = Output(args, output_dir, tone_mapper)
    if use_video:
        ds = VideoSceneDataset(args.h5_folder)
        meter = run_video(pipeline, ds.scene, ds.view_chunks(args.batch_size), out, args)
    else:
        dataset = SceneFolderDataset(args.h5_folder, args.padding_length)
        meter = run_batches(pipeline, dataset.batches(args.batch_size), out, args)
    video_frames = out.close()
    print(f'Output saved to: {output_dir}')
    report(meter)
    if args.save_video and video_frames:
        video_path = os.path.join(output_dir, 'video.mp4')
        write_video(video_path, video_frames, fps=args.fps)
        print(f'Video saved to: {video_path}')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
