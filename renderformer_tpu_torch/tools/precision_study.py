"""View-stage precision study at full size (the JAX package's
``tools/precision_study.py``).

The reference runs stage 2 in fp32 when the outer autocast is half, a
CUDA-fp16 overflow mitigation; the port's half dtype is bf16 (fp32's
dynamic range), so the fp32 view stage may be pure cost.  This tool
measures the numerical cost of a bf16 view stage on real scene geometry
(a cbox frame of ``make_video_frames``): it renders the same scene all
fp32 (the numerical reference), bf16 with the fp32 view stage (the
default) and all bf16, and reports pairwise PSNR on the decoded HDR image
and on the PBR-neutral tone-mapped LDR image.

The weights are a seeded random init unless ``--preset`` names a
checkpoint directory: the study measures the numerical drift of the
architecture at size, not the perceptual quality of trained outputs.

    python -m renderformer_tpu_torch.tools.make_video_frames --frames 1 --out FRAMES
    python -m renderformer_tpu_torch.tools.precision_study --preset v1.1-swin-large \
        --h5 FRAMES/frame_0000.h5 --res 512 [--pad 4352] [--cpu]

``--preset`` is a preset name or a checkpoint directory, as
``from_pretrained`` takes either.  ``--h5`` is read by the port's
``io/hdf5`` (no ``h5py``); ``study`` takes the scene as arrays.  On the
card unless given ``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

# (stage-1 precision, view-stage precision) of the three renders
PRECISIONS = {'fp32all': ('fp32', 'fp32'), 'fp32view': ('bf16', 'fp32'),
              'bf16view': ('bf16', 'bf16')}


def psnr(a, b, peak=None):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if peak is None:
        peak = max(a.max(), b.max(), 1e-12)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float('inf')
    return float(10.0 * np.log10(peak * peak / mse))


def renders(pipe, scene_args, res: int):
    """The three renders of PRECISIONS, [res, res, 3] HDR fp32 numpy each."""
    return {name: pipe.render(*scene_args, resolution=res, precision=p,
                              view_precision=vp)[0, 0].float().cpu().numpy()
            for name, (p, vp) in PRECISIONS.items()}


def study(pipe, scene, res: int, preset: str, h5: str = ''):
    """The JSON report of the three renders of ``scene`` (a padded scene
    dict, ``io/h5.load_scene_h5``'s layout), and the renders."""
    from renderformer_tpu_torch.utils.tone_map import ToneMapper
    scene_args = (scene['triangles'][None], scene['texture'][None], scene['mask'][None],
                  scene['vn'][None], scene['c2w'][None], scene['fov'][None, :, None])
    imgs = renders(pipe, scene_args, res)
    ref, fp32v, bf16v = imgs['fp32all'], imgs['fp32view'], imgs['bf16view']
    tm = ToneMapper('pbr_neutral').hdr_to_ldr
    ldr_ref, ldr_fp32v, ldr_bf16v = tm(ref), tm(fp32v), tm(bf16v)
    out = {
        'preset': preset,
        'h5': h5,
        'resolution': res,
        'n_tris': int(scene['mask'].sum()),
        'weights': (f'checkpoint {preset}' if os.path.isdir(preset)
                    else 'random-init (seeded; no trained weights in the repository)'),
        'psnr_hdr': {
            'fp32view_vs_fp32all': round(psnr(fp32v, ref), 2),
            'bf16view_vs_fp32all': round(psnr(bf16v, ref), 2),
            'bf16view_vs_fp32view': round(psnr(bf16v, fp32v), 2),
        },
        'psnr_ldr_pbr_neutral': {
            'fp32view_vs_fp32all': round(psnr(ldr_fp32v, ldr_ref, peak=1.0), 2),
            'bf16view_vs_fp32all': round(psnr(ldr_bf16v, ldr_ref, peak=1.0), 2),
            'bf16view_vs_fp32view': round(psnr(ldr_bf16v, ldr_fp32v, peak=1.0), 2),
        },
    }
    return out, imgs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--preset', default='v1.1-swin-large')
    ap.add_argument('--h5', default=os.path.join(tempfile.gettempdir(), 'rf_frames',
                                                 'frame_0000.h5'))
    ap.add_argument('--res', type=int, default=512)
    ap.add_argument('--pad', type=int, default=4352, help='triangle padding bucket')
    ap.add_argument('--cpu', action='store_true')
    args = ap.parse_args(argv)

    from renderformer_tpu_torch.io.h5 import load_scene_h5
    from renderformer_tpu_torch.pipelines.rendering_pipeline import RenderingPipeline
    scene = load_scene_h5(args.h5, args.pad)
    pipe = RenderingPipeline.from_pretrained(args.preset, device='cpu' if args.cpu else None)
    out, _ = study(pipe, scene, args.res, args.preset, args.h5)
    print(json.dumps(out, indent=2))


if __name__ == '__main__':
    main()
