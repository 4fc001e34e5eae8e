"""Quantify path-traced ground-truth noise against spp (the JAX package's
``tools/gt_noise_sweep.py``), with the port's path tracer.

    python -m renderformer_tpu_torch.tools.gt_noise_sweep [--h5_dir datasets/ft128/h5]
        [--scenes 3] [--resolution 256] [--out docs/training.md] [--cpu]

Renders the first ``--scenes`` scenes of ``--h5_dir`` (view 0) at each of
``--spps``, with and without the firefly clamp, and reports the LDR PSNR
against a ``--ref_spp`` reference of the same view, so a fine-tune
dataset's spp can be chosen deliberately and the training loss floor can
be attributed (model error vs GT noise).  Each render averages 64-spp
chunks with seeds ``seed0 + i`` (the references 999, the sweep 1), as the
JAX tool does; the random streams differ between the packages, so the
numbers agree in distribution, not in bits.  With ``--out`` the
'## Path-traced GT noise vs spp' section of that markdown file is
replaced (or appended).  Runs on the card unless given ``--cpu``;
reading the H5 scenes needs ``h5py``, ``sweep`` takes loaded scene dicts.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Sequence, Tuple

import numpy as np

MARKER = '## Path-traced GT noise vs spp'
PADDING = 4096   # one padding bucket for every scene


def psnr(a, b):
    """LDR PSNR (peak 1) on [0,1]-clipped images — the metric the
    training loop actually sees: generate_dataset writes GT as
    clip(img, 0, 1) PNGs.  (A peak=max(ref) HDR PSNR swings by >20 dB
    with whether a bright light texel lands in the view — useless for
    cross-run comparison.)"""
    a = np.clip(a, 0.0, 1.0)
    b = np.clip(b, 0.0, 1.0)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float('inf')
    return 10.0 * np.log10(1.0 / mse)


def render_accum(scene, spp_total: int, seed0: int, clamp: float, resolution: int,
                 device=None) -> np.ndarray:
    """The mean of 64-spp chunks (the last one the remainder, weighted by
    its spp) with seeds seed0, seed0 + 1, ...: the estimator of one
    spp_total render, each pass short."""
    from renderformer_tpu_torch.scene.path_tracer import render_scene_pathtrace
    chunk = min(64, spp_total)
    sizes = [chunk] * (spp_total // chunk)
    if spp_total % chunk:
        sizes.append(spp_total % chunk)
    acc, total = None, 0
    for i, sz in enumerate(sizes):
        img = render_scene_pathtrace(scene, view=0, resolution=resolution, spp=sz,
                                     seed=seed0 + i, clamp=clamp, device=device) * sz
        acc = img if acc is None else acc + img
        total += sz
    return acc / total


def sweep(scenes: Sequence[Tuple[str, Dict]], resolution: int, ref_spp: int,
          spps: Sequence[int], clamp: float, device=None, log=print):
    """(rows, biases) of the named scenes: rows (name, spp, PSNR of the
    unclamped render against the unclamped reference, PSNR of the clamped
    render against the clamped reference); biases (name, PSNR of the
    clamped reference against the unclamped one)."""
    rows, biases = [], []
    for name, scene in scenes:
        # like for like: clamped against a clamped reference (the GT
        # pipeline renders with the clamp), unclamped against unclamped;
        # the clamp's bias is the two references against each other.  The
        # unclamped estimator is heavy-tailed for the dataset's bright
        # large lights, so its column converges slowly: that is why
        # generate_dataset clamps
        ref_u = render_accum(scene, ref_spp, 999, 0.0, resolution, device)
        ref_c = render_accum(scene, ref_spp, 999, clamp, resolution, device)
        biases.append((name, psnr(ref_c, ref_u)))
        log(f'{name}: clamp bias (ref_c vs ref_u, {ref_spp} spp) '
            f'= {biases[-1][1]:.1f} dB LDR')
        for spp in spps:
            img0 = render_accum(scene, spp, 1, 0.0, resolution, device)
            imgc = render_accum(scene, spp, 1, clamp, resolution, device)
            rows.append((name, spp, psnr(img0, ref_u), psnr(imgc, ref_c)))
            log(f'{name} spp={spp}: PSNR {rows[-1][2]:.1f} dB '
                f'(clamped {rows[-1][3]:.1f} dB)')
    return rows, biases


def markdown_block(rows, biases, ref_spp: int, resolution: int, clamp: float) -> str:
    lines = [
        MARKER,
        '',
        'LDR PSNR (peak 1, [0,1]-clipped — the form the training GT',
        f'PNGs are written in) of a single render vs a {ref_spp}-spp',
        f'unclamped reference of the same view, {resolution}^2'
        ' (renderformer_tpu_torch/tools/gt_noise_sweep.py).'
        f'  Clamp = {clamp} is the generate_dataset default.',
        '',
        '| scene | spp | PSNR vs unclamped ref (dB) |'
        ' PSNR, clamped vs clamped ref (dB) |',
        '|---|---|---|---|',
    ]
    for name, spp, p0, pc in rows:
        lines.append(f'| {name} | {spp} | {p0:.1f} | {pc:.1f} |')
    lines.append('')
    for name, b in biases:
        lines.append(f'* {name}: clamp-{clamp:g} bias vs the '
                     f'unclamped estimator: {b:.1f} dB LDR at '
                     f'{ref_spp} spp')
    lines.append('')
    return '\n'.join(lines)


def replace_section(text: str, block: str) -> str:
    """``text`` with its MARKER section (up to the next '## ' heading)
    replaced by ``block``, or ``block`` appended."""
    if MARKER in text:
        head, rest = text.split(MARKER, 1)
        nxt = rest.find('\n## ')
        tail = rest[nxt + 1:] if nxt >= 0 else ''
        return head + block + ('\n' + tail if tail else '')
    return text.rstrip() + '\n\n' + block


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--h5_dir', default='datasets/ft128/h5')
    ap.add_argument('--scenes', type=int, default=3)
    ap.add_argument('--resolution', type=int, default=256)
    ap.add_argument('--ref_spp', type=int, default=1024)
    ap.add_argument('--spps', default='8,16,32,64,128,256')
    ap.add_argument('--clamp', type=float, default=10.0)
    ap.add_argument('--out', default=None,
                    help='markdown file to update (section replace)')
    ap.add_argument('--cpu', action='store_true', help='trace on the CPU')
    args = ap.parse_args(argv)

    from renderformer_tpu_torch.io.h5 import list_scene_files, load_scene_h5
    from renderformer_tpu_torch.pipelines.rendering_pipeline import resolve_device
    device = resolve_device('cpu' if args.cpu else None)
    files = list_scene_files(args.h5_dir)[:args.scenes]
    if not files:
        raise SystemExit(f'no scenes under {args.h5_dir}')
    spps = [int(s) for s in args.spps.split(',')]
    scenes = [(os.path.splitext(os.path.basename(f))[0], load_scene_h5(f, padding_length=PADDING))
              for f in files]
    rows, biases = sweep(scenes, args.resolution, args.ref_spp, spps, args.clamp, device,
                         log=lambda s: print(s, flush=True))
    block = markdown_block(rows, biases, args.ref_spp, args.resolution, args.clamp)
    if args.out:
        text = open(args.out).read() if os.path.exists(args.out) else ''
        with open(args.out, 'w') as f:
            f.write(replace_section(text, block))
        print(f'updated {args.out}')


if __name__ == '__main__':
    sys.exit(main())
