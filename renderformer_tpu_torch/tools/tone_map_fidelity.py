"""Quantify tone-mapper fidelity (the JAX package's
``tools/tone_map_fidelity.py``), against the port's ``utils/tone_map``.

    python -m renderformer_tpu_torch.tools.tone_map_fidelity [--out FILE] [--golden NPZ]

Bounds each mapper's delta against the strongest ground truth available
offline, on (a) an HDR ramp sweeping -13..+5 EV across hue/saturation and
(b) the recorded real render (``tests/data/golden_e2e_v1base.npz``, where
it exists):

* PBR Neutral — the Khronos specification is closed-form and public;
  compare against an INDEPENDENT transcription of the spec formulas
  (KhronosGroup/ToneMapping PBR_Neutral.md).  Expected: fp-epsilon.
* AgX — the minimal/base AgX implementation (inset matrix + 16.5-stop
  log2 window + 6th-order sigmoid fit) is published with exact constants
  (Filament/iolite minimal AgX); compare against an independent
  transcription.  The delta vs Blender's full OCIO LUT pipeline is NOT
  measurable offline (the LUTs are binary OCIO data not shipped here) —
  reported as the known sigmoid-fit bound from the fit's publication.
* Filmic — Blender's filmic log2 encoding is closed-form (exact); the
  Base Contrast 1-D LUT is Blender data, approximated by smoothstep.
  Report anchor deltas (black, mid-grey, white) against the published
  curve anchors.

Prints the markdown report and writes it to ``--out`` (default
``docs/tone_mapping.md`` under the repo root).
"""

import argparse
import os

import numpy as np

from renderformer_tpu_torch.utils.tone_map import (
    _srgb_encode, tonemap_agx, tonemap_filmic, tonemap_pbr_neutral)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# --- independent spec transcriptions (typed afresh from the public
# specs, NOT imported from utils/tone_map.py) ------------------------------

def pbr_neutral_spec(rgb):
    """KhronosGroup/ToneMapping PBR_Neutral.md, direct transcription."""
    rgb = np.maximum(np.asarray(rgb, np.float64), 0.0)
    F90 = 0.04
    Ks = 0.8 - F90       # start of highlight compression
    Kd = 0.15            # desaturation
    x = np.min(rgb, axis=-1, keepdims=True)
    f = np.where(x < 2.0 * F90, x - x * x / (4.0 * F90), F90)
    p = np.max(rgb - f, axis=-1, keepdims=True)
    rgb_f = rgb - f
    pn = 1.0 - (1.0 - Ks) ** 2 / (p + 1.0 - 2.0 * Ks)
    g = 1.0 / (Kd * (p - pn) + 1.0)
    mapped = pn * (1.0 - g) + rgb_f * (pn / np.maximum(p, 1e-12)) * g
    out = np.where(p <= Ks, rgb_f, mapped)
    return _srgb_encode(out)


_AGX_INSET = np.array([
    [0.842479062253094, 0.0423282422610123, 0.0423756549057051],
    [0.0784335999999992, 0.878468636469772, 0.0784336],
    [0.0792237451477643, 0.0791661274605434, 0.879142973793104]])
_AGX_OUTSET = np.linalg.inv(_AGX_INSET)


def agx_minimal_spec(rgb):
    """Minimal AgX (Filament / iolite publication), direct transcription:
    value = agxEotf(agxDefaultContrastApprox(agx(value)))."""
    v = np.maximum(np.asarray(rgb, np.float64), 1e-10)
    v = np.einsum('ij,...j->...i', _AGX_INSET, v)
    min_ev, max_ev = -12.47393, 4.026069
    v = np.clip((np.log2(v) - min_ev) / (max_ev - min_ev), 0.0, 1.0)
    # 6th-order contrast approximation (published coefficients)
    x = v
    x2, x4 = x * x, (x * x) * (x * x)
    v = (15.5 * x4 * x2 - 40.14 * x4 * x + 31.96 * x4
         - 6.868 * x2 * x + 0.4298 * x2 + 0.1191 * x - 0.00232)
    v = np.einsum('ij,...j->...i', _AGX_OUTSET, v)
    return np.clip(v, 0.0, 1.0)


def hdr_ramp(n_ev=300, n_chroma=24):
    """[-13, +5] EV sweep crossed with hue/saturation variations."""
    ev = np.linspace(-13, 5, n_ev)
    lum = 0.18 * np.exp2(ev)
    rng = np.random.default_rng(0)
    chroma = rng.uniform(0.05, 1.0, size=(n_chroma, 3))
    chroma /= chroma.mean(axis=-1, keepdims=True)
    return lum[:, None, None] * chroma[None]   # [n_ev, n_chroma, 3]


def stats(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    mse = float(np.mean(d * d))
    psnr = 10 * np.log10(1.0 / max(mse, 1e-30))
    return float(d.max()), float(d.mean()), psnr


def report_lines(golden_path=None):
    """The report's markdown lines: the ramp, and the recorded render where
    ``golden_path`` exists."""
    ramp = hdr_ramp()
    renders = [('HDR ramp', ramp)]
    if golden_path and os.path.exists(golden_path):
        renders.append(
            ('real render (v1-base golden)',
             np.load(golden_path)['downsampled'].astype(np.float64)))

    lines = [
        '# Tone-mapper fidelity',
        '',
        'Measured by `renderformer_tpu_torch/tools/tone_map_fidelity.py` against independent',
        'transcriptions of the published transforms (see tool docstring',
        'for what is and is not measurable offline).  Reference parity:',
        "the reference implementation's `infer.py:57-62` (simple_ocio).",
        '',
        '| mapper | input | max abs delta | mean abs delta | PSNR (dB) | ground truth |',
        '|---|---|---|---|---|---|',
    ]
    for name, data in renders:
        mx, mn, ps = stats(tonemap_pbr_neutral(data), pbr_neutral_spec(data))
        lines.append(f'| PBR Neutral | {name} | {mx:.2e} | {mn:.2e} | '
                     f'{ps:.1f} | Khronos spec (closed form, exact) |')
    for name, data in renders:
        mx, mn, ps = stats(tonemap_agx(data), agx_minimal_spec(data))
        lines.append(f'| AgX (base) | {name} | {mx:.2e} | {mn:.2e} | '
                     f'{ps:.1f} | minimal-AgX publication (exact constants) |')

    # Filmic anchors vs published curve behaviour
    anchors = {
        'black (0.0)': (np.zeros(3), 0.0),
        'mid grey (0.18)': (np.full(3, 0.18), 0.80),
        'white point (+4.026 EV = 2.94)': (np.full(3, 0.18 * 2 ** 4.026068812), 1.0),
    }
    lines += ['', '## Filmic (Blender base-contrast approximation)', '',
              'The filmic log2 encoding (16.5 stops around 0.18 grey) is',
              'closed-form and exact; the Base Contrast 1-D LUT is Blender',
              'data approximated with a gamma-corrected smoothstep',
              '(`smoothstep(t)^1.3770`, round 5) — anchor deltas:', '',
              '| anchor | ours | published | delta |', '|---|---|---|---|']
    for label, (inp, want) in anchors.items():
        got = float(tonemap_filmic(inp[None])[0, 0])
        lines.append(f'| {label} | {got:.4f} | {want:.3f} | '
                     f'{abs(got - want):.4f} |')
    lines += [
        '',
        '## Known gaps (environment-blocked)',
        '',
        '* AgX vs Blender OCIO: Blender applies the same inset/log2/contrast',
        '  pipeline through binary OCIO LUTs; the LUT data is not shippable',
        '  and not fetchable here, so the delta to Blender-the-program is',
        '  unmeasured.  The minimal-AgX sigmoid is a published fit of that',
        "  LUT's default contrast (stated fit error well under 1%).",
        '* Filmic anchors (black, mid grey 0.800, white) are exact since the',
        '  round-5 gamma-corrected S-curve; values between anchors remain a',
        '  fitted approximation — ToneMapper(\'filmic\') warns at runtime.',
        '',
    ]
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--out', default=os.path.join(REPO, 'docs', 'tone_mapping.md'),
                    help='markdown file to write')
    ap.add_argument('--golden', default=os.path.join(REPO, 'tests', 'data',
                                                     'golden_e2e_v1base.npz'),
                    help='recorded render (npz with a "downsampled" image)')
    args = ap.parse_args(argv)
    lines = report_lines(args.golden)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        f.write('\n'.join(lines))
    print('\n'.join(lines))
    print(f'\nwrote {args.out}')


if __name__ == '__main__':
    main()
