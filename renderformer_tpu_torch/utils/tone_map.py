"""HDR -> LDR tone mapping (CPU numpy post-process; the JAX package's
``renderformer_tpu/utils/tone_map.py``, the same arithmetic).

Replaces the reference's simple-ocio dependency (its infer.py):
implements the three mappers it exposes — AgX, Filmic (Blender), and
Khronos PBR Neutral — as closed-form approximations of the OCIO
transforms.  'none' is a plain clip (as the reference's infer.py).

AgX follows the Blender/Filament minimal implementation (inset matrix +
log2 encoding + 6th-order sigmoid); PBR Neutral follows the published
Khronos specification; Filmic uses Blender's filmic log encoding with a
medium-contrast curve approximation.
"""

from __future__ import annotations

import numpy as np

_AGX_MAT = np.array([
    [0.842479062253094, 0.0423282422610123, 0.0423756549057051],
    [0.0784335999999992, 0.878468636469772, 0.0784336],
    [0.0792237451477643, 0.0791661274605434, 0.879142973793104],
], dtype=np.float64)

_AGX_MAT_INV = np.array([
    [1.19687900512017, -0.0528968517574562, -0.0529716355144438],
    [-0.0980208811401368, 1.15190312990417, -0.0980434501171241],
    [-0.0990297440797205, -0.0989611768448433, 1.15107367264116],
], dtype=np.float64)

_AGX_MIN_EV = -12.47393
_AGX_MAX_EV = 4.026069


def _srgb_encode(x: np.ndarray) -> np.ndarray:
    x = np.clip(x, 0.0, 1.0)
    return np.where(x <= 0.0031308, 12.92 * x,
                    1.055 * np.power(x, 1 / 2.4) - 0.055)


def _agx_sigmoid(x: np.ndarray) -> np.ndarray:
    """6th-order polynomial approximation of the AgX default contrast."""
    x2 = x * x
    x4 = x2 * x2
    return (+ 15.5 * x4 * x2
            - 40.14 * x4 * x
            + 31.96 * x4
            - 6.868 * x2 * x
            + 0.4298 * x2
            + 0.1191 * x
            - 0.00232)


def tonemap_agx(hdr: np.ndarray) -> np.ndarray:
    """Linear Rec.709 HDR -> AgX base sRGB display [0,1]."""
    x = np.maximum(np.asarray(hdr, np.float64), 1e-10)
    x = x @ _AGX_MAT.T
    x = np.clip((np.log2(x) - _AGX_MIN_EV) / (_AGX_MAX_EV - _AGX_MIN_EV),
                0.0, 1.0)
    x = _agx_sigmoid(x)
    x = x @ _AGX_MAT_INV.T
    # AgX outputs display-encoded (2.2-ish) values directly
    return np.clip(x, 0.0, 1.0).astype(np.float32)


def tonemap_pbr_neutral(hdr: np.ndarray) -> np.ndarray:
    """Khronos PBR Neutral (spec: KhronosGroup/ToneMapping)."""
    color = np.maximum(np.asarray(hdr, np.float64), 0.0)
    start_compression = 0.8 - 0.04
    desaturation = 0.15

    x = np.min(color, axis=-1, keepdims=True)
    offset = np.where(x < 0.08, x - 6.25 * x * x, 0.04)
    color = color - offset

    peak = np.max(color, axis=-1, keepdims=True)
    d = 1.0 - start_compression
    new_peak = 1.0 - d * d / (peak + d - start_compression)
    scaled = color * np.where(peak > 1e-10, new_peak / np.maximum(peak, 1e-10), 1.0)
    g = 1.0 - 1.0 / (desaturation * (peak - new_peak) + 1.0)
    compressed = scaled * (1.0 - g) + new_peak * g
    out = np.where(peak < start_compression, color, compressed)
    return _srgb_encode(out).astype(np.float32)


def tonemap_filmic(hdr: np.ndarray) -> np.ndarray:
    """Blender Filmic (base contrast) approximation.

    Exact filmic log2 encoding (Blender's filmic_log: 16.5 stops,
    -12.473931188 .. +4.026068812 EV around 0.18 scene grey), followed by
    a power-corrected smoothstep stand-in for the Base Contrast 1D LUT
    (the LUT itself is Blender data we do not ship).  Contract tested in
    tests/test_tone_map.py: monotone, with all three published anchors
    exact: 0 -> 0, +4.03 EV -> 1, and mid grey -> 0.800 display
    (smoothstep(0.7560)^1.3770 = 0.800; the bare smoothstep landed at
    0.850 — docs/tone_mapping.md).  Still a preview-quality
    approximation between the anchors; ToneMapper warns once when it is
    selected."""
    x = np.maximum(np.asarray(hdr, np.float64), 0.0)
    log = np.log2(np.maximum(x, 1e-10) / 0.18)
    t = np.clip((log + 12.473931188) / 16.5, 0.0, 1.0)
    # base contrast S-curve (LUT approximation), gamma-corrected so the
    # published mid-grey anchor (0.18 scene -> 0.800 display) is exact
    t = (t * t * (3.0 - 2.0 * t)) ** 1.3770
    return np.clip(t, 0.0, 1.0).astype(np.float32)


_TONE_MAPPERS = {
    'agx': tonemap_agx,
    'filmic': tonemap_filmic,
    'pbr_neutral': tonemap_pbr_neutral,
    'Khronos PBR Neutral': tonemap_pbr_neutral,
}


class ToneMapper:
    """Drop-in for simple_ocio.ToneMapper."""

    def __init__(self, name: str):
        if name not in _TONE_MAPPERS:
            raise ValueError(
                f'unknown tone mapper {name!r}; choose from '
                f'{sorted(k for k in _TONE_MAPPERS if " " not in k)}')
        if name == 'filmic':
            import warnings
            warnings.warn(
                'filmic tone mapping is a preview-quality approximation: '
                'the Base Contrast LUT is Blender data not shipped here; '
                'the three published anchors (black, mid grey 0.800, '
                'white) are exact but values between them are a fitted '
                'S-curve (docs/tone_mapping.md). agx and pbr_neutral are '
                'exact.', stacklevel=2)
        self._fn = _TONE_MAPPERS[name]
        self.name = name

    def hdr_to_ldr(self, hdr: np.ndarray) -> np.ndarray:
        return self._fn(hdr)
