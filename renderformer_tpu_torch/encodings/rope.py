"""Triangle rotary position embedding (9-coordinate RoPE), always fp32.

  * per-head-dim frequencies ``2 ** linspace(0, log2(dim/2 - 1), dim/2)``
    (``log2(dim - 1)`` when double_max_freq);
  * the 9 triangle coordinates are outer-multiplied with the frequencies
    and laid out HF-style "concat halves";
  * ``freqs_to_cos_sin`` keeps the first half of the angles, zero-pads
    them into ``head_dim//2`` slots (a zero angle is the identity on the
    leftover dims) and duplicates.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def rope_frequencies(dim: int, double_max_freq: bool = False) -> np.ndarray:
    """Log-spaced base frequencies, shape [dim//2], fp32."""
    max_freq = math.log2(dim - 1) if double_max_freq else math.log2(dim // 2 - 1)
    return (2.0 ** np.linspace(0.0, max_freq, dim // 2)).astype(np.float32)


def triangle_freqs(pos: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """pos [B, N, 9], freqs [dim//2] -> angles [B, N, 1, 9*dim//2*2]."""
    ang = pos.float()[..., None] * freqs.float()
    ang = ang.reshape(ang.shape[0], ang.shape[1], 1, -1)
    return torch.cat([ang, ang], dim=-1)


def freqs_to_cos_sin(freqs: torch.Tensor, head_dim: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-pad angles to head_dim and take cos/sin, each [..., head_dim]."""
    half = freqs[..., : freqs.shape[-1] // 2]
    right = head_dim // 2 - half.shape[-1]
    if right < 0:
        raise ValueError(
            f'rope angles ({half.shape[-1]}) exceed head_dim//2 ({head_dim // 2})')
    half = F.pad(half, (0, right))
    full = torch.cat([half, half], dim=-1)
    return torch.cos(full), torch.sin(full)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate x [B, S, H, D] by cos/sin [B, S, 1, D] in fp32 (products and
    sum rounded separately), cast back."""
    x32 = x.float()
    return (x32 * cos + rotate_half(x32) * sin).to(x.dtype)


def make_cos_sin(pos: torch.Tensor, rope_dim: int, head_dim: int,
                 double_max_freq: bool = False):
    """Positions [B, N, 9] -> (cos, sin) [B, N, 1, head_dim]."""
    base = torch.from_numpy(rope_frequencies(rope_dim, double_max_freq)).to(pos.device)
    return freqs_to_cos_sin(triangle_freqs(pos, base), head_dim=head_dim)
