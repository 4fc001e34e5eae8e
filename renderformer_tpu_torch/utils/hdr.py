"""HDR log-space codec: emissive texture channels are log10(x+1)-encoded
before the model and the model output is pow(10, y) - 1 decoded, unless
the model runs in LDR mode."""

from __future__ import annotations

import torch


def hdr_encode_texture(texture: torch.Tensor) -> torch.Tensor:
    """log10(x+1) on the last 3 channels of axis 2 ([bs, N, C, ...])."""
    emissive = torch.log10(texture[:, :, -3:] + 1.0)
    return torch.cat([texture[:, :, :-3], emissive], dim=2)


def hdr_decode_image(img: torch.Tensor) -> torch.Tensor:
    """pow(10, y) - 1 on the rendered image."""
    return torch.pow(10.0, img) - 1.0
