"""Multi-scale sinusoidal (NeRF) positional encoding: frequencies
``2 ** linspace(min_exp, max_exp, num)``, output
``sin(cat([x*f, x*f + pi/2]))`` over the flattened (input-dim, frequency)
axis, with the raw input optionally prepended."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def nerf_out_dim(in_dim: int, num_frequencies: int, include_input: bool = False) -> int:
    return in_dim * num_frequencies * 2 + (in_dim if include_input else 0)


def nerf_encode(x: torch.Tensor, num_frequencies: int, min_freq_exp: float = 0.0,
                max_freq_exp: Optional[float] = None,
                include_input: bool = False) -> torch.Tensor:
    """[*, D] -> [*, D*num_frequencies*2 (+ D)]."""
    if max_freq_exp is None:
        max_freq_exp = num_frequencies - 1
    if num_frequencies == 0:
        return x if include_input else x[..., :0]
    freqs = torch.as_tensor(
        2.0 ** np.linspace(min_freq_exp, max_freq_exp, num_frequencies),
        dtype=x.dtype, device=x.device)
    scaled = (x[..., None] * freqs).reshape(*x.shape[:-1], -1)
    encoded = torch.sin(torch.cat([scaled, scaled + np.pi / 2.0], dim=-1))
    if include_input:
        encoded = torch.cat([x, encoded], dim=-1)
    return encoded
