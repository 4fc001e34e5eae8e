"""Seeded weights, made on the device in a few large calls.

Every weight of :func:`rfbench.reference.model.param_spec` comes from two
draws of one generator on the device: one uniform buffer for the linear
and conv weights and biases, scaled per tensor to U(+-1/sqrt(fan_in)), and
one normal buffer for the learned tokens.  Norm scales are ones and the
RoPE frequencies their fixed values.  The same seed gives the same bits on
the same device, so the reference draws them again rather than reading
anything the program holds.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from rfbench.reference.model import param_spec, rope_base_freqs

SEED_MASK = (1 << 63) - 1


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one purpose (``stream``) of a seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) & SEED_MASK)
    return g


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device``, each in storage of its own."""
    spec = param_spec(cfg)
    n_uni = sum(math.prod(s) for _, s, init in spec if init.startswith('uniform'))
    n_nrm = sum(math.prod(s) for _, s, init in spec if init == 'normal')
    g = generator(seed, device, 1)
    uni = torch.rand(n_uni, generator=g, device=device)
    nrm = torch.randn(n_nrm, generator=g, device=device)
    out, iu, inn = {}, 0, 0
    for name, shape, init in spec:
        n = math.prod(shape)
        if init.startswith('uniform'):
            bound = 1.0 / math.sqrt(int(init.split(':')[1]))
            out[name] = (uni[iu:iu + n] * (2 * bound) - bound).reshape(shape)
            iu += n
        elif init == 'normal':
            out[name] = nrm[inn:inn + n].clone().reshape(shape)
            inn += n
        elif init == 'ones':
            out[name] = torch.ones(shape, device=device)
        else:   # the RoPE base frequencies of a table of width 2 * shape[0]
            out[name] = torch.from_numpy(rope_base_freqs(2 * shape[0])).to(device)
    return out


def parameter_count(cfg: dict) -> int:
    """Every weight, the RoPE frequency buffers too, as the published counts are."""
    return sum(math.prod(s) for _, s, _ in param_spec(cfg))
