"""What the work is, counted from shapes: model FLOPs, attention sites, peaks.

The model FLOPs of a render are those of the architecture's matrix
products and convolutions (two operations a multiply-add), at the scene's
real triangle count: the linear layers, attention at its real key counts
(full, or 8 x 8 windows), the DPT head's convolutions.  Norms, softmax and
element-wise work are not counted.  The cross-attention's K/V projections
of a scene's tokens count once a scene, not once a view.  A train step
counts three forward passes (forward, and twice its products backward);
the recomputation under remat is not counted.

An attention site is one launch of a hand-written kernel: its operations
and the bytes it has to read and write once, at the site's shapes and
dtype.  ``least_s`` is the larger of operations over the peak of the
site's dtype and bytes over the memory rate: the least time any
implementation could take.  Masked (padded) keys and queries are not
counted: they are not needed.  The byte counts of the flash forward and of
the K/V rotation are ``chip_smoke.py``'s (``k3_bytes``, the forward rows).
"""

from __future__ import annotations

import dataclasses
from typing import List

# NVIDIA H100 SXM5 80GB data sheet, dense (no sparsity), at the 700 W limit
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 494.7e12}   # bf16, TF32 tensor cores
PEAK_BF16 = PEAK_FLOPS['bfloat16']
PEAK_BYTES = 3.35e12                                      # HBM3 bytes/s
ITEMSIZE = {'bfloat16': 2, 'float32': 4}
WINDOW = 8


@dataclasses.dataclass(frozen=True)
class Site:
    kernel: str     # the kernel family: flash_fwd, flash_bwd, rot_kv, swin_fwd, swin_bwd, regroup
    dtype: str
    flops: float
    nbytes: float

    @property
    def least_s(self) -> float:
        return max(self.flops / PEAK_FLOPS[self.dtype], self.nbytes / PEAK_BYTES)


def widths(cfg: dict):
    return (cfg['latent_dim'], cfg['view_transformer_latent_dim'], cfg['dim_feedforward'],
            cfg['view_transformer_ffn_hidden_dim'])


def conv(h_out, w_out, c_in, c_out, k):
    return 2 * h_out * w_out * c_in * c_out * k * k


def dpt_flops(cfg: dict, grid: int) -> float:
    """One view's DPT head at a grid x grid token map."""
    dv, oc, f = cfg['view_transformer_latent_dim'], cfg['dpt_out_channels'], cfg['dpt_features']
    sizes = (grid * 4, grid * 2, grid, grid // 2)          # the four maps after the resizes
    total = sum(conv(grid, grid, dv, c, 1) for c in oc)    # projects
    total += conv(grid, grid, oc[0], oc[0], 4) + conv(grid, grid, oc[1], oc[1], 2)  # transposed
    total += conv(sizes[3], sizes[3], oc[3], oc[3], 3)     # the strided conv
    total += sum(conv(s, s, c, f, 3) for s, c in zip(sizes, oc))   # layerN_rn
    # refinenets 4..1: residual units at the input size, out_conv at twice it
    for s, units in ((sizes[3], 1), (sizes[2], 2), (sizes[1], 2), (sizes[0], 2)):
        total += units * 2 * conv(s, s, f, f, 3) + conv(2 * s, 2 * s, f, f, 1)
    full = grid * cfg['patch_size']
    total += conv(full, full, f, f // 2, 3) + conv(full, full, f // 2, 32, 3)
    total += conv(full, full, 32, 3, 1)
    return float(total)


def encoder_flops(cfg: dict, n: int) -> float:
    """Stage 1 of one scene of ``n`` real triangles."""
    d, _, ff, _ = widths(cfg)
    t = cfg['num_register_tokens'] + n
    tex_in = cfg['texture_channels'] * cfg['texture_encode_patch_size'] ** 2
    total = 2 * n * tex_in * d + 2 * n * (9 * cfg['vn_pe_num_freqs'] * 2 + 9) * d
    per_layer = 2 * t * d * 3 * d + 4 * t * t * d + 2 * t * d * d + 3 * 2 * t * d * ff
    return float(total + cfg['num_layers'] * per_layer)


def view_flops(cfg: dict, n: int, views: int, resolution: int) -> float:
    """Stage 2 and the DPT head of one scene's ``views`` views."""
    d, dv, _, ffv = widths(cfg)
    t = cfg['num_register_tokens'] + n
    p = cfg['patch_size']
    tr = (resolution // p) ** 2
    keys = WINDOW * WINDOW if cfg['view_transformer_use_swin_attn'] else tr
    total = 2 * views * tr * 3 * p * p * dv
    per_layer = (2 * 2 * t * d * dv                           # k, v projections, once a scene
                 + views * (2 * tr * dv * dv * 2                # q and out projections
                            + 4 * tr * t * dv                   # cross-attention
                            + 2 * tr * dv * 3 * dv + 2 * tr * dv * dv   # self-attention projections
                            + 4 * tr * keys * dv                # self-attention
                            + 3 * 2 * tr * dv * ffv))           # SwiGLU
    total += cfg['view_transformer_n_layers'] * per_layer
    return float(total + views * dpt_flops(cfg, resolution // p))


def render_flops(cfg: dict, n: int, views: int, resolution: int) -> float:
    return encoder_flops(cfg, n) + view_flops(cfg, n, views, resolution)


def train_flops(cfg: dict, n: int, views: int, resolution: int) -> float:
    return 3 * render_flops(cfg, n, views, resolution)


# --------------------------------------------------------------------------- attention sites

def rot_kv(b, bkv, sk, h, hd, dtype) -> Site:
    """K3: k read at the scene batch with its fp32 tables, written at the q batch."""
    it = ITEMSIZE[dtype]
    return Site('rot_kv', dtype, 3 * b * sk * h * hd,
                bkv * sk * h * hd * it + 2 * b * sk * hd * 4 + b * sk * h * hd * it)


def flash_fwd(b, bkv, sq, sk, h, hd, dtype, masked) -> Site:
    """K1 (masked) / K2: q, rotated k at the q batch, v at the scene batch,
    out; the mask and q's fp32 tables."""
    it = ITEMSIZE[dtype]
    nbytes = ((b * sq * h * hd * 2 + b * sk * h * hd + bkv * sk * h * hd) * it
              + (b * sk if masked else 0) + 2 * b * sq * hd * 4)
    return Site('flash_fwd', dtype, 4 * b * h * sq * sk * hd, nbytes)


def flash_bwd(b, sq, sk, h, hd, dtype, masked) -> Site:
    """K8: q, o, dO and k, v in, dq, dk, dv out, the fp32 row statistics."""
    it = ITEMSIZE[dtype]
    nbytes = ((4 * b * sq * h * hd + 4 * b * sk * h * hd) * it + 2 * b * h * sq * 4
              + (b * sk if masked else 0))
    return Site('flash_bwd', dtype, 10 * b * h * sq * sk * hd, nbytes)


def swin(views, tokens, c, h, dtype, backward=False) -> Site:
    """K6 / K6^T over every 8 x 8 window of ``views`` grids of ``tokens``."""
    it = ITEMSIZE[dtype]
    hd = c // h
    pairs = views * tokens * WINDOW * WINDOW
    if backward:
        return Site('swin_bwd', dtype, 10 * pairs * hd * h, 7 * views * tokens * c * it)
    return Site('swin_fwd', dtype, 4 * pairs * hd * h, 4 * views * tokens * c * it)


def regroup(views, tokens, c, dtype) -> Site:
    """K7: one permutation of the window-ordered stream."""
    return Site('regroup', dtype, 0, 2 * views * tokens * c * ITEMSIZE[dtype])


def render_sites(cfg: dict, n: int, views: int, resolution: int, dtype: str = 'bfloat16',
                 view_dtype: str = 'bfloat16') -> List[Site]:
    """The attention kernel launches of one render of one scene."""
    t = cfg['num_register_tokens'] + n
    h, hv = cfg['num_heads'], cfg['view_transformer_n_heads']
    hd, hdv = cfg['latent_dim'] // h, cfg['view_transformer_latent_dim'] // hv
    tr = (resolution // cfg['patch_size']) ** 2
    sites: List[Site] = []
    for _ in range(cfg['num_layers']):
        sites += [rot_kv(1, 1, t, h, hd, dtype), flash_fwd(1, 1, t, t, h, hd, dtype, True)]
    swin_on = cfg['view_transformer_use_swin_attn']
    for i in range(cfg['view_transformer_n_layers']):
        sites += [rot_kv(views, 1, t, hv, hdv, view_dtype),
                  flash_fwd(views, 1, tr, t, hv, hdv, view_dtype, True)]
        if swin_on:
            sites.append(swin(views, tr, cfg['view_transformer_latent_dim'], hv, view_dtype))
            if i % 2:
                sites += 2 * [regroup(views, tr, cfg['view_transformer_latent_dim'], view_dtype)]
        else:
            sites += [rot_kv(views, views, tr, hv, hdv, view_dtype),
                      flash_fwd(views, views, tr, tr, hv, hdv, view_dtype, False)]
    return sites


def train_sites(cfg: dict, n: int, views: int, resolution: int, dtype: str = 'bfloat16',
                view_dtype: str = 'float32') -> List[Site]:
    """The attention kernel launches of one remat train step: each forward
    launch twice (forward, recomputation), K3 and K7 once more as the
    backward's, and the backward kernels once."""
    t = cfg['num_register_tokens'] + n
    h, hv = cfg['num_heads'], cfg['view_transformer_n_heads']
    hd, hdv = cfg['latent_dim'] // h, cfg['view_transformer_latent_dim'] // hv
    c = cfg['view_transformer_latent_dim']
    tr = (resolution // cfg['patch_size']) ** 2
    swin_on = cfg['view_transformer_use_swin_attn']
    sites: List[Site] = []
    for _ in range(cfg['num_layers']):
        sites += 3 * [rot_kv(1, 1, t, h, hd, dtype)]
        sites += 2 * [flash_fwd(1, 1, t, t, h, hd, dtype, True)]
        sites.append(flash_bwd(1, t, t, h, hd, dtype, True))
    for i in range(cfg['view_transformer_n_layers']):
        sites += 3 * [rot_kv(views, 1, t, hv, hdv, view_dtype)]
        sites += 2 * [flash_fwd(views, 1, tr, t, hv, hdv, view_dtype, True)]
        sites.append(flash_bwd(views, tr, t, hv, hdv, view_dtype, True))
        if swin_on:
            sites += 2 * [swin(views, tr, c, hv, view_dtype)]
            sites.append(swin(views, tr, c, hv, view_dtype, backward=True))
            if i % 2:
                sites += 6 * [regroup(views, tr, c, view_dtype)]
        else:
            sites += 3 * [rot_kv(views, views, tr, hv, hdv, view_dtype)]
            sites += 2 * [flash_fwd(views, views, tr, tr, hv, hdv, view_dtype, False)]
            sites.append(flash_bwd(views, tr, tr, hv, hdv, view_dtype, False))
    return sites
