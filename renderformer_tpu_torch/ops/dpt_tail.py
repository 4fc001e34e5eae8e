"""Composed space-to-depth evaluation of the DPT output tail (plain PyTorch).

At the model's shapes the tail is two 3x3 convs with no nonlinearity
between them (the resize between them is the identity at patch size 8):

    out = conv1(u)                        # 3x3, C -> C/2  (output_conv1)
    out = conv2a(out)                     # 3x3, C/2 -> 32 (output_conv2[0])
    out = conv2b(act(out))                # 1x1, 32 -> out_dim

conv1 and conv2a compose into one 5x5 conv (C -> 32), evaluated in
space-to-depth form as a 3x3 block conv [3, 3, 4C, 4*32]; the 1x1 conv2b
is block-diagonal in that layout, so the whole tail runs on the
[H/2, W/2, 4C] tensor and only the final image is depth-to-spaced.

The composition is exact except on the 1-pixel output ring: conv2a sees
zeros beyond conv1's output, while the composed conv sees conv1 evaluated
past the border.  :func:`ring_correction` computes that difference from
the four border rows and columns of u with thin 1-D convs, and it is
subtracted in s2d layout.

Kernels are HWIO ``[kh, kw, Cin, Cout]`` and activations NHWC, the JAX
package's layouts.  Packing: s2d(x)[i, j, (a*2 + b)*C + c] = x[2i + a,
2j + b, c] (``ops/s2d_conv.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from renderformer_tpu_torch.ops.s2d_conv import conv2d_hwio, depth_to_space, space_to_depth


def compose_conv3x3_pair(k1, b1, k2, b2):
    """(3x3 conv k1 [3, 3, C, M], bias b1) then (3x3 conv k2 [3, 3, M, O],
    bias b2) -> (5x5 kernel [5, 5, C, O], bias [O]), composed in the dtype
    of the kernels: each tap product k1[i1, j1] @ k2[i2, j2] rounds to it,
    and so does each sum, taken in the order (i1, j1)."""
    c, o = k1.shape[2], k2.shape[3]
    dt = torch.promote_types(k1.dtype, k2.dtype)
    k1, k2 = k1.to(dt), k2.to(dt)
    # prod[i1, j1, i2, j2] = k1[i1, j1] @ k2[i2, j2]
    prod = torch.matmul(k1[:, :, None, None], k2[None, None])
    k5 = k1.new_zeros((5, 5, c, o))
    for i1 in range(3):
        for j1 in range(3):
            k5[i1:i1 + 3, j1:j1 + 3] += prod[i1, j1]
    b5 = b2.to(dt) + torch.einsum('m,ijmo->o', b1.to(dt), k2)
    return k5, b5


@functools.lru_cache(maxsize=8)
def _block5_taps(device: torch.device) -> torch.Tensor:
    """[3, 3, 4, 4] index of the 5x5 tap behind each (block row u, block col
    v, in-block input (ci, cj), output offset (a, b)) of the s2d block
    kernel, 25 where the tap is a structural zero; on ``device``, copied
    there once."""
    idx = np.full((3, 3, 4, 4), 25, np.int64)
    for u in (-1, 0, 1):
        for v in (-1, 0, 1):
            for ci in range(2):
                for cj in range(2):
                    for a in range(2):
                        for b in range(2):
                            dy, dx = 2 * u + ci - a, 2 * v + cj - b
                            if -2 <= dy <= 2 and -2 <= dx <= 2:
                                idx[u + 1, v + 1, 2 * ci + cj, 2 * a + b] = (
                                    (dy + 2) * 5 + dx + 2)
    with torch.inference_mode(False):  # cached: usable later under autograd
        return torch.from_numpy(idx).to(device)


def s2d_block_kernel5(k5):
    """[5, 5, C, O] -> [3, 3, 4C, 4O] space-to-depth block kernel.

    For output offset (a, b) and 5x5 tap (dy, dx) in {-2..2}: t = a + dy,
    s = b + dx in {-2..3}; in-block (t mod 2, s mod 2), block offset
    ((t - t%2)/2, (s - s%2)/2) in {-1, 0, 1}.  The block conv's one-block
    (2 px) zero padding is the 5x5 conv's 2 px padding.  Built as one
    gather of the taps (and a zero tap), not tap by tap."""
    c, o = k5.shape[2], k5.shape[3]
    taps = torch.cat([k5.reshape(25, c, o), k5.new_zeros((1, c, o))])
    kk = taps[_block5_taps(k5.device)]               # [3, 3, 4, 4, C, O]
    return kk.permute(0, 1, 2, 4, 3, 5).reshape(3, 3, 4 * c, 4 * o)


def _conv1d_same(x, taps):
    """x [B, L, Cin], taps [3, Cin, Cout] -> [B, L, Cout], zero padded."""
    xp = F.pad(x, (0, 0, 1, 1))
    n = x.shape[1]
    out = xp[:, 0:n] @ taps[0].to(x.dtype)
    for k in (1, 2):
        out = out + xp[:, k:k + n] @ taps[k].to(x.dtype)
    return out


def _conv1d_valid(x, taps):
    """x [B, L+2, Cin], taps [3, Cin, Cout] -> [B, L, Cout]."""
    n = x.shape[1] - 2
    out = x[:, 0:n] @ taps[0].to(x.dtype)
    for k in (1, 2):
        out = out + x[:, k:k + n] @ taps[k].to(x.dtype)
    return out


def ring_correction(borders, k1, b1, k2):
    """Corrections to subtract from the composed conv's 1-px output ring.

    borders: (top [B, W, C], bottom [B, W, C], left [B, H, C], right
    [B, H, C]), the border rows and columns of the conv input u.  Returns
    (c_top [B, W, O], c_bottom, c_left [B, H, O], c_right); the corners
    belong to the top and bottom strips (the left and right strips are
    zero there), so the four corrections add."""
    u_t, u_b, u_l, u_r = borders
    dt = u_t.dtype
    bias = b1.to(dt)

    # conv1's outputs one step past each border: only one input row or
    # column reaches them, through the opposite kernel row or column
    v_top = _conv1d_same(u_t, k1[2]) + bias        # y1[-1, 0..W-1]
    v_bot = _conv1d_same(u_b, k1[0]) + bias        # y1[H, 0..W-1]
    v_lef = _conv1d_same(u_l, k1[:, 2]) + bias     # y1[0..H-1, -1]
    v_rig = _conv1d_same(u_r, k1[:, 0]) + bias     # y1[0..H-1, W]

    # corners, e.g. y1[-1, -1], see exactly one input pixel
    c_tl = (u_t[:, :1] @ k1[2, 2].to(dt)) + bias
    c_tr = (u_t[:, -1:] @ k1[2, 0].to(dt)) + bias
    c_bl = (u_b[:, :1] @ k1[0, 2].to(dt)) + bias
    c_br = (u_b[:, -1:] @ k1[0, 0].to(dt)) + bias

    t_hat = torch.cat([c_tl, v_top, c_tr], dim=1)      # [B, W+2, M]
    b_hat = torch.cat([c_bl, v_bot, c_br], dim=1)
    zl = torch.zeros_like(v_lef[:, :1])
    l_hat = torch.cat([zl, v_lef, zl], dim=1)
    r_hat = torch.cat([zl, v_rig, zl], dim=1)

    c_top = _conv1d_valid(t_hat, k2[0])       # ring row -1 -> out row 0
    c_bottom = _conv1d_valid(b_hat, k2[2])    # ring row H  -> out row H-1
    c_left = _conv1d_valid(l_hat, k2[:, 0])   # ring col -1 -> out col 0
    c_right = _conv1d_valid(r_hat, k2[:, 2])  # ring col W  -> out col W-1
    return c_top, c_bottom, c_left, c_right


def _apply_ring_s2d(z, corrections):
    """Subtract the ring corrections from ``z`` [B, H/2, W/2, 4O] in s2d
    layout, in place: only the ring rows and columns of z are touched.

    Output pixel (y, x) lives at z[y//2, x//2, (y%2 * 2 + x%2)*O :].  Each
    ring entry subtracts the sum top + bottom + left + right of the strips
    that reach it, summed in that order in z's dtype."""
    c_top, c_bottom, c_left, c_right = corrections
    dt = z.dtype
    _, h2, w2, _ = z.shape

    def eo(c):  # [B, L, O] -> its even and odd positions
        return c[:, 0::2].to(dt), c[:, 1::2].to(dt)

    te, to = eo(c_top)        # output row 0   -> s2d row 0,  a=0
    be, bo = eo(c_bottom)     # output row H-1 -> s2d row -1, a=1
    le, lo = eo(c_left)       # output col 0   -> s2d col 0,  b=0
    re_, ro = eo(c_right)     # output col W-1 -> s2d col -1, b=1
    zw, zh = torch.zeros_like(te), torch.zeros_like(le)
    top = torch.cat([te, to, zw, zw], -1)       # [B, W/2, 4O]
    bot = torch.cat([zw, zw, be, bo], -1)
    left = torch.cat([le, zh, lo, zh], -1)      # [B, H/2, 4O]
    right = torch.cat([zh, re_, zh, ro], -1)

    jj = torch.arange(w2, device=z.device)[None, :, None]
    for r in sorted({0, h2 - 1}):
        corr = torch.zeros_like(top)
        if r == 0:
            corr = corr + top
        if r == h2 - 1:
            corr = corr + bot
        corr = corr + torch.where(jj == 0, left[:, r:r + 1], 0)
        corr = corr + torch.where(jj == w2 - 1, right[:, r:r + 1], 0)
        z[:, r] -= corr
    if h2 > 2:
        for c in sorted({0, w2 - 1}):
            corr = torch.zeros_like(left[:, 1:-1])
            if c == 0:
                corr = corr + left[:, 1:-1]
            if c == w2 - 1:
                corr = corr + right[:, 1:-1]
            z[:, 1:-1, c] -= corr
    return z


def block_diag_1x1(kernel):
    """[1, 1, C, O] -> [1, 1, 4C, 4O] block-diagonal kernel: a 1x1 conv
    mixes channels per pixel, so it commutes with space-to-depth."""
    _, _, c, o = kernel.shape
    zero = kernel.new_zeros((c, o))
    cols = []
    for i in range(4):
        cols.append(torch.cat([kernel[0, 0] if j == i else zero for j in range(4)], 0))
    return torch.cat(cols, dim=1)[None, None]


def compose_tail_weights(k1, b1, k2, b2, k3, b3):
    """The composed tail's weights, which depend on the convs' weights only:
    the s2d block kernel of the composed 5x5 conv [3, 3, 4C, 4*32] and its
    bias, and the block-diagonal 1x1 kernel [1, 1, 4*32, 4O] and its bias."""
    k5, b5 = compose_conv3x3_pair(k1, b1, k2, b2)
    return s2d_block_kernel5(k5), b5.repeat(4), block_diag_1x1(k3), b3.repeat(4)


def composed_tail_full(u, k1, b1, k2, b2, k3, b3, act, u_s2d=None, borders=None,
                       weights=None):
    """The DPT output tail conv1 -> conv2a -> act -> 1x1 conv2b, all in s2d
    layout: the only full-resolution tensor made is the final image.

    u [B, H, W, C] (H, W even), or ``u=None`` with ``u_s2d`` = s2d(u)
    [B, H/2, W/2, 4C] and ``borders`` = (u[:, 0], u[:, -1], u[:, :, 0],
    u[:, :, -1]) given by the caller; ``weights`` is
    :func:`compose_tail_weights` of the same convs, made here if not given.
    Returns [B, H, W, out_dim]."""
    if weights is None:
        weights = compose_tail_weights(k1, b1, k2, b2, k3, b3)
    k5_s2d, b5_s2d, k3_s2d, b3_s2d = weights
    if u_s2d is None:
        u_s2d = space_to_depth(u)
    if borders is None:
        borders = (u[:, 0], u[:, -1], u[:, :, 0], u[:, :, -1])
    z = conv2d_hwio(u_s2d, k5_s2d, b5_s2d, padding=1)
    z = _apply_ring_s2d(z, ring_correction(borders, k1, b1, k2))
    z = conv2d_hwio(act(z), k3_s2d, b3_s2d)
    return depth_to_space(z)
