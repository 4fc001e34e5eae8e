"""Space-to-depth evaluation of 3x3 stride-1 convolutions (plain PyTorch).

Space-to-depth by 2 re-expresses a 3x3 conv on [H, W, C] as a 3x3 conv on
[H/2, W/2, 4C] with a block kernel [3, 3, 4C, 4O]: each output element of
the block conv contracts a 6x6 input neighbourhood, three quarters of whose
taps are structural zeros.  The transform is exact up to summation order.

Packing: s2d(x)[i, j, (a*2 + b)*C + c] = x[2i + a, 2j + b, c].  For output
offset (a, b) and tap (dy, dx): t = a + dy, s = b + dx in {-1..2}; in-block
(t mod 2, s mod 2), block offset ((t - t mod 2)/2, (s - s mod 2)/2).  The
block conv pads one block (2 px), and every tap that would read the extra
pixel ring is a structural zero, so the padding matches.

Activations are NHWC and kernels HWIO ``[kh, kw, Cin, Cout]``, the JAX
package's layouts.
"""

from __future__ import annotations

import torch.nn.functional as F


def conv2d_hwio(x, kernel, bias=None, padding: int = 0):
    """x [B, H, W, Cin] -> [B, H', W', Cout] with an HWIO kernel, computed
    in x's dtype on the ``channels_last`` view, as ``nn.conv.conv2d`` does
    with an OIHW kernel (that module imports ``ops``, so this one does not
    import it)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1).to(x.dtype),
                 None if bias is None else bias.to(x.dtype), padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()


def s2d_block_kernel(kernel):
    """[3, 3, C, O] -> [3, 3, 4C, 4O] block kernel (see module docstring)."""
    kh, kw, c, o = kernel.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f'expected a 3x3 kernel, got {kh}x{kw}')
    kk = kernel.new_zeros((3, 3, 4 * c, 4 * o))
    for a in range(2):
        for b in range(2):
            for dy in range(-1, 2):
                for dx in range(-1, 2):
                    t, s = a + dy, b + dx
                    ci, cj = t % 2, s % 2
                    u, v = (t - ci) // 2, (s - cj) // 2
                    kk[u + 1, v + 1,
                       (ci * 2 + cj) * c:(ci * 2 + cj + 1) * c,
                       (a * 2 + b) * o:(a * 2 + b + 1) * o] = kernel[dy + 1, dx + 1]
    return kk


def space_to_depth(x):
    """[B, H, W, C] -> [B, H/2, W/2, 4C] (H, W even)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def depth_to_space(x):
    """[B, H, W, 4C] -> [B, 2H, 2W, C]."""
    b, h, w, c4 = x.shape
    c = c4 // 4
    x = x.reshape(b, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2 * h, 2 * w, c)


def conv2d_s2d(x, kernel, bias=None, padding: int = 1):
    """3x3 stride-1 pad-1 conv in space-to-depth form: x [B, H, W, Cin]
    (H, W even), kernel [3, 3, Cin, Cout].  Equals
    ``conv2d_hwio(x, kernel, bias, padding=1)`` up to summation order."""
    if padding != 1:
        raise ValueError('conv2d_s2d evaluates padding=1 only')
    y = depth_to_space(conv2d_hwio(space_to_depth(x), s2d_block_kernel(kernel),
                                   padding=1))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
