"""Convolutions and the align_corners bilinear resize, NHWC at the
function boundary (the JAX package's layout) with torch-layout weights.

``conv2d`` runs ``F.conv2d`` on the ``channels_last`` view of the NHWC
tensor, so no layout copy is made on either side.
``conv_transpose2d_block`` uses that both DPT transposed convs have
stride == kernel_size and no padding: each input pixel emits its own
output block, so the op is one matrix product.  ``resize_axis`` resizes
one axis, e.g. the four border rows and columns that the composed DPT
tail needs without the full-resolution image.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from renderformer_tpu_torch.ops.fused_resize import resize_axis, resize_bilinear

__all__ = ['conv2d', 'conv_transpose2d_block', 'resize_axis',
           'resize_bilinear_align_corners']


def conv2d(x, weight, bias=None, stride: int = 1, padding: int = 0):
    """x [B, H, W, Cin] -> [B, H', W', Cout]; weight OIHW [Cout, Cin, kh, kw]."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                 None if bias is None else bias.to(x.dtype),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()


def conv_transpose2d_block(x, weight, bias=None):
    """Transposed conv with kernel_size == stride and no padding.

    x [B, H, W, Cin]; weight [Cin, Cout, s, s] (torch ConvTranspose2d):
    out[b, i*s+di, j*s+dj, o] = sum_c x[b, i, j, c] * weight[c, o, di, dj].
    """
    b, h, w, _ = x.shape
    _, cout, kh, kw = weight.shape
    y = torch.einsum('bhwc,coij->bhiwjo', x, weight.to(x.dtype))
    y = y.reshape(b, h * kh, w * kw, cout)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def resize_bilinear_align_corners(x, out_hw: Tuple[int, int]):
    """x [B, H, W, C] -> [B, out_h, out_w, C]; the identity at equal size."""
    if (x.shape[1], x.shape[2]) == tuple(out_hw):
        return x
    return resize_bilinear(x.contiguous(), out_hw)
