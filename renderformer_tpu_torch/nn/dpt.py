"""DPT multi-scale conv decoder head, NHWC.

Fuses the outputs of 4 decoder layers into a full-resolution image:
per-layer 1x1 projection -> resize (convT x4 / convT x2 / identity /
strided conv /2) -> 3x3 "scratch" convs -> refinenet fusion with
align_corners bilinear upsampling (kernel K4) -> output convs.

The refinenets run ``out_conv`` before their upsample: a 1x1 conv mixes
channels per pixel and the bilinear resize mixes pixels per channel, so
the two commute (up to fp rounding), as in the JAX package.

The output tail has three evaluations (``DPTHead.tail``, which the
pipeline sets from ``RuntimeConfig.dpt_tail``), equal up to summation
order:

* ``'composed'`` (default): refinenet1's upsample goes straight into
  space-to-depth layout (kernel K5), and output_conv1 and
  output_conv2[0] run as one composed 5x5 conv in that layout with an
  exact 1-px ring fix (``ops/dpt_tail.py``); the full-resolution
  feature map is never made;
* ``'s2d'``: each output conv in space-to-depth form (``ops/s2d_conv.py``);
* ``'plain'``: the convs as written.

The fast tails need the mid-tail resize to be the identity (refinenet1's
x2 upsample lands at full resolution, as at patch size 8) and an even
image; elsewhere the head takes the plain tail, as the JAX package does.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from renderformer_tpu_torch.config import DPT_TAILS
from renderformer_tpu_torch.nn.conv import (
    conv2d, conv_transpose2d_block, resize_axis, resize_bilinear_align_corners)
from renderformer_tpu_torch.nn.core import silu
from renderformer_tpu_torch.ops.dpt_tail import (
    block_diag_1x1, compose_tail_weights, composed_tail_full)
from renderformer_tpu_torch.ops.fused_resize import resize_s2d
from renderformer_tpu_torch.ops.s2d_conv import (
    conv2d_hwio, depth_to_space, s2d_block_kernel, space_to_depth)


def _conv(cin, cout, k, bias=True, stride=1, padding=0):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=bias)


def _apply(conv: nn.Conv2d, x):
    return conv2d(x, conv.weight, conv.bias, stride=conv.stride[0],
                  padding=conv.padding[0])


def _hwio(conv: nn.Conv2d):
    """The conv's OIHW weight as an HWIO view."""
    return conv.weight.permute(2, 3, 1, 0)


class ResidualConvUnit(nn.Module):
    """act -> conv -> act -> conv -> +x, SiLU."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = _conv(features, features, 3, padding=1)
        self.conv2 = _conv(features, features, 3, padding=1)

    def forward(self, x):
        out = _apply(self.conv1, silu(x))
        out = _apply(self.conv2, silu(out))
        return out + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int, has_resconv1: bool = True):
        super().__init__()
        self.out_conv = _conv(features, features, 1)
        if has_resconv1:
            self.resConvUnit1 = ResidualConvUnit(features)
        self.resConvUnit2 = ResidualConvUnit(features)

    def forward(self, x, res=None, size=None, skip_resize: bool = False):
        """``skip_resize`` returns the tensor before the upsample, which the
        composed tail writes straight into space-to-depth layout."""
        if res is not None:
            x = x + self.resConvUnit1(res)
        x = self.resConvUnit2(x)
        if size is None:
            size = (x.shape[1] * 2, x.shape[2] * 2)
        x = _apply(self.out_conv, x)
        if skip_resize:
            return x
        return resize_bilinear_align_corners(x, size)


class DPTHead(nn.Module):
    def __init__(self, in_channels: int, features: int = 256,
                 out_channels=(256, 512, 1024, 1024), out_dim: int = 3):
        super().__init__()
        oc = list(out_channels)
        self.projects = nn.ModuleList(
            [_conv(in_channels, oc[i], 1) for i in range(4)])
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            _conv(oc[3], oc[3], 3, stride=2, padding=1),
        ])
        scratch = nn.Module()
        for i in range(4):
            setattr(scratch, f'layer{i + 1}_rn',
                    _conv(oc[i], features, 3, bias=False, padding=1))
        scratch.refinenet1 = FeatureFusionBlock(features)
        scratch.refinenet2 = FeatureFusionBlock(features)
        scratch.refinenet3 = FeatureFusionBlock(features)
        scratch.refinenet4 = FeatureFusionBlock(features, has_resconv1=False)
        scratch.output_conv1 = _conv(features, features // 2, 3, padding=1)
        scratch.output_conv2 = nn.Sequential(
            _conv(features // 2, 32, 3, padding=1), nn.SiLU(),
            _conv(32, out_dim, 1))
        self.scratch = scratch
        # the output tail, one of DPT_TAILS; the pipeline sets it from
        # RuntimeConfig.dpt_tail
        self.tail = 'composed'
        self._tail_weights = None   # (key, compose_tail_weights(...))

    def _composed_weights(self):
        """The composed tail's weights, made once for each version of the
        output convs' weights (and inference mode, whose tensors cannot
        leave it).  Made anew when autograd records the weights, so a
        gradient reaches them."""
        oc1, oc2 = self.scratch.output_conv1, self.scratch.output_conv2
        convs = (oc1, oc2[0], oc2[2])
        params = [p for c in convs for p in (c.weight, c.bias)]
        args = [t for c in convs for t in (_hwio(c), c.bias)]
        if torch.is_grad_enabled() and any(p.requires_grad for p in params):
            return compose_tail_weights(*args)
        key = (torch.is_inference_mode_enabled(),) + tuple(
            (p.data_ptr(), p._version, p.dtype, p.device) for p in params)
        if self._tail_weights is None or self._tail_weights[0] != key:
            self._tail_weights = (key, compose_tail_weights(*args))
        return self._tail_weights[1]

    def forward(self, out_features: Sequence, patch_h: int, patch_w: int,
                patch_size: int = 16):
        """out_features: 4 token tensors [B, N, D] (N = patch_h*patch_w).
        The output tail is ``self.tail``.  Returns the image
        [B, H, W, out_dim] (NHWC)."""
        tail = self.tail
        if tail not in DPT_TAILS:
            raise ValueError(f'dpt tail {tail!r} is not one of {DPT_TAILS}')
        feats = []
        for i, x in enumerate(out_features):
            b, _, d = x.shape
            x = _apply(self.projects[i], x.reshape(b, patch_h, patch_w, d))
            r = self.resize_layers[i]
            if i in (0, 1):
                x = conv_transpose2d_block(x, r.weight, r.bias)
            elif i == 3:
                x = _apply(r, x)
            feats.append(x)

        s = self.scratch
        l1 = _apply(s.layer1_rn, feats[0])
        l2 = _apply(s.layer2_rn, feats[1])
        l3 = _apply(s.layer3_rn, feats[2])
        l4 = _apply(s.layer4_rn, feats[3])

        p4 = s.refinenet4(l4, size=l3.shape[1:3])
        p3 = s.refinenet3(p4, l3, size=l2.shape[1:3])
        p2 = s.refinenet2(p3, l2, size=l1.shape[1:3])

        out_hw = (patch_h * patch_size, patch_w * patch_size)
        oc1, oc2 = s.output_conv1, s.output_conv2
        fast_ok = ((l1.shape[1] * 2, l1.shape[2] * 2) == out_hw
                   and out_hw[0] % 2 == 0 and out_hw[1] % 2 == 0)
        if tail == 'composed' and fast_ok:
            t = s.refinenet1(p2, l1, skip_resize=True)
            u_s2d = resize_s2d(t.contiguous(), out_hw)
            # border rows and columns of the full-resolution u from 1-D
            # edge resizes: align_corners maps edges onto edges
            borders = (resize_axis(t[:, 0], 1, out_hw[1]),
                       resize_axis(t[:, -1], 1, out_hw[1]),
                       resize_axis(t[:, :, 0], 1, out_hw[0]),
                       resize_axis(t[:, :, -1], 1, out_hw[0]))
            return composed_tail_full(
                None, _hwio(oc1), oc1.bias, _hwio(oc2[0]), oc2[0].bias,
                _hwio(oc2[2]), oc2[2].bias, silu, u_s2d=u_s2d, borders=borders,
                weights=self._composed_weights())

        p1 = s.refinenet1(p2, l1)
        if tail == 's2d' and fast_ok and tuple(p1.shape[1:3]) == out_hw:
            return self._output_tail_s2d(p1)
        out = _apply(oc1, p1)
        out = resize_bilinear_align_corners(out, out_hw)
        out = silu(_apply(oc2[0], out))
        return _apply(oc2[2], out)

    def _output_tail_s2d(self, x):
        """output_conv1 -> output_conv2 with each conv in space-to-depth
        form, one layout pass each way."""
        oc1, oc2 = self.scratch.output_conv1, self.scratch.output_conv2
        x = space_to_depth(x)
        x = conv2d_hwio(x, s2d_block_kernel(_hwio(oc1)), oc1.bias.repeat(4), padding=1)
        x = conv2d_hwio(x, s2d_block_kernel(_hwio(oc2[0])), oc2[0].bias.repeat(4),
                        padding=1)
        x = conv2d_hwio(silu(x), block_diag_1x1(_hwio(oc2[2])), oc2[2].bias.repeat(4))
        return depth_to_space(x)
