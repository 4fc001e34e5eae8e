"""DPT multi-scale conv decoder head, NHWC, with the plain output tail.

Fuses the outputs of 4 decoder layers into a full-resolution image:
per-layer 1x1 projection -> resize (convT x4 / convT x2 / identity /
strided conv /2) -> 3x3 "scratch" convs -> refinenet fusion with
align_corners bilinear upsampling (kernel K4) -> output convs.

The refinenets run ``out_conv`` before their upsample: a 1x1 conv mixes
channels per pixel and the bilinear resize mixes pixels per channel, so
the two commute (up to fp rounding), as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn as nn

from renderformer_tpu_torch.nn.conv import (
    conv2d, conv_transpose2d_block, resize_bilinear_align_corners)
from renderformer_tpu_torch.nn.core import silu


def _conv(cin, cout, k, bias=True, stride=1, padding=0):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=bias)


def _apply(conv: nn.Conv2d, x):
    return conv2d(x, conv.weight, conv.bias, stride=conv.stride[0],
                  padding=conv.padding[0])


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

    def forward(self, x, res=None, size=None):
        if res is not None:
            x = x + self.resConvUnit1(res)
        x = self.resConvUnit2(x)
        if size is None:
            size = (x.shape[1] * 2, x.shape[2] * 2)
        x = _apply(self.out_conv, x)
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

    def forward(self, out_features: Sequence, patch_h: int, patch_w: int,
                patch_size: int = 16):
        """out_features: 4 token tensors [B, N, D] (N = patch_h*patch_w).
        Returns the image [B, H, W, out_dim] (NHWC)."""
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
        p1 = s.refinenet1(p2, l1)

        out = _apply(s.output_conv1, p1)
        out = resize_bilinear_align_corners(
            out, (patch_h * patch_size, patch_w * patch_size))
        oc2 = s.output_conv2
        out = silu(_apply(oc2[0], out))
        return _apply(oc2[2], out)
