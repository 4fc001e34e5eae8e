"""Pinhole ray generation (Blender camera convention, -Z forward): pixel
centers at 0.5..res-0.5, ``f = res/2 / tan(fov/2)``, directions
``[(x-cx)/f, -(y-cy)/f, -1]`` rotated by the c2w rotation and L2
normalised.  fp32."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def generate_rays(c2w: torch.Tensor, fov: torch.Tensor, img_res: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """c2w [*B, 4, 4], fov [*B, 1] in radians -> (rays_o [*B, 3],
    rays_d [*B, H, W, 3] unit directions)."""
    c2w = c2w.float()
    fov = fov.float()
    batch = c2w.shape[:-2]
    lin = np.linspace(0.5, img_res - 0.5, img_res, dtype=np.float32)
    xs, ys = np.meshgrid(lin, lin, indexing='xy')
    bcast = (1,) * len(batch)
    x = torch.from_numpy(xs).to(c2w.device).reshape(bcast + xs.shape)
    y = torch.from_numpy(ys).to(c2w.device).reshape(bcast + ys.shape)
    c = img_res / 2.0
    f = img_res / 2.0 / torch.tan(0.5 * fov[..., 0, None, None])
    dirs = torch.stack([(x - c) / f, -(y - c) / f,
                        -torch.ones_like(x * f)], dim=-1)
    R = c2w[..., :3, :3]
    rays_d = torch.einsum('...ij,...hwj->...hwi', R, dirs)
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    return c2w[..., :3, 3], rays_d


def generate_rays_patched(c2w: torch.Tensor, fov: torch.Tensor, img_res: int,
                          patch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same rays in the view transformer's patch layout:
    rays_d [*B, (res/p)^2, 3*p*p], column ``c*p*p + p1*p + p2`` holding
    direction component c of patch pixel (p1, p2)."""
    c2w = c2w.float()
    fov = fov.float()
    p = patch_size
    hp = img_res // p
    tok = np.arange(hp * hp)
    lane = np.arange(p * p)
    pix_y = ((tok // hp)[:, None] * p + lane[None, :] // p + 0.5).astype(np.float32)
    pix_x = ((tok % hp)[:, None] * p + lane[None, :] % p + 0.5).astype(np.float32)
    pix_x = torch.from_numpy(pix_x).to(c2w.device)
    pix_y = torch.from_numpy(pix_y).to(c2w.device)
    c = img_res / 2.0
    f = img_res / 2.0 / torch.tan(0.5 * fov[..., 0, None, None])
    xd = (pix_x - c) / f
    yd = -(pix_y - c) / f
    R = c2w[..., :3, :3]

    def world(i):
        return (R[..., i, 0, None, None] * xd + R[..., i, 1, None, None] * yd
                - R[..., i, 2, None, None])

    wx, wy, wz = world(0), world(1), world(2)
    nrm = torch.sqrt(wx * wx + wy * wy + wz * wz)
    return c2w[..., :3, 3], torch.cat([wx / nrm, wy / nrm, wz / nrm], dim=-1)
