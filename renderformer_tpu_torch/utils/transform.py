"""Rigid camera-space transform: for c2w = [R | t] the world->camera map
is ``x_cam = R^T (x - t)`` and normals map as ``n_cam = R^T n``.  fp32,
no gradient."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


@torch.no_grad()
def trans_to_cam_coord(
    c2w: torch.Tensor,
    triangles: torch.Tensor,
    vns: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """c2w [B, 4, 4], triangles [B, N, 3, 3], vns optional [B, N, 3, 3].

    Returns (triangles_cam [B, N, 3, 3], identity c2w [B, 4, 4], vns_cam or
    None)."""
    c2w = c2w.float()
    triangles = triangles.float()
    R = c2w[..., :3, :3]
    t = c2w[..., :3, 3]
    tris_cam = torch.einsum('bnvj,bji->bnvi', triangles - t[:, None, None, :], R)
    eye = torch.eye(4, dtype=torch.float32, device=c2w.device).expand(c2w.shape)
    vns_cam = None
    if vns is not None:
        vns_cam = torch.einsum('bnvj,bji->bnvi', vns.float(), R)
    return tris_cam, eye, vns_cam
