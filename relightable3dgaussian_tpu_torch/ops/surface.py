"""Depth → surface xyz and pseudo-normals (port of relightable3dgaussian_tpu/ops/surface.py).

Unproject the opacity-normalized depth map to camera-space points, take
Sobel/8 gradients with edge replication, and rotate the cross-product normal
into world space.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .camera import CameraParams


def surface_xyz_from_depth(depth: torch.Tensor, cam: CameraParams) -> torch.Tensor:
    """[H, W] depth → [H, W, 3] camera-space surface points."""
    h, w = depth.shape
    u = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :]
    v = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
    x = (u - cam.center[0]) / cam.focal[0] * depth
    y = (v - cam.center[1]) / cam.focal[1] * depth
    return torch.stack([x, y, depth], dim=-1)


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """[H, W, C] shifted by (dy, dx) with edge replication."""
    h, w = img.shape[:2]
    padded = F.pad(img.permute(2, 0, 1)[None], (1, 1, 1, 1),
                   mode="replicate")[0].permute(1, 2, 0)
    return padded[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def pseudo_normal_from_surface(surface: torch.Tensor,
                               cam: CameraParams) -> torch.Tensor:
    """[H, W, 3] camera-space surface → [H, W, 3] world-space pseudo-normals;
    zero-norm pixels get a zero normal."""
    s00 = _shift(surface, -1, -1)
    s01 = _shift(surface, -1, 0)
    s02 = _shift(surface, -1, 1)
    s10 = _shift(surface, 0, -1)
    s12 = _shift(surface, 0, 1)
    s20 = _shift(surface, 1, -1)
    s21 = _shift(surface, 1, 0)
    s22 = _shift(surface, 1, 1)
    grad_a = (-0.125 * s00 + 0.125 * s02 - 0.25 * s10 + 0.25 * s12
              - 0.125 * s20 + 0.125 * s22)
    grad_b = (-0.125 * s00 - 0.25 * s01 - 0.125 * s02
              + 0.125 * s20 + 0.25 * s21 + 0.125 * s22)
    n = torch.linalg.cross(grad_a, grad_b, dim=-1)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    n_cam = torch.where(norm > 0.0, -n / torch.clamp(norm, min=1e-20), 0.0)
    # Rotate camera→world: world_view[:3,:3] is R_w2c^T = R_c2w.
    return torch.einsum("ij,hwj->hwi", cam.world_view[:3, :3], n_cam)


def pseudo_normal_from_depth(depth: torch.Tensor, cam: CameraParams):
    """[H, W] depth → (surface_xyz [3, H, W], pseudo_normal [3, H, W])."""
    surface = surface_xyz_from_depth(depth, cam)
    normal = pseudo_normal_from_surface(surface, cam)
    return surface.permute(2, 0, 1), normal.permute(2, 0, 1)
