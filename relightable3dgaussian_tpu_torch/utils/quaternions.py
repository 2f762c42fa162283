"""Quaternion / covariance helpers (port of relightable3dgaussian_tpu/utils/quaternions.py).

Quaternions are (w, x, y, z).
"""
from __future__ import annotations

import torch


def normalize_quaternion(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=eps)


def quaternion_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] unit quaternion → [..., 3, 3] rotation matrix."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1)
    row1 = torch.stack(
        [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1)
    row2 = torch.stack(
        [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def build_covariance(scaling: torch.Tensor, rotation_q: torch.Tensor,
                     scaling_modifier: float = 1.0) -> torch.Tensor:
    """3D covariance Σ = R S Sᵀ Rᵀ as the full [..., 3, 3] matrix."""
    R = quaternion_to_rotmat(normalize_quaternion(rotation_q))
    L = R * (scaling_modifier * scaling)[..., None, :]   # R @ diag(S)
    return L @ L.transpose(-1, -2)


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] symmetric → packed [..., 6] (xx, xy, xz, yy, yz, zz)."""
    return torch.stack(
        [cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
         cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]], dim=-1)


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1 - x))
