"""Frozen copy of the port's `utils/quaternions.py`, for the benchmark's plain reference.

It imports nothing of the port; a change to the port does not reach it.

Quaternion / covariance helpers (port of relightable3dgaussian_tpu/utils/quaternions.py).

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


def rotmat_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation → [..., 4] unit quaternion: the construction of
    the largest pivot (the trace, then m00, m11, m22). Every branch is
    computed, so each square root's argument is clamped to 1e-12, which
    keeps the branches not taken finite."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw0 = torch.sqrt(torch.clamp(1.0 + tr, min=1e-12)) / 2
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], -1)
    s1 = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-12)) * 2
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                      (m02 + m20) / s1], -1)
    s2 = torch.sqrt(torch.clamp(1.0 + m11 - m00 - m22, min=1e-12)) * 2
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                      (m12 + m21) / s2], -1)
    s3 = torch.sqrt(torch.clamp(1.0 + m22 - m00 - m11, min=1e-12)) * 2
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                      0.25 * s3], -1)
    cond0 = (tr > 0)[..., None]
    cond1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond2 = (m11 >= m22)[..., None]
    q = torch.where(cond0, q0,
                    torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    return normalize_quaternion(q)


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


def unpack_symmetric(packed: torch.Tensor) -> torch.Tensor:
    """Packed [..., 6] (xx, xy, xz, yy, yz, zz) → full [..., 3, 3]."""
    xx, xy, xz, yy, yz, zz = packed.unbind(-1)
    return torch.stack([torch.stack([xx, xy, xz], -1),
                        torch.stack([xy, yy, yz], -1),
                        torch.stack([xz, yz, zz], -1)], dim=-2)
