"""Frozen copy of the port's `utils/graphics.py`, for the benchmark's plain reference.

It imports nothing of the port; a change to the port does not reach it.

Graphics helpers (port of relightable3dgaussian_tpu/utils/graphics.py).

Camera matrices: `world_to_view`, `projection_matrix`,
`projection_matrix_center_shift`, `fov2focal` and `focal2fov`, copied as
numpy because the JAX module imports jax. Matrices are returned NOT
transposed; `ops/camera.py` stores the transposes ("row vector" convention,
points transform as `p_row @ M`). Stage 2: `fibonacci_sphere_sampling` (the
deterministic form `update_visibility` uses) and the sRGB transfer
functions, in torch.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .sh import rotation_between_z


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate: np.ndarray | None = None,
                  scale: float = 1.0) -> np.ndarray:
    """4x4 world→camera matrix from the camera→world rotation R (COLMAP
    convention) and the world→camera translation t."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else translate
        c2w = np.linalg.inv(Rt)
        c2w[:3, 3] = (c2w[:3, 3] + translate) * scale
        Rt = np.linalg.inv(c2w)
    return Rt.astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """Perspective projection, symmetric frustum."""
    top = math.tan(fovy / 2) * znear
    right = math.tan(fovx / 2) * znear
    return _frustum(znear, zfar, -right, right, -top, top)


def projection_matrix_center_shift(znear: float, zfar: float, cx: float, cy: float,
                                   fx: float, fy: float, w: int, h: int) -> np.ndarray:
    """Perspective projection for a principal point offset from the center."""
    top = cy / fy * znear
    bottom = -(h - cy) / fy * znear
    left = -(w - cx) / fx * znear
    right = cx / fx * znear
    return _frustum(znear, zfar, left, right, bottom, top)


def _frustum(znear, zfar, left, right, bottom, top) -> np.ndarray:
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def fibonacci_sphere_sampling(normals: torch.Tensor, sample_num: int
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fibonacci-spiral directions on the hemisphere around each unit normal
    [N, 3], with z clamped to sin(10°) and no random azimuth. Returns
    (incident_dirs [N, S, 3], incident_areas [N, S, 1], constant 2π)."""
    delta = math.pi * (3.0 - math.sqrt(5.0))
    idx = torch.arange(sample_num, dtype=normals.dtype,
                       device=normals.device)[None]                 # [1, S]
    z = torch.clamp(1 - 2 * idx / (2 * sample_num - 1),
                    min=math.sin(10 / 180 * math.pi))
    rad = torch.sqrt(1 - z ** 2)
    theta = delta * idx
    z_samples = torch.stack([torch.sin(theta) * rad, torch.cos(theta) * rad,
                             z], dim=-2)                             # [1, 3, S]
    dirs = rotation_between_z(normals) @ z_samples                   # [N, 3, S]
    dirs = dirs / torch.linalg.norm(dirs, dim=-2, keepdim=True)
    dirs = dirs.transpose(-1, -2).contiguous()                       # [N, S, 3]
    areas = torch.full(dirs.shape[:-1] + (1,), 2 * math.pi,
                       dtype=dirs.dtype, device=dirs.device)
    return dirs, areas


def rgb_to_srgb(img: torch.Tensor, clip: bool = True) -> torch.Tensor:
    """Linear HDR → sRGB, elementwise."""
    img = torch.where(
        img > 0.0031308,
        torch.pow(torch.clamp(img, min=0.0031308), 1.0 / 2.4) * 1.055 - 0.055,
        12.92 * img)
    return torch.clamp(img, 0.0, 1.0) if clip else img
