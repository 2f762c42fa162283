"""Camera matrices (port of the numpy helpers of relightable3dgaussian_tpu/utils/graphics.py).

`world_to_view`, `projection_matrix`, `projection_matrix_center_shift`,
`fov2focal` and `focal2fov`, copied as numpy because the JAX module imports
jax. Matrices are returned NOT transposed; `ops/camera.py` stores the
transposes ("row vector" convention, points transform as `p_row @ M`).
"""
from __future__ import annotations

import math

import numpy as np


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
